"""The port's residual-only and plan-tree encode modes, and batch sharding
over a device list, on the CPU.

* ``encode_frames_plan(pack_budget=18, frame_pack=False)`` and
  ``pack_budget=0`` give the JAX package's plan leaves exactly, f64.
* ``BatchEncoder(frame_pack=False)`` and ``BatchEncoder(pack_budget=0)``
  write the bytes of the port's ``FlacSampleWriter`` and of the JAX
  ``BatchEncoder`` in the same mode.
* ``BatchEncoder(mesh=...)`` and ``BatchDecoder(mesh=...)`` over the CPU
  listed k times give the unsharded bytes and the input samples, and the
  JAX decoder's samples over its 8 virtual CPU devices.
"""

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from flac_codec_tpu.encode import FlacSampleWriter as JaxSampleWriter
from flac_codec_tpu.ops import encode_batch as jeb
from flac_codec_tpu.parallel.batch import BatchEncoder as JaxBatchEncoder
from flac_codec_tpu.parallel.batch_decode import BatchDecoder as JaxDecoder
from flac_codec_tpu.parallel.mesh import batch_mesh as jax_batch_mesh
from flac_codec_tpu_torch.convert import plan_to_numpy
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.ops import encode_batch as teb
from flac_codec_tpu_torch.parallel import mesh as tmesh
from flac_codec_tpu_torch.parallel.batch import BatchEncoder
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder

torch.set_num_threads(2)

BLOCK = 512


def _assert_trees_equal(got: dict, want: dict):
    """Every leaf equal, dtype included; the same keys at every level."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "channels":
            assert len(got[k]) == len(w)
            for s, (gc, wc) in enumerate(zip(got[k], w)):
                assert sorted(gc) == sorted(wc), s
                for ck in wc:
                    assert gc[ck].dtype == wc[ck].dtype, (s, ck)
                    np.testing.assert_array_equal(gc[ck], wc[ck],
                                                  f"slot {s} {ck}")
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, k)


@pytest.mark.parametrize("budget", [18, 0])
@pytest.mark.parametrize("channels", [2, 3])
def test_plan_leaves_match_jax(channels, budget):
    """Residual-only (``packed_words``, ``packed_meta``, ``res_bits``,
    ``res_overflow`` and the tree without residuals) and the full tree."""
    rng = np.random.default_rng(40)
    t = np.arange(BLOCK)
    f = 0.01 * (1 + np.arange(channels))[None, :, None]
    pcm = (3000 * np.sin(t * f)
           + rng.integers(-60, 60, (3, channels, BLOCK))).astype(np.int32)
    pcm[1] = pcm[1, :1]                            # identical channels
    pcm[2, 0] = 0                                  # a silent channel
    pcm[0, -1] &= ~3                               # wasted bits
    kw = dict(bits_per_sample=16, block_size=BLOCK, max_lpc_order=8,
              max_partition_order=4, analysis="f64", pack_budget=budget,
              frame_pack=False)
    want = jax.tree_util.tree_map(
        np.asarray, jeb.encode_frames_plan(jnp.asarray(pcm), **kw))
    got = plan_to_numpy(teb.encode_frames_plan(torch.as_tensor(pcm), **kw))
    _assert_trees_equal(got, want)
    if budget:
        assert got["packed_words"].shape == (3 * channels * 640 + 2,)
        assert list(got["packed_meta"]) == [channels, 640]


def _signal(name: str, n: int, bps: int, rng) -> np.ndarray:
    """The JAX package's signal classes (tests/test_device_ops.py), scaled
    to ``bps``, and full-scale noise."""
    full = 1 << (bps - 1)
    t = np.arange(n)
    return {
        "silence": lambda: np.zeros(n),
        "dc": lambda: np.full(n, -123),
        "wasted4": lambda: rng.integers(-800, 800, n) << 4,
        "impulses": lambda: np.where(t % 97 == 0, full * 5 // 8, 0),
        "square": lambda: np.where((t // 64) % 2 == 0, full - 1, -full),
        "tiny": lambda: rng.integers(-2, 2, n),
        "noise": lambda: rng.integers(-full, full, n),
        "music": lambda: ((full >> 3) * np.sin(t * 0.02)
                          + rng.integers(-50, 50, n)),
    }[name]().astype(np.int32)


SIGNALS = ("silence", "dc", "wasted4", "impulses", "square", "tiny",
           "noise", "music")
# name: (bits per sample, channels)
FORMATS = {"stereo16": (16, 2), "stereo24": (24, 2), "mono16": (16, 1),
           "three24": (24, 3)}
MODES = {"residual_only": dict(frame_pack=False),
         "plan_tree": dict(pack_budget=0)}


def _interleave(sig: np.ndarray, channels: int) -> np.ndarray:
    return np.stack([np.roll(sig, 13 * c) for c in range(channels)],
                    axis=1).reshape(-1)


def _encode(cls, inter, bps, channels, n, **kw):
    buf = io.BytesIO()
    enc = cls(buf, Options(block_size=BLOCK), 44100, bps, channels,
              total_samples=n, **kw)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue(), enc


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_encoder_modes_match_host_and_jax(mode, fmt):
    """Every signal class, a partial tail frame: the port's bytes equal
    its host encoder's and the JAX encoder's in the same mode.  Full-scale
    noise takes verbatim subframes, which the residual-only assembler
    hands back to the host encoder and the plan-tree assembler writes."""
    bps, channels = FORMATS[fmt]
    n = BLOCK * 4 + 77
    for name in SIGNALS:
        inter = _interleave(_signal(name, n, bps,
                                    np.random.default_rng(41)), channels)
        host, _ = _encode(FlacSampleWriter, inter, bps, channels, n)
        port, enc = _encode(BatchEncoder, inter, bps, channels, n,
                            batch_frames=4, analysis="f64", device="cpu",
                            **MODES[mode])
        jaxb, _ = _encode(JaxBatchEncoder, inter, bps, channels, n,
                          batch_frames=4, analysis="f64", **MODES[mode])
        assert port == host, name
        assert jaxb == host, name
        assert enc.device_frames == 4, name
        if name == "noise" and mode == "residual_only":
            assert enc.fallback_frames > 0
        if mode == "plan_tree":
            assert enc.fallback_frames == 0, name


def test_encoder_modes_select_like_jax():
    """``pack_budget``/``frame_pack`` defaults and combinations."""
    def mode(**kw):
        e = BatchEncoder(io.BytesIO(), Options(), 44100, 16, 2,
                         device="cpu", **kw)
        return e.pack_budget, e.frame_pack

    assert mode() == (18, True)
    assert mode(frame_pack=False) == (18, False)
    assert mode(pack_budget=0) == (0, False)
    assert mode(pack_budget=0, frame_pack=True) == (0, False)
    assert mode(pack_budget=20) == (20, True)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("mode", ["frame_packed", "residual_only",
                                  "plan_tree"])
def test_sharded_encoder_bytes_equal_unsharded(mode, shards):
    """7-frame batches, which neither 2 nor 3 divides, and a 3-frame last
    batch: the same bytes with and without the mesh."""
    kw = {"frame_packed": {}, **MODES}[mode]
    n = BLOCK * 10 + 300
    rng = np.random.default_rng(42)
    inter = _interleave(_signal("music", n, 16, rng), 2)
    inter[5 * BLOCK * 2:6 * BLOCK * 2] = rng.integers(-(1 << 15), 1 << 15,
                                                      BLOCK * 2)
    host, _ = _encode(FlacSampleWriter, inter, 16, 2, n)
    plain, _ = _encode(BatchEncoder, inter, 16, 2, n, batch_frames=7,
                       analysis="f64", device="cpu", **kw)
    mesh = tmesh.batch_mesh(["cpu"] * shards)
    sharded, enc = _encode(BatchEncoder, inter, 16, 2, n, batch_frames=7,
                           analysis="f64", mesh=mesh, **kw)
    assert plain == host
    assert sharded == host
    assert enc.device_frames == 10
    assert enc.mesh == mesh and enc.device == torch.device("cpu")


def _stream(n: int):
    """A stereo 16-bit stream of ``n`` samples by the JAX package's host
    encoder, and its samples."""
    from flac_codec_tpu.encode import Options as JaxOptions

    inter = _interleave(_signal("music", n, 16, np.random.default_rng(43)),
                        2)
    buf = io.BytesIO()
    w = JaxSampleWriter(buf, JaxOptions(block_size=BLOCK), 44100, 16, 2,
                        total_samples=n)
    w.write(inter)
    w.finalize()
    return buf.getvalue(), inter


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_decoder_matches_input_and_jax(shards):
    n = BLOCK * 17 + 100
    data, inter = _stream(n)
    with BatchDecoder(io.BytesIO(data), batch_frames=8, device="cpu",
                      mesh=tmesh.batch_mesh(["cpu"] * shards)) as dec:
        got = dec.read_all_device()
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().reshape(-1), inter)
    assert dec.device_frames == 17 and dec.host_frames == 1
    with JaxDecoder(io.BytesIO(data), batch_frames=8,
                    mesh=jax_batch_mesh(jax.devices("cpu"))) as jdec:
        want = np.concatenate([np.asarray(b) for b in iter(
            jdec.read_batch_interleaved, None)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_refuses_device_parse_and_missing_cuda(monkeypatch):
    """Under a mesh the device parse is off, as the JAX package turns it
    off; a mesh naming CUDA without CUDA raises."""
    data, _ = _stream(BLOCK * 2)
    with BatchDecoder(io.BytesIO(data), device_parse=True,
                      mesh=tmesh.batch_mesh(["cpu", "cpu"])) as dec:
        assert not dec._device_parse
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, ["cuda:0"], ["cpu", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.batch_mesh(devices)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchEncoder(io.BytesIO(), Options(), 44100, 16, 2,
                     mesh=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchDecoder(io.BytesIO(data), mesh=["cuda:0"])
    with pytest.raises(ValueError, match="unsupported"):
        tmesh.batch_mesh(["meta"])


def test_shard_batch_cuts_like_tensor_split():
    mesh = tmesh.batch_mesh(["cpu"] * 3)
    x = torch.arange(7 * 2).reshape(7, 2)
    parts = tmesh.shard_batch(mesh, x)
    assert [p.shape[0] for p in parts] == [3, 2, 2]
    assert torch.equal(torch.cat(parts), x)
    assert [p.shape[0] for p in tmesh.shard_batch(mesh, x[:2])] == [1, 1, 0]
    assert tmesh.pad_to_multiple(7, 3) == 9
