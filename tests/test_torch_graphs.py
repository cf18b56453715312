"""The port's jit boundary on the encode path, on the CPU.

On CUDA ``BatchEncoder`` replays one captured graph per configuration
(``ops.encode_batch.PlanGraph``); the card tests are in
``tests/test_torch_cuda.py``.  What the CPU can hold:

* the planner's constants are built once per (value, device) and reused,
  so the capture meets no host-to-device copy;
* ``encode_frames_plan``'s leaves still equal the JAX package's, on a
  batch padded with silent frames as the JAX ``BatchEncoder`` pads it;
* padding rows change no real row, and the padded short batch writes the
  host encoder's bytes, sharded or not;
* a captured tally of launches is counted once per replay, and graphs
  are keyed by configuration and stream.
"""

import io
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flac_codec_tpu.ops import encode_batch as jeb
from flac_codec_tpu_torch import kernels
from flac_codec_tpu_torch.convert import plan_to_numpy
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.models.lpc import window as host_window
from flac_codec_tpu_torch.ops import decorrelate, fixed, lpc
from flac_codec_tpu_torch.ops import encode_batch as teb
from flac_codec_tpu_torch.ops.common import device_constant
from flac_codec_tpu_torch.parallel import mesh as tmesh
from flac_codec_tpu_torch.parallel.batch import BatchEncoder

torch.set_num_threads(2)

CPU = torch.device("cpu")
META = torch.device("meta")

# encode_frames_plan's pack arguments for each BatchEncoder mode
MODES = {"frame_packed": dict(pack_budget=18, frame_pack=True),
         "residual_only": dict(pack_budget=18, frame_pack=False),
         "plan_tree": dict(pack_budget=0, frame_pack=False)}


def _music(rng, n, channels, bps):
    """tests/test_torch_batch.py's seeded music-like PCM, interleaved."""
    t = np.arange(n)
    amp = 1 << (bps - 3)
    return np.stack([amp * np.sin(t * (0.01 + 0.004 * c))
                     + rng.integers(-(amp >> 6), amp >> 6, n)
                     for c in range(channels)]).T.reshape(-1).astype(np.int32)


def _frames(inter, frames, channels, block):
    """Interleaved PCM -> (frames, channels, block) int32."""
    return np.ascontiguousarray(
        inter[:frames * block * channels].reshape(frames, block, channels)
        .transpose(0, 2, 1))


# the old per-call expression of each cached constant, and the call that
# now makes it: (old, new(device))
_CONSTANTS = {
    "window": (
        lambda: torch.as_tensor(host_window(("tukey", 0.5), 4096),
                                dtype=torch.float64),
        lambda d: lpc.window_array(("tukey", 0.5), 4096, torch.float64, d)),
    "binomial_rows": (
        lambda: torch.tensor(fixed._BINOM, dtype=torch.int64),
        lambda d: device_constant(fixed._BINOM, torch.int64, d)),
    "candidate_bps": (
        lambda: torch.tensor(decorrelate.candidate_bps(16),
                             dtype=torch.int64),
        lambda d: device_constant(decorrelate.candidate_bps(16),
                                  torch.int64, d)),
    "assignment_table": (
        lambda: torch.tensor(decorrelate.ASSIGNMENTS, dtype=torch.int64),
        lambda d: device_constant(decorrelate.ASSIGNMENTS, torch.int64, d)),
    "packed_meta": (
        lambda: torch.tensor([2, 2688], dtype=torch.int32),
        lambda d: device_constant((2, 2688), torch.int32, d)),
}


@pytest.mark.parametrize("name", sorted(_CONSTANTS))
def test_planner_constant_is_cached_per_device(name):
    old, new = _CONSTANTS[name]
    want = old()
    got = new(CPU)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert new(CPU) is got
    on_meta = new(META)
    assert on_meta.device == META and on_meta.shape == want.shape
    assert new(META) is on_meta and on_meta is not got


class _HostTensors(TorchDispatchMode):
    """Counts tensors built from host data (``torch.tensor``,
    ``torch.as_tensor``): on the card each is a host-to-device copy,
    which a CUDA graph capture refuses."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_planner_builds_no_host_tensor_after_first_call(mode, channels):
    """f32 analysis: in f64 the CPU takes the autocorrelation's plain
    version, the host's numpy, which the card replaces with a kernel."""
    pcm = torch.as_tensor(_frames(
        _music(np.random.default_rng(21), 512 * 2, channels, 16), 2,
        channels, 512))
    kw = dict(bits_per_sample=16, block_size=512, max_lpc_order=8,
              max_partition_order=4, analysis="f32", **MODES[mode])
    first = plan_to_numpy(teb.encode_frames_plan(pcm, **kw))
    with _HostTensors() as seen:
        again = plan_to_numpy(teb.encode_frames_plan(pcm, **kw))
    assert seen.count == 0
    np.testing.assert_array_equal(again["assignment"], first["assignment"])


def _leaves(plan: dict, rows: int):
    """Every leaf of a numpy plan, as (name, (rows, -1) array): the
    packed residual blob without its two trailing words, one row per
    frame."""
    for k, v in plan.items():
        if k == "channels":
            for s, ch in enumerate(v):
                for ck, cv in ch.items():
                    yield f"{s}.{ck}", cv.reshape(rows, -1)
        elif k == "packed_words":
            yield k, v[:-2].reshape(rows, -1)
        elif k != "packed_meta":
            yield k, v.reshape(rows, -1)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_padded_plan_leaves_match_jax(mode):
    """test_torch_batch's seeded stereo PCM, 3 frames and one silent
    padding frame (as the JAX BatchEncoder pads a short batch): every
    leaf equals the JAX package's, the padded row included."""
    block = 1024
    pcm = np.zeros((4, 2, block), np.int32)
    pcm[:3] = _frames(_music(np.random.default_rng(21), block * 3, 2, 16),
                      3, 2, block)
    kw = dict(bits_per_sample=16, block_size=block, max_lpc_order=12,
              max_partition_order=6, analysis="f64", **MODES[mode])
    want = jax.tree_util.tree_map(np.asarray, jeb.encode_frames_plan(
        jnp.asarray(pcm.astype(np.int16)), slim=mode == "frame_packed",
        **kw))
    got = plan_to_numpy(teb.encode_frames_plan(
        torch.as_tensor(pcm.astype(np.int16)), **kw))
    assert sorted(got) == sorted(want)
    wl = dict(_leaves(want, 4))
    for k, g in _leaves(got, 4):
        assert g.dtype == wl[k].dtype, k
        np.testing.assert_array_equal(g, wl[k], k)


@pytest.mark.parametrize("pad", ["silence", "full_scale_noise"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_padding_rows_change_no_real_row(mode, pad):
    """Rows are planned and packed independently: 3 real frames planned
    alone and with 5 padding frames give the same leaves, overflow and
    fallback flags included (silence takes the autocorrelation's 0/0
    path, full-scale noise the verbatim fallback)."""
    block, B, padded = 512, 3, 8
    rng = np.random.default_rng(11)
    real = _frames(_music(rng, block * B, 2, 16), B, 2, block)
    pcm = np.zeros((padded, 2, block), np.int32)
    pcm[:B] = real
    if pad == "full_scale_noise":
        pcm[B:] = rng.integers(-(1 << 15), 1 << 15, (padded - B, 2, block))
    kw = dict(bits_per_sample=16, block_size=block, max_lpc_order=8,
              max_partition_order=4, analysis="f64", **MODES[mode])
    alone = dict(_leaves(plan_to_numpy(teb.encode_frames_plan(
        torch.as_tensor(real), **kw)), B))
    for k, v in _leaves(plan_to_numpy(teb.encode_frames_plan(
            torch.as_tensor(pcm), **kw)), padded):
        np.testing.assert_array_equal(v[:B], alone[k], k)


@pytest.fixture(scope="module")
def short_batch_stream():
    """301 frames of block 256 and a 100-sample tail, and the host
    encoder's bytes."""
    block, frames = 256, 301
    n = block * frames + 100
    inter = _music(np.random.default_rng(30), n, 2, 16)
    opts = Options(block_size=block, max_lpc_order=8)
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, opts, 44100, 16, 2, total_samples=n)
    w.write(inter)
    w.finalize()
    return inter, n, opts, buf.getvalue()


@pytest.mark.parametrize("frames,batch_frames,shards", [
    (301, 256, 1),   # a 45-frame batch padded to 256
    (3, 8, 1),       # the only batch is short
    (301, 256, 3),   # padded, then sharded: the last two shards all padding
])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_padded_short_batch_writes_host_bytes(short_batch_stream, mode,
                                              frames, batch_frames, shards):
    inter, n, opts, host = short_batch_stream
    if frames != 301:
        n = opts.block_size * frames + 100
        inter = inter[:2 * n]
        buf = io.BytesIO()
        w = FlacSampleWriter(buf, opts, 44100, 16, 2, total_samples=n)
        w.write(inter)
        w.finalize()
        host = buf.getvalue()
    kw = {k: v for k, v in MODES[mode].items()}
    kw["pack_budget"] = None if kw["pack_budget"] else 0
    mesh = dict(mesh=tmesh.batch_mesh(["cpu"] * shards)) if shards > 1 \
        else dict(device="cpu")
    buf = io.BytesIO()
    enc = BatchEncoder(buf, opts, 44100, 16, 2, total_samples=n,
                       batch_frames=batch_frames, analysis="f64", **kw,
                       **mesh)
    enc.write(inter)
    enc.finalize()
    assert buf.getvalue() == host
    assert enc.device_frames == frames


def test_launch_tally_counts_once_per_replay(monkeypatch):
    """What a capture launches is kept apart (the capture runs nothing)
    and counted at each replay; an error inside the capture leaves the
    counts as they were."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(
        kernels.LAUNCHES, 1))
    with kernels.launches_apart() as tally:
        kernels.LAUNCHES["pack_symbols"] += 2
        kernels.LAUNCHES["splice_subframes"] += 1
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 1)
    assert tally == {**dict.fromkeys(kernels.LAUNCHES, 0),
                     "pack_symbols": 2, "splice_subframes": 1}
    for _ in range(3):
        kernels.add_launches(tally)
    assert kernels.LAUNCHES["pack_symbols"] == 7
    assert kernels.LAUNCHES["splice_subframes"] == 4
    assert kernels.LAUNCHES["autocorr_levinson"] == 1
    with pytest.raises(RuntimeError):
        with kernels.launches_apart():
            kernels.LAUNCHES["autocorr_levinson"] += 1
            raise RuntimeError("capture failed")
    assert kernels.LAUNCHES["autocorr_levinson"] == 1


def test_plan_graph_keys_like_jit_plus_stream(monkeypatch):
    """One graph per (device, stream, shape, dtype, static arguments):
    the same key gives the same graph, any other part a new one."""
    made = []

    class FakeGraph:
        def __init__(self, shape, dtype, stream, **kw):
            made.append((shape, dtype, stream, kw))

    monkeypatch.setattr(teb, "PlanGraph", FakeGraph)
    monkeypatch.setattr(teb, "PLAN_GRAPHS", {})
    s0 = types.SimpleNamespace(device=torch.device("cuda", 0), cuda_stream=7)
    s1 = types.SimpleNamespace(device=torch.device("cuda", 0), cuda_stream=9)
    kw = dict(bits_per_sample=16, block_size=4096, max_lpc_order=12,
              max_partition_order=6, mid_side=True, exhaustive=True,
              window_kind=("tukey", 0.5), analysis="f64", pack_budget=18,
              frame_pack=True)
    shape = (256, 2, 4096)
    g = teb.plan_graph(shape, torch.int16, s0, **kw)
    assert teb.plan_graph(shape, torch.int16, s0, **kw) is g
    others = [teb.plan_graph(shape, torch.int16, s1, **kw),
              teb.plan_graph((128, 2, 4096), torch.int16, s0, **kw),
              teb.plan_graph(shape, torch.int32, s0, **kw),
              teb.plan_graph(shape, torch.int16, s0, **{**kw,
                                                        "analysis": "f32"}),
              teb.plan_graph(shape, torch.int16, s0, **{**kw,
                                                        "frame_pack": False})]
    assert len(made) == 6 == len(teb.PLAN_GRAPHS)
    assert len({id(o) for o in others + [g]}) == 6
