"""The port's jit boundary on the decode path, on the CPU.

On CUDA ``BatchDecoder`` replays one captured graph per configuration
for the device parse (``ops.framescan.ParseGraph``) and for the
reconstruction (``parallel.batch_decode.ReconstructGraph``), on batches
padded to the JAX decoder's frame buckets; the card tests are in
``tests/test_torch_cuda.py``.  What the CPU can hold, on inputs made from
numpy seeds, every comparison exact:

* the bucket rule is the JAX decoder's;
* padding rows change no real row: the padded reconstruction equals the
  unpadded one and the JAX ``_device_reconstruct``, and the padded parse
  (zero lanes, a zero-filled byte tail) equals the unpadded parse, with
  the same gate as the JAX package's;
* the decode functions build no host tensor once warm, so a capture
  meets no host-to-device copy;
* the capture procedure counts a graph's launches once per replay, and
  the decode graphs are keyed like JAX's jit cache plus device and
  stream;
* ``BatchDecoder(device="cpu")`` on streams that leave short batches
  gives the input PCM and the JAX decoder's, on both parse paths and
  sharded.
"""

import contextlib
import inspect
import io
import textwrap
import types
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flac_codec_tpu.ops import framescan as jfs
from flac_codec_tpu.parallel import batch_decode as jbd
from flac_codec_tpu_torch import graphs, kernels, native
from flac_codec_tpu_torch.decode import Decoder
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.ops import framescan as tfs
from flac_codec_tpu_torch.ops.predict import FIXED_ROWS, predict_fixed_batch
from flac_codec_tpu_torch.ops.predict_pallas import TAP_BUCKETS
from flac_codec_tpu_torch.parallel import batch_decode as tbd
from flac_codec_tpu_torch.parallel.mesh import batch_mesh

torch.set_num_threads(2)

BS = 48           # small blocks: interpreter-friendly bit counts


def _jax_bucket(n: int, lanes: int) -> int:
    """The JAX decoder's own bucket lines (``_read_batch_device_parse``),
    run with ``framescan.LANES`` = ``lanes`` and ``B`` = ``n``."""
    src = inspect.getsource(jbd.BatchDecoder._read_batch_device_parse)
    lines = src.splitlines()
    i = next(k for k, line in enumerate(lines)
             if line.strip() == "bucket = framescan.LANES")
    assert lines[i + 1].strip().startswith("while bucket // 2 >= B")
    scope = {"framescan": types.SimpleNamespace(LANES=lanes), "B": n}
    exec(textwrap.dedent("\n".join(lines[i:i + 3])), scope)
    return scope["bucket"]


@pytest.mark.parametrize("batch_frames", [4, 64, 100, 256, 1024])
def test_frame_bucket_is_the_jax_rule(batch_frames):
    got = [tbd.frame_bucket(n, batch_frames) for n in range(1, 1025)]
    assert got == [_jax_bucket(n, batch_frames) for n in range(1, 1025)]


# ---------------------------------------------------------------------------
# Padding rows change no real row
# ---------------------------------------------------------------------------

def _raw_subframes(rng, B, C, N, mode, taps):
    """B frames of seeded raw subframes in ``RECON_KEYS`` order: FIXED
    rows (shift 0) for "fixed", LPC rows up to order ``taps`` otherwise;
    wasted bits 0-2; every channel assignment the channel count allows."""
    x = rng.integers(-(1 << 14), 1 << 14, (B, C, N))
    q = np.zeros((B, C, 32), np.int64)
    if mode == "fixed":
        order = rng.integers(0, 5, (B, C))
        q[:, :, :4] = FIXED_ROWS[order]
        shift = np.zeros((B, C), np.int64)
        x[:, :, 4:] >>= 6                 # cumsums stay within int32
    else:
        order = rng.integers(1, taps + 1, (B, C))
        shift = rng.integers(8, 13, (B, C))
        for b in range(B):
            for c in range(C):
                o = order[b, c]
                q[b, c, :o] = rng.integers(-(1 << 7), 1 << 7, o)
        x[:, :, taps:] >>= 4
    wasted = rng.integers(0, 3, (B, C))
    codes = [0b0001, 0b1000, 0b1001, 0b1010] if C == 2 else [C - 1]
    assignment = rng.choice(codes, B)
    return tuple(a.astype(np.int32)
                 for a in (x, q, shift, order, wasted, assignment))


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("mode,taps", [("fixed", 32)]
                         + [("lpc", t) for t in TAP_BUCKETS])
def test_padded_reconstruct_matches_unpadded_and_jax(mode, taps, C):
    """5 real frames in an 8-frame reconstruct blob, padding zero (as the
    decoder stages it): the real rows equal the unpadded call and the
    JAX ``_device_reconstruct`` in its int64 scan mode, and the padding
    rows reconstruct to zeros."""
    n, B, N = 5, 8, 64
    rng = np.random.default_rng(7 * taps + C)
    raw = _raw_subframes(rng, n, C, N, mode, taps)
    blob = torch.zeros(tbd.recon_len(B, C, N), dtype=torch.int32)
    for dst, a in zip(tbd.recon_views(blob, B, C, N), raw):
        dst[:n] = torch.from_numpy(a)
    padded = tbd._device_reconstruct(*tbd.recon_views(blob, B, C, N),
                                     mode=mode, taps=taps)
    alone = tbd._device_reconstruct(*map(torch.from_numpy, raw), mode=mode,
                                    taps=taps)
    want = np.asarray(jbd._device_reconstruct(*map(jnp.asarray, raw), N,
                                              mode="scan", taps=32))
    assert padded.shape == (B, C, N) and padded.dtype == torch.int32
    np.testing.assert_array_equal(padded[:n].numpy(), alone.numpy())
    np.testing.assert_array_equal(alone.numpy(), want)
    assert not padded[n:].any()


def _stream(n, bps, channels, seed, block=BS):
    """Seeded music-like PCM through the port's host encoder, no
    seektable; returns (stream bytes, interleaved PCM)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = 1 << (bps - 3)
    pcm = np.stack([amp * np.sin(t * (0.03 + 0.01 * c))
                    + rng.normal(0, amp >> 6, n) for c in range(channels)],
                   1).astype(np.int64).reshape(-1)
    buf = io.BytesIO()
    opts = Options.best().no_seektable().with_block_size(block)
    w = FlacSampleWriter(buf, opts, 44100, bps, channels, total_samples=n)
    w.write(pcm)
    w.finalize()
    return buf.getvalue(), pcm


def _scan(data):
    """The native scan of a stream's whole frames, and its byte view."""
    dec = Decoder(io.BytesIO(data))
    si = dec.streaminfo
    view = dec.r.np_view()
    scan = native.load().scan_frames(
        view, dec.r.pos, 1 << 20, si.sample_rate, si.channels,
        si.bits_per_sample, si.maximum_block_size, dec.total_samples)
    assert scan["n"] > 0
    return view, scan, si


def _jax_gate(data: bytes, off, nbits, assignment, N, C, bps):
    """The JAX parser in interpret mode on the bodies in ``data`` (the
    reader's bytes, which ``off`` indexes), then its gate with its own
    valid lanes (``nbits > 0``)."""
    panel = np.zeros((jfs.LANES, 96 * 4), np.uint8)
    lanes = np.zeros((2, jfs.LANES), np.int32)
    for f, (o, nb) in enumerate(zip(off, nbits)):
        assert nb // 8 <= panel.shape[1]
        panel[f, :nb // 8] = np.frombuffer(data[o:o + nb // 8], np.uint8)
    lanes[0, :len(off)] = nbits
    lanes[1, :len(off)] = assignment
    words = np.ascontiguousarray(panel.view(">u4").astype(np.uint32).T)
    parsed = jfs.parse_frame_bodies(jnp.asarray(words),
                                    jnp.asarray(lanes[0]),
                                    jnp.asarray(lanes[1]), N, C, bps,
                                    interpret=True)
    return np.asarray(jfs.parse_gate(parsed, jnp.asarray(lanes[0] > 0)))


@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (12, 6)])
def test_padded_parse_matches_unpadded_and_jax_gate(bps, channels):
    """5 frames staged by the decoder into 8 lanes and a 1 MiB byte
    buffer (padding lanes with ``nbits`` 0, the byte tail zero): the real
    lanes parse as they do unpadded, the padding lanes to zeros, and the
    gate with ``valid = nbits > 0`` is the unpadded gate, whose all_ok
    and order_max are the JAX gate's on the JAX parser's output."""
    data, _ = _stream(BS * 5, bps, channels, 40 + bps)
    view, scan, si = _scan(data)
    n, B, N, C = scan["n"], 8, si.maximum_block_size, si.channels
    assert n == 5
    with tbd.BatchDecoder(io.BytesIO(data), device="cpu") as dec:
        blob, cap, _ = tbd._stage_bodies(dec._staging, [(view, scan)], B)
    assert cap == 1 << 20 and blob.shape == (16 * B + cap,)
    off = scan["body_off"].astype(np.int64)
    span = int(off[-1] - off[0]) + int(scan["body_bytes"][-1])
    assert blob[16 * B + span - 1] == view[off[-1] + scan["body_bytes"][-1]
                                           - 1]
    assert not blob[16 * B + span:].any()
    padded, gate = tfs.parse_batch(blob, B, N, C, bps)
    nbits = scan["body_bytes"].astype(np.int32) * 8
    assign = scan["assignment"].astype(np.int32)
    alone = tfs.parse_frame_bodies(torch.from_numpy(view.copy()),
                                   torch.from_numpy(off),
                                   torch.from_numpy(nbits),
                                   torch.from_numpy(assign), N, C, bps)
    for key, want in alone.items():
        assert padded[key].dtype == want.dtype, key
        assert torch.equal(padded[key][:n], want), key
        assert not padded[key][n:].any(), key
    assert padded["assignment"].tolist() == assign.tolist() + [0] * (B - n)
    want_gate = tfs.parse_gate(alone, torch.ones(n, dtype=torch.bool))
    assert gate.tolist() == want_gate.tolist()
    assert gate[0] == 1
    jgate = _jax_gate(view.tobytes(), off, nbits, assign, N, C, bps)
    assert gate[:2].tolist() == [int(jgate[0]), int(jgate[1])]


# ---------------------------------------------------------------------------
# No host tensor once warm
# ---------------------------------------------------------------------------

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


def _gate_call():
    data, _ = _stream(BS * 3, 16, 2, 9)
    view, scan, si = _scan(data)
    parsed = tfs.parse_frame_bodies(
        torch.from_numpy(view.copy()),
        torch.from_numpy(scan["body_off"].astype(np.int64)),
        torch.from_numpy(scan["body_bytes"].astype(np.int32) * 8),
        torch.from_numpy(scan["assignment"].astype(np.int32)),
        si.maximum_block_size, si.channels, si.bits_per_sample)
    valid = torch.ones(scan["n"], dtype=torch.bool)
    return lambda: tfs.parse_gate(parsed, valid)


def _reconstruct_call(mode, taps):
    raw = tuple(map(torch.from_numpy, _raw_subframes(
        np.random.default_rng(3), 3, 2, 64, mode, taps)))
    return lambda: tbd._device_reconstruct(*raw, mode=mode, taps=taps)


def _fixed_call():
    x, _, _, order, *_ = _raw_subframes(np.random.default_rng(4), 3, 2, 64,
                                        "fixed", 32)
    x, order = torch.from_numpy(x).reshape(6, 64), torch.from_numpy(order)
    return lambda: predict_fixed_batch(x, order.reshape(6))


_CALLS = {"parse_gate": _gate_call,
          "reconstruct_fixed": lambda: _reconstruct_call("fixed", 32),
          "reconstruct_lpc": lambda: _reconstruct_call("lpc", 8),
          "predict_fixed_batch": _fixed_call}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_decode_function_builds_no_host_tensor_after_first_call(name):
    call = _CALLS[name]()
    first = call()
    with _HostTensors() as seen:
        again = call()
    assert seen.count == 0
    assert torch.equal(again, first)


# ---------------------------------------------------------------------------
# The capture procedure and the graph caches
# ---------------------------------------------------------------------------

class _FakeCUDAGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeMemPool:
    """Stands in for ``torch.cuda.MemPool``: an id pair of its own."""

    ids = iter(range(1, 10 ** 6))

    def __init__(self, pools):
        self.id = (0, next(self.ids))
        pools[self.id] = self


class _FakeTorch:
    """``torch`` with ``cuda`` replaced."""

    def __init__(self, cuda):
        self.cuda = cuda

    def __getattr__(self, name):
        return getattr(torch, name)


class _PoolAllocations(TorchDispatchMode):
    """Records each tensor an op makes on this thread into ``made``."""

    def __init__(self, made: list):
        super().__init__()
        self.made = made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made.extend(t for t in torch.utils._pytree.tree_leaves(out)
                         if isinstance(t, torch.Tensor))
        return out


@pytest.fixture
def fake_cuda(monkeypatch):
    """``graphs.CapturedGraph`` on the CPU: the capture runs the function
    eagerly, ``memory_reserved`` grows by 5 a call, each ``MemPool`` has
    an id of its own, ``captures`` records the pool id of each capture,
    in order, and ``warm_ups`` each ``use_mem_pool`` block as (pool id,
    the tensors its thread's ops made inside it), as the real
    ``use_mem_pool`` routes only its own thread's allocations.  Only
    the graphs hold their pools."""
    reserved = iter(range(0, 10 ** 6, 5))
    captures, warm_ups, pools = [], [], weakref.WeakValueDictionary()
    null = contextlib.nullcontext

    def graph(g, stream=None, pool=None):
        assert pool in pools
        captures.append(pool)
        return null()

    @contextlib.contextmanager
    def use_mem_pool(pool, device=None):
        made = []
        warm_ups.append((pool.id, made))
        with _PoolAllocations(made):
            yield

    cuda = types.SimpleNamespace(
        device=lambda d: null(), stream=lambda s: null(),
        synchronize=lambda d=None: None, empty_cache=lambda: None,
        memory_reserved=lambda d=None: next(reserved),
        max_memory_reserved=lambda d=None: 10 ** 7,
        reset_peak_memory_stats=lambda d=None: None,
        CUDAGraph=_FakeCUDAGraph, graph=graph,
        MemPool=lambda: _FakeMemPool(pools), use_mem_pool=use_mem_pool)
    monkeypatch.setattr(graphs, "torch", _FakeTorch(cuda))
    monkeypatch.setattr(graphs, "_POOLS", {})
    monkeypatch.setattr(graphs, "POOL_BYTES", {})
    monkeypatch.setattr(graphs, "_PEAKS", {})
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(
        kernels.LAUNCHES, 0))
    return types.SimpleNamespace(device=torch.device("cpu"), cuda_stream=3,
                                 captures=captures, warm_ups=warm_ups)


def test_launch_tally_counts_once_per_replay(fake_cuda):
    """The warm-up launches for real; the capture's launches are kept
    apart and counted at each replay, with the replays."""
    calls = []

    def fn(x):
        calls.append(x)
        kernels.LAUNCHES["predict_lpc"] += 1
        kernels.LAUNCHES["parse_frame_bodies"] += 2
        return x + 1

    g = graphs.CapturedGraph(fn, lambda: torch.zeros(3), fake_cuda)
    assert len(calls) == 2 and calls[0] is calls[1] is g.input
    assert g.tally == {**dict.fromkeys(kernels.LAUNCHES, 0),
                       "predict_lpc": 1, "parse_frame_bodies": 2}
    assert kernels.LAUNCHES["predict_lpc"] == 1
    assert g.reserved_bytes == 5 and g.capture_seconds >= 0
    for _ in range(3):
        assert g.replay() is g.output
    assert g.replays == g.graph.replays == 3
    assert kernels.LAUNCHES["predict_lpc"] == 1 + 3
    assert kernels.LAUNCHES["parse_frame_bodies"] == 2 + 3 * 2


def test_decode_graphs_capture_their_functions(fake_cuda):
    """The parse and reconstruct graphs' static inputs and outputs, on
    the CPU: zero inputs of the bucket's layout, and the function's
    output on them."""
    pg = tfs.ParseGraph(fake_cuda, 8, 1 << 12, BS, 2, 16)
    assert pg.input.shape == (16 * 8 + (1 << 12),)
    assert pg.input.dtype == torch.uint8
    parsed, gate = pg.output
    assert parsed["buf"].shape == (8, 2, BS)
    assert not parsed["ok"].any() and gate.tolist() == [1, 0, 1]
    rg = tbd.ReconstructGraph(fake_cuda, (8, 2, BS), "lpc", 12)
    assert rg.input.shape == (tbd.recon_len(8, 2, BS),)
    assert rg.output.shape == (8, 2, BS) and not rg.output.any()


# encode_frames_plan's static arguments at the small block
_PLAN_KW = dict(bits_per_sample=16, block_size=BS, max_lpc_order=8,
                max_partition_order=2, mid_side=True, exhaustive=False,
                window_kind=("tukey", 0.5), analysis="f64", pack_budget=18,
                frame_pack=True)


def _captures_on(stream) -> list:
    """A plan, a parse and a reconstruct graph captured on ``stream``."""
    from flac_codec_tpu_torch.ops import encode_batch as teb

    return [teb.PlanGraph((2, 2, BS), torch.int16, stream, **_PLAN_KW),
            tfs.ParseGraph(stream, 4, 1 << 10, BS, 2, 16),
            tbd.ReconstructGraph(stream, (4, 2, BS), "lpc", 8)]


def test_graphs_of_one_stream_capture_into_one_pool(fake_cuda):
    """Every capture on one (device, stream), plan, parse or
    reconstruct, passes the same pool handle; the stream's pool total is
    the sum of its captures' growth."""
    made = _captures_on(fake_cuda)
    handle = graphs.stream_pool(fake_cuda)
    assert fake_cuda.captures == [handle.id] * 3
    assert [g.pool for g in made] == [handle] * 3
    assert graphs.POOL_BYTES == {(fake_cuda.device, 3): 3 * 5}
    assert graphs.stream_pool(fake_cuda) == handle


@pytest.mark.parametrize("other", ["stream", "device"])
def test_other_streams_and_devices_get_other_pools(fake_cuda, other):
    """A second stream of the device, or the same stream number on
    another device, captures into a pool of its own."""
    second = types.SimpleNamespace(
        device=(torch.device("cpu", 1) if other == "device"
                else fake_cuda.device),
        cuda_stream=3 if other == "device" else 4)
    a = _captures_on(fake_cuda)
    b = _captures_on(second)
    first, last = fake_cuda.captures[:3], fake_cuda.captures[3:]
    assert len(set(first)) == len(set(last)) == 1
    assert first[0] != last[0]
    assert {g.pool for g in a} == {graphs.stream_pool(fake_cuda)}
    assert {g.pool for g in b} == {graphs.stream_pool(second)}
    assert sorted(graphs.POOL_BYTES.values()) == [15, 15]


def test_a_stream_whose_graphs_are_gone_gets_a_new_pool(fake_cuda):
    """Once every graph of a stream has been dropped, its pool and its
    total go, and the next capture there starts a new pool (the old one
    is released when its memory is free)."""
    made = _captures_on(fake_cuda)
    handle = made[0].pool.id
    del made
    assert graphs.POOL_BYTES == {}
    again = _captures_on(fake_cuda)
    assert {g.pool for g in again} == {graphs.stream_pool(fake_cuda)}
    assert again[0].pool.id != handle
    assert graphs.POOL_BYTES == {(fake_cuda.device, 3): 15}


def _in(t, tensors) -> bool:
    return any(t is u for u in tensors)


def test_warm_ups_allocate_inside_their_streams_pool(fake_cuda):
    """Each graph's warm-up, plan, parse or reconstruct, runs inside its
    stream's pool, which its capture then uses; ``make_input()`` runs
    outside it; a second stream warms up in a pool of its own."""
    second = types.SimpleNamespace(device=fake_cuda.device, cuda_stream=4)
    made = _captures_on(fake_cuda) + _captures_on(second)
    pools = [graphs.stream_pool(fake_cuda)] * 3 \
        + [graphs.stream_pool(second)] * 3
    assert pools[0] is not pools[3]
    assert [p for p, _ in fake_cuda.warm_ups] == [p.id for p in pools]
    assert fake_cuda.captures == [p.id for p in pools]
    assert [g.pool for g in made] == pools
    for g, (_, inside) in zip(made, fake_cuda.warm_ups):
        assert inside, "the warm-up made no tensor inside the pool"
        assert not _in(g.input, inside)


def test_cached_constants_first_built_in_a_warm_up_are_outside_the_pool(
        fake_cuda, monkeypatch):
    """``device_constant``, ``window_array`` and ``_crc_planes``, first
    built during a warm-up, go through ``graphs.outside_pool`` while the
    warm-up's pool is routed, and no tensor they return was made inside
    the pool."""
    from flac_codec_tpu_torch.ops import common, framepack, lpc

    built = {}
    for mod in (common, lpc, framepack):
        def spy(build, mod=mod):
            routed = getattr(graphs._ROUTED, "pool", None)
            t = graphs.outside_pool(build)
            built.setdefault(mod.__name__, []).append((routed, t))
            return t
        monkeypatch.setattr(mod, "outside_pool", spy)
    for cache in (common.device_constant, lpc.window_array,
                  framepack._crc_planes):
        cache.cache_clear()
    made = _captures_on(fake_cuda)
    assert sorted(built) == sorted(m.__name__
                                   for m in (common, lpc, framepack))
    inside = [t for _, ts in fake_cuda.warm_ups for t in ts]
    pool = graphs.stream_pool(fake_cuda)
    for name, calls in built.items():
        for routed, t in calls:
            assert routed is pool, name
            assert isinstance(t, torch.Tensor) and not _in(t, inside), name
    assert getattr(graphs._ROUTED, "pool", None) is None
    assert all(g.output is not None for g in made)


def test_outside_pool_runs_on_the_callers_thread_outside_a_warm_up():
    """Outside a warm-up a build runs where it is called."""
    import threading

    assert graphs.outside_pool(threading.get_ident) == threading.get_ident()


def test_decode_graph_keys_like_jit_plus_stream(monkeypatch):
    """One graph per JAX jit key plus device and stream: the same key
    gives the same graph, any other part a new one."""
    made = []

    def fake(*args):
        made.append(args)
        return object()

    monkeypatch.setattr(tfs, "ParseGraph", fake)
    monkeypatch.setattr(tfs, "PARSE_GRAPHS", {})
    monkeypatch.setattr(tbd, "ReconstructGraph", fake)
    monkeypatch.setattr(tbd, "RECONSTRUCT_GRAPHS", {})
    s0 = types.SimpleNamespace(device=torch.device("cuda", 0), cuda_stream=7)
    s1 = types.SimpleNamespace(device=torch.device("cuda", 0), cuda_stream=9)
    s2 = types.SimpleNamespace(device=torch.device("cuda", 1), cuda_stream=7)
    parse = (256, 1 << 22, 4096, 2, 16)
    g = tfs.parse_graph(s0, *parse)
    assert tfs.parse_graph(s0, *parse) is g
    others = [tfs.parse_graph(s, *parse) for s in (s1, s2)]
    for i in range(len(parse)):
        other = list(parse)
        other[i] += 1
        others.append(tfs.parse_graph(s0, *other))
    assert len(made) == 8 == len(tfs.PARSE_GRAPHS)
    assert len({id(o) for o in others + [g]}) == 8
    made.clear()
    shape = (256, 2, 4096)
    r = tbd.reconstruct_graph(s0, shape, "lpc", 12)
    assert tbd.reconstruct_graph(s0, list(shape), "lpc", 12) is r
    others = [tbd.reconstruct_graph(s1, shape, "lpc", 12),
              tbd.reconstruct_graph(s2, shape, "lpc", 12),
              tbd.reconstruct_graph(s0, (128, 2, 4096), "lpc", 12),
              tbd.reconstruct_graph(s0, (256, 1, 4096), "lpc", 12),
              tbd.reconstruct_graph(s0, (256, 2, 1152), "lpc", 12),
              tbd.reconstruct_graph(s0, shape, "lpc", 16),
              tbd.reconstruct_graph(s0, shape, "fixed", 32)]
    assert len(made) == 8 == len(tbd.RECONSTRUCT_GRAPHS)
    assert len({id(o) for o in others + [r]}) == 8


# ---------------------------------------------------------------------------
# Short batches through the decoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_batch_stream():
    """70 frames of block 48 and a 30-sample tail, stereo 16-bit."""
    return _stream(BS * 70 + 30, 16, 2, 70)


@pytest.mark.parametrize("frames,batch_frames,shards", [
    (9, 4, 1),       # batches 4, 4, 1 (bucket 4: three padding rows)
    (70, 256, 1),    # one 70-frame batch in a 128-frame bucket
    (70, 100, 3),    # bucket 100 in shards of 34, 33, 33: the last two
                     # part padding, then all padding
    (9, 4, 2),       # the 1-frame batch's second shard is all padding
])
def test_short_batches_decode_like_jax(short_batch_stream, frames,
                                       batch_frames, shards):
    data, pcm = short_batch_stream
    if frames != 70:
        data, pcm = _stream(BS * frames + 30, 16, 2, frames)
    with jbd.BatchDecoder(io.BytesIO(data), batch_frames=batch_frames) as jd:
        want = np.asarray(jd.read_all_device())
    where = (dict(mesh=batch_mesh(["cpu"] * shards)) if shards > 1
             else dict(device="cpu"))
    with tbd.BatchDecoder(io.BytesIO(data), batch_frames=batch_frames,
                          **where) as dec:
        got = dec.read_all_device()
        assert (dec.device_frames, dec.host_frames) == (frames, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(-1), pcm)


@pytest.mark.parametrize("frames,batch_frames", [(9, 4), (70, 256)])
def test_short_batches_device_parse_like_jax(monkeypatch, frames,
                                             batch_frames):
    data, pcm = _stream(BS * frames + 30, 16, 2, 100 + frames)
    monkeypatch.setenv("FLAC_TPU_PALLAS", "force")
    with jbd.BatchDecoder(io.BytesIO(data), batch_frames=batch_frames,
                          device_parse=True) as jd:
        assert jd._device_parse
        want = np.asarray(jd.read_all_device())
    with tbd.BatchDecoder(io.BytesIO(data), batch_frames=batch_frames,
                          device="cpu", device_parse=True) as dec:
        got = dec.read_all_device()
        assert (dec.device_frames, dec.host_frames) == (frames, 1)
        assert dec.parse_fallbacks == 1       # the short tail
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(-1), pcm)


def test_read_batch_device_hands_out_its_own_tensors():
    """Each batch is a tensor of its real frames only, and a later batch
    leaves it as it was."""
    data, pcm = _stream(BS * 9 + 30, 16, 2, 11)
    with tbd.BatchDecoder(io.BytesIO(data), batch_frames=4,
                          device="cpu") as dec:
        batches = [dec.read_batch_device() for _ in range(3)]
        kept = [b[0].clone() for b in batches]
        dec.read_batch_device()
    assert [b[0].shape[0] for b in batches] == [4, 4, 1]
    for (got, _), want in zip(batches, kept):
        assert torch.equal(got, want)
    flat = torch.cat([b[0] for b in batches]).transpose(1, 2).reshape(-1)
    np.testing.assert_array_equal(flat.numpy(), pcm[:BS * 9 * 2])
