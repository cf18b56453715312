"""The port's CUDA kernels and its encode and decode paths on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one.  Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

These tests import no JAX; ``--noconftest`` skips ``tests/conftest.py``,
which does, so they also run where JAX is not installed.
"""

import io

import numpy as np
import pytest
import torch

from chip_smoke import (WINDOW_EDGE_CASES, bit_equal, int32_edge_rows,
                        k1_junk, k2_lists, music, parses_as_built,
                        window_edge_inputs)
from flac_codec_tpu_torch import kernels, native
from flac_codec_tpu_torch.bitio import BitWriter
from flac_codec_tpu_torch.convert import plan_to_numpy
from flac_codec_tpu_torch.decode import (Decoder, FlacSampleReader, Verified,
                                         verify)
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.ops import encode_batch as teb
from flac_codec_tpu_torch.ops import framescan as tfs
from flac_codec_tpu_torch.ops import lpc as tlpc
from flac_codec_tpu_torch.ops import packpanel as tpp
from flac_codec_tpu_torch.ops.common import u32_to_i32
from flac_codec_tpu_torch.ops.predict import predict_batch_plain
from flac_codec_tpu_torch.ops.predict_pallas import (TAP_BUCKETS, int64_rows,
                                                     predict_lpc)
from flac_codec_tpu_torch.parallel import batch_decode as tbd
from flac_codec_tpu_torch.parallel.batch import BatchEncoder
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder
from flac_codec_tpu_torch.parallel.mesh import batch_mesh, shard_streams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _symbols(gen, dev, rows, M, max_width, density=0.9):
    widths = torch.randint(1, max_width + 1, (rows, M), generator=gen,
                           device=dev, dtype=torch.int32)
    ends = (torch.cumsum(widths, 1) + 5).to(torch.int32)
    values = (torch.randint(0, 1 << 32, (rows, M), generator=gen, device=dev)
              & ((1 << widths.long()) - 1))
    mask = torch.rand((rows, M), generator=gen, device=dev) < density
    return u32_to_i32(values), widths, ends, mask


@pytest.mark.parametrize("rows,M,P,max_width", [
    (256, 4229, 2688, 20),     # preset -8 16-bit slot
    (64, 4229, 3712, 28),      # 24-bit budget
    (8, 300, 64, 32),          # rows that overflow the panel
    (3, 65600, 14000, 8),      # > 48 KB of shared memory
    (2, 420000, 60000, 9),     # > 227 KB: the panel in global memory
])
def test_pack_symbols_kernel_matches_plain(dev, rows, M, P, max_width):
    gen = torch.Generator(device=dev).manual_seed(rows + M)
    args = _symbols(gen, dev, rows, M, max_width)
    n0 = kernels.LAUNCHES["pack_symbols"]
    got, ovf = tpp.pack_symbols(*args, P)
    want, wovf = tpp.pack_symbols_plain(*args, P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_symbols"] == n0 + 1
    assert torch.equal(got, want)
    assert torch.equal(ovf, wovf)
    if P == 64:
        assert ovf.any()


def _k2_matches_plain(args, P):
    """K2 against its plain version: panels, flags and their dtype, and
    exactly one launch."""
    n0 = kernels.LAUNCHES["pack_symbols"]
    got, ovf = tpp.pack_symbols(*args, P)
    want, wovf = tpp.pack_symbols_plain(*args, P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_symbols"] == n0 + 1
    assert ovf.dtype == torch.bool and ovf.shape == (args[0].shape[0],)
    assert torch.equal(got, want)
    assert torch.equal(ovf, wovf)
    return got, ovf


def _k2_case(name, gen, dev):
    """(values, widths, ends, mask), P for one of the edge lists."""
    if name == "32-bit symbols":
        values = torch.randint(0, 1 << 32, (16, 2001), generator=gen,
                               device=dev)
        ends = torch.arange(1, 2002, device=dev, dtype=torch.int32) * 32 + 7
        return (u32_to_i32(values),
                torch.full((16, 2001), 32, dtype=torch.int32, device=dev),
                ends.expand(16, 2001).contiguous(),
                torch.ones((16, 2001), dtype=torch.bool, device=dev)), 2100
    if name == "1-bit runs":
        v, w, e, m = _symbols(gen, dev, 32, 4229, 1, density=0.8)
        return (v, w, e, m), 160
    if name == "M % 4 = 1, one row":
        return _symbols(gen, dev, 1, 4229, 20), 2688
    if name == "M % 4 = 3, odd rows":
        return _symbols(gen, dev, 7, 1027, 13), 512
    if name == "all-masked rows":
        v, w, e, m = _symbols(gen, dev, 9, 4229, 20)
        m[::2] = False
        return (v, w, e, m), 2688
    # overflow rows: symbols past the panel, wider than 32 bits, or
    # starting before bit 0
    v, w, e, m = _symbols(gen, dev, 12, 4229, 20)
    w[1, 100] = 33
    w[2, 0], e[2, 0] = 9, 3
    e[3, 50:] += 1 << 20
    m[1, 100] = m[2, 0] = m[3, 60] = True
    return (v, w, e, m), 2688


K2_EDGE_CASES = ("32-bit symbols", "1-bit runs", "M % 4 = 1, one row",
                 "M % 4 = 3, odd rows", "all-masked rows", "overflow rows")


@pytest.mark.parametrize("name", K2_EDGE_CASES)
def test_pack_symbols_kernel_edge_lists(dev, name):
    """32-bit symbols end to end, 1-bit symbols many to a word, rows whose
    length is no multiple of 4 (no row 16-byte aligned), one row, rows
    with every symbol masked off, and rows that overflow, each in one
    launch with bool flags; a column-permuted copy packs the same."""
    gen = torch.Generator(device=dev).manual_seed(K2_EDGE_CASES.index(name))
    args, P = _k2_case(name, gen, dev)
    got, ovf = _k2_matches_plain(args, P)
    perm = torch.randperm(args[0].shape[1], device=dev, generator=gen)
    got2, ovf2 = _k2_matches_plain(
        [a[:, perm].contiguous() for a in args], P)
    assert torch.equal(got2, got) and torch.equal(ovf2, ovf)
    if name == "overflow rows":
        assert ovf[1:4].all() and not ovf[4:].any()
    if name == "all-masked rows":
        assert not got[::2].any()


def test_pack_symbols_kernel_framepack_lists(dev):
    """The lists the frame packer hands K2 at preset -8 (residual sections
    and header fields, M = 4229), the planner's residual sections, a
    column-permuted copy (same panels as slot 0) and random lists."""
    _, P, lists = k2_lists(dev, music(24, 44100, 16, seed=16))
    assert lists["framepack slot 0"][0].shape == (256, 4229)
    panels = {name: _k2_matches_plain(args, P)[0]
              for name, args in lists.items()}
    assert torch.equal(panels["permuted"], panels["framepack slot 0"])
    assert panels["framepack slot 0"].any()


def test_pack_symbols_is_one_kernel(dev):
    """One call is one kernel on the card (the profiler's count, where it
    records device activity)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(3)
    args = _symbols(gen, dev, 256, 4229, 20)
    tpp.pack_symbols(*args, 2688)
    torch.cuda.synchronize()
    n0 = kernels.LAUNCHES["pack_symbols"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tpp.pack_symbols(*args, 2688)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_symbols"] == n0 + 1
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if device:
        assert len(device) == 1 and "pack_symbols" in device[0].name


@pytest.mark.parametrize("B,S,P,W", [
    (256, 2, 2688, 5248),      # preset -8 stereo
    (16, 8, 2688, 21696),      # 8 channels
    (5, 1, 128, 320),
    (4, 8, 13696, 107520),     # 8 x 24-bit x 16384: a 420 KB slot
])
def test_splice_kernel_matches_plain(dev, B, S, P, W):
    gen = torch.Generator(device=dev).manual_seed(B * S)
    lens = torch.randint(1, P * 32, (B, S), generator=gen, device=dev)
    lens[0, 0] = 32 * 3
    bits = torch.rand((B, S, P * 32), generator=gen, device=dev) < 0.5
    bits &= torch.arange(P * 32, device=dev) < lens[:, :, None]
    words = (bits.view(B, S, P, 32).long()
             << torch.arange(31, -1, -1, device=dev)).sum(-1)
    panels = u32_to_i32(words).contiguous()
    offs = (torch.cumsum(lens, 1) - lens).to(torch.int32)
    offs[-1, -1] = W * 32 + 40            # junk offset: dropped, no fault
    n0 = kernels.LAUNCHES["splice_subframes"]
    got = tpp.splice_subframes(panels, offs, W)
    want = tpp.splice_subframes_plain(panels, offs, W)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["splice_subframes"] == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("B,P,W", [(64, 2688, 5248), (4, 13696, 60000),
                                   (7, 33, 131)])
def test_splice_kernel_adds_overlaps_and_drops_junk(dev, S, B, P, W):
    """Overlapping set bits add (wrapping) as the plain version's
    index_add_ does; negative and past-the-slot offsets drop the words
    outside the slot; W past 227 KB and W % 4 != 0 take the same path."""
    panels, offs = k1_junk(dev, B, S, P, W, seed=S * 1000 + P)
    got = tpp.splice_subframes(panels, offs, W)
    want = tpp.splice_subframes_plain(panels, offs, W)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.any()


def _device_kernels(fn):
    """The device events of one call of ``fn`` (empty where the profiler
    records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("W", [5248, 107520])
def test_splice_is_one_kernel(dev, W):
    """One call is one kernel, with no memset, whatever the slot size."""
    panels, offs = k1_junk(dev, 16, 2, 2688, W, seed=W)
    n0 = kernels.LAUNCHES["splice_subframes"]
    device = _device_kernels(lambda: tpp.splice_subframes(panels, offs, W))
    assert kernels.LAUNCHES["splice_subframes"] == n0 + 2
    if device:
        assert len(device) == 1 and "splice_kernel" in device[0].name


def _sines(N, rows, seed, dev):
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    sig = np.stack([(1 << 21) * np.sin(t * f) + rng.integers(-99, 99, N)
                    for f in np.linspace(0.002, 0.2, rows)])
    win = tlpc.window_array(("tukey", 0.5), N, torch.float64, dev)
    return (torch.as_tensor(sig, device=dev) * win).contiguous()


@pytest.mark.parametrize("N,M", [
    *((n, m) for n in (33, 47, 48, 63, 64, 1000, 4095, 4096, 4608)
      for m in (1, 12, 32) if n > m),
    (1152, 8), (40, 27), (29, 28), (100, 20)])
def test_autocorr_levinson_kernel_matches_host_rounding(dev, N, M):
    """Bit for bit the host encoder's numpy (np.dot + lp_coefficients),
    on near-pure sines where any other rounding flips coefficients."""
    windowed = _sines(N, 40, N + M, dev)
    n0 = kernels.LAUNCHES["autocorr_levinson"]
    got = tlpc.autocorr_levinson(windowed, M)
    want = tlpc.autocorr_levinson_plain(windowed, M)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["autocorr_levinson"] == n0 + 1
    assert bit_equal(got, want)


@pytest.mark.parametrize("M", [12, 32])
def test_autocorr_levinson_kernel_past_one_wave(dev, M):
    """1100 rows (past one wave of blocks), and rows that start 8 bytes
    off a 16-byte boundary (the 8-byte copy path in place of the bulk
    copies), bit for bit the host's numpy."""
    windowed = _sines(4096, 1100, M, dev)
    assert bit_equal(tlpc.autocorr_levinson(windowed, M),
                     tlpc.autocorr_levinson_plain(windowed, M))
    buf = torch.empty(37 * 4096 + 1, dtype=torch.float64, device=dev)
    rows = buf[1:].view(37, 4096)
    rows.copy_(_sines(4096, 37, M + 1, dev))
    assert rows.data_ptr() % 16 == 8
    assert bit_equal(tlpc.autocorr_levinson(rows, M),
                     tlpc.autocorr_levinson_plain(rows, M))


@pytest.mark.parametrize("N", [16384, 65535])
@pytest.mark.parametrize("M", [12, 32])
def test_autocorr_levinson_kernel_long_rows_any_tile(dev, N, M):
    """Rows past OpenBLAS's one-thread size stream through the tile ring:
    equal bit for bit whatever the tile (the default, 5 and 64 steps of
    32 samples), and as the host's numpy to 1e-9 of lag 0 (numpy may
    split such dots over threads, in another order)."""
    windowed = _sines(N, 9, N + M, dev)
    ref = tlpc.autocorr_levinson(windowed, M)
    for steps in (5, 64):
        assert bit_equal(
            tlpc.autocorr_levinson(windowed, M, tile_steps=steps), ref)
    want = tlpc.autocorr_levinson_plain(windowed, M)[0]
    assert bool(((ref[0] - want).abs() <= 1e-9 * want[:, :1]).all())


def test_autocorr_levinson_is_one_kernel(dev):
    windowed = _sines(4096, 64, 5, dev)
    device = _device_kernels(lambda: tlpc.autocorr_levinson(windowed, 12))
    if device:
        assert len(device) == 1 and "autocorr_levinson" in device[0].name


def test_wrappers_refuse_mixed_devices_and_oversized_rows(dev):
    """Mixed devices raise; a panel or slot past one block's shared memory
    (227 KB) does not: K2 packs it in the zeroed output, K1 gathers it as
    any other slot."""
    v = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    m = torch.zeros((2, 4), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="different devices"):
        tpp.pack_symbols(v, v, v.cpu(), m, 8)
    out, ovf = tpp.pack_symbols(v, v, v, m, 60000)
    assert out.shape == (2, 60000) and not out.any() and not ovf.any()
    with pytest.raises(ValueError, match="different devices"):
        tpp.splice_subframes(torch.zeros((2, 1, 8), dtype=torch.int32),
                             torch.zeros((2, 1), dtype=torch.int32,
                                         device=dev), 16)
    out = tpp.splice_subframes(torch.zeros((2, 1, 8), dtype=torch.int32,
                                           device=dev),
                               torch.zeros((2, 1), dtype=torch.int32,
                                           device=dev), 60000)
    assert out.shape == (2, 60000) and not out.any()


@pytest.mark.parametrize("bps,rate", [(16, 44100), (24, 96000)])
def test_batch_encoder_f64_on_card_matches_host(dev, bps, rate):
    rng = np.random.default_rng(bps)
    n = 4096 * 9 + 1000
    t = np.arange(n)
    amp = 1 << (bps - 3)
    inter = np.stack([amp * np.sin(t * 0.011) + rng.integers(-99, 99, n),
                      amp * np.sin(t * 0.017) + rng.integers(-99, 99, n)]
                     ).T.reshape(-1).astype(np.int32)
    outs = []
    for cls, kw in ((FlacSampleWriter, {}),
                    (BatchEncoder, dict(batch_frames=4, analysis="f64",
                                        device=dev))):
        buf = io.BytesIO()
        enc = cls(buf, Options.best(), rate, bps, 2, total_samples=n, **kw)
        enc.write(inter)
        enc.finalize()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def _stereo_clip(bps: int, frames: int = 9):
    """Seeded stereo PCM of ``frames`` 4096-sample frames and a partial
    tail, interleaved int32, and its sample count."""
    rng = np.random.default_rng(bps + 1)
    n = 4096 * frames + 1000
    t = np.arange(n)
    amp = 1 << (bps - 3)
    inter = np.stack([amp * np.sin(t * 0.011) + rng.integers(-99, 99, n),
                      amp * np.sin(t * 0.017) + rng.integers(-99, 99, n)]
                     ).T.reshape(-1).astype(np.int32)
    return inter, n


def _encode_on(cls, inter, n, bps, rate, **kw):
    buf = io.BytesIO()
    enc = cls(buf, Options.best(), rate, bps, 2, total_samples=n, **kw)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue()


ENCODE_MODES = {"residual_only": dict(frame_pack=False),
                "plan_tree": dict(pack_budget=0)}


@pytest.mark.parametrize("mode", sorted(ENCODE_MODES))
@pytest.mark.parametrize("bps,rate", [(16, 44100), (24, 96000)])
def test_batch_encoder_modes_on_card_match_host(dev, mode, bps, rate):
    """Residual-only packing launches K2 and not K1; the plan tree
    neither; both write the host encoder's bytes."""
    inter, n = _stereo_clip(bps)
    want = _encode_on(FlacSampleWriter, inter, n, bps, rate)
    n0 = dict(kernels.LAUNCHES)
    got = _encode_on(BatchEncoder, inter, n, bps, rate, batch_frames=4,
                     analysis="f64", device=dev, **ENCODE_MODES[mode])
    launched = {k: kernels.LAUNCHES[k] - n0[k] for k in n0}
    assert got == want
    assert launched["autocorr_levinson"] > 0
    assert launched["splice_subframes"] == 0
    assert (launched["pack_symbols"] > 0) == (mode == "residual_only")


@pytest.mark.parametrize("mode", ["frame_packed", *sorted(ENCODE_MODES)])
def test_two_shards_on_one_card(dev, mode):
    """cuda:0 listed twice: two shards on two streams of one card, with
    batches of 5 and 4 frames; the bytes of the host encoder, and the
    decoder's samples gathered on cuda:0."""
    from flac_codec_tpu_torch.parallel.mesh import batch_mesh

    mesh = batch_mesh([dev, dev])
    inter, n = _stereo_clip(16)
    want = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    got = _encode_on(BatchEncoder, inter, n, 16, 44100, batch_frames=5,
                     analysis="f64", mesh=mesh,
                     **ENCODE_MODES.get(mode, {}))
    assert got == want
    n0 = kernels.LAUNCHES["predict_lpc"]
    with BatchDecoder(io.BytesIO(got), batch_frames=5, mesh=mesh) as dec:
        pcm = dec.read_all_device()
    torch.cuda.synchronize()
    assert pcm.device == mesh[0]
    np.testing.assert_array_equal(pcm.cpu().numpy().reshape(-1), inter)
    assert kernels.LAUNCHES["predict_lpc"] > n0


# every encode mode, as BatchEncoder arguments
GRAPH_MODES = {"frame_packed": {}, **ENCODE_MODES}


def _replays() -> dict:
    """Each captured plan graph's replays so far, by key."""
    return {k: g.replays for k, g in teb.PLAN_GRAPHS.items()}


def _replayed(before: dict) -> dict:
    """The graphs replayed since ``before`` (``_replays()``), with the
    number of replays."""
    return {k: n - before.get(k, 0) for k, n in _replays().items()
            if n != before.get(k, 0)}


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_graphs_eager_and_host_write_the_same_bytes(dev, mode):
    """Three whole 4-frame batches, a short batch of 2 (padded to 4, so
    it replays the same graph) and a partial tail: graph replays,
    ``graphs=False`` and the host encoder write the same bytes."""
    inter, n = _stereo_clip(16, frames=14)
    want = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    kw = dict(batch_frames=4, analysis="f64", device=dev,
              **GRAPH_MODES[mode])
    before = _replays()
    graphs = _encode_on(BatchEncoder, inter, n, 16, 44100, **kw)
    replayed = _replayed(before)
    eager = _encode_on(BatchEncoder, inter, n, 16, 44100, graphs=False,
                       **kw)
    assert graphs == want
    assert eager == want
    assert list(replayed.values()) == [4]
    assert _replayed(before) == replayed


def test_f32_with_graphs_verifies(dev):
    inter, n = _stereo_clip(16, frames=14)
    data = _encode_on(BatchEncoder, inter, n, 16, 44100, batch_frames=4,
                      analysis="f32", device=dev)
    assert verify(io.BytesIO(data)) == Verified.MD5_MATCH


def test_two_shards_on_one_card_replay_two_graphs(dev):
    """cuda:0 listed twice: a graph per shard stream, the host encoder's
    bytes; the short batch's second shard holds only padding and is not
    planned."""
    mesh = batch_mesh([dev, dev])
    inter, n = _stereo_clip(16, frames=14)
    want = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    before = _replays()
    got = _encode_on(BatchEncoder, inter, n, 16, 44100, batch_frames=6,
                     analysis="f64", mesh=mesh)
    replayed = _replayed(before)
    assert got == want
    graphs = {teb.PLAN_GRAPHS[k].stream: r for k, r in replayed.items()}
    s0, s1 = shard_streams(mesh)
    assert graphs == {s0: 3, s1: 2}


def test_two_option_sets_interleaved_on_one_stream(dev):
    """Three live encoders batch by batch on one stream: two option sets
    (two graphs) and the first set twice (one graph, two users); each
    writes its own host encoder's bytes."""
    inter, n = _stereo_clip(16, frames=10)
    opts = (Options.best(), Options.best().with_max_lpc_order(8),
            Options.best())
    wants, bufs, encs = [], [], []
    for o in opts:
        for out, cls, kw in ((wants, FlacSampleWriter, {}),
                             (bufs, BatchEncoder, dict(
                                 batch_frames=2, analysis="f64",
                                 device=dev))):
            buf = io.BytesIO()
            enc = cls(buf, o, 44100, 16, 2, total_samples=n, **kw)
            if cls is FlacSampleWriter:
                enc.write(inter)
                enc.finalize()
            else:
                encs.append(enc)
            out.append(buf)
    before = _replays()
    step = 2 * 4096 * 2
    for lo in range(0, len(inter), step):
        for enc in encs:
            enc.write(inter[lo:lo + step])
    for enc in encs:
        enc.finalize()
    replayed = _replayed(before)
    assert [b.getvalue() for b in bufs] == [w.getvalue() for w in wants]
    assert sorted(replayed.values()) == [5, 10]


def test_launches_count_each_replay(dev):
    """LAUNCHES after an encode is the captured tally once per replay,
    plus once for the warm-up where the graph was captured here."""
    inter, n = _stereo_clip(16, frames=10)
    before = _replays()
    kernels.reset_launches()
    _encode_on(BatchEncoder, inter, n, 16, 44100, batch_frames=3,
               analysis="f64", device=dev)
    launches = dict(kernels.LAUNCHES)
    (key, replays), = _replayed(before).items()
    tally = teb.PLAN_GRAPHS[key].tally
    assert replays == 4
    assert tally == {**dict.fromkeys(tally, 0), "autocorr_levinson": 1,
                     "pack_symbols": 2, "splice_subframes": 1}
    runs = replays + (key not in before)
    assert launches == {k: runs * t for k, t in tally.items()}


def _card_leaves(plan: dict, rows: int) -> dict:
    """A plan's leaves on the host, one row per frame (the residual blob
    without its two trailing words)."""
    out = {}
    for k, v in plan_to_numpy(plan).items():
        if k == "channels":
            for s, ch in enumerate(v):
                out.update({f"{s}.{ck}": cv.reshape(rows, -1)
                            for ck, cv in ch.items()})
        elif k != "packed_meta":
            out[k] = (v[:-2] if k == "packed_words" else v).reshape(rows,
                                                                   -1)
    return out


@pytest.mark.parametrize("pad", ["silence", "full_scale_noise"])
@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_padding_rows_leave_real_rows_unchanged_on_card(dev, mode, pad):
    """3 real frames and 5 padding frames through a captured graph: the
    replay equals the eager plan of the same batch, and its real rows
    equal the eager plan of the 3 frames alone, flags included (silence
    takes the autocorrelation's 0/0 path, noise the verbatim
    fallback)."""
    B, padded = 3, 8
    inter, _ = _stereo_clip(16, frames=B)
    real = np.ascontiguousarray(inter[:B * 4096 * 2].reshape(B, 4096, 2)
                                .transpose(0, 2, 1)).astype(np.int16)
    pcm = np.zeros((padded, 2, 4096), np.int16)
    pcm[:B] = real
    if pad == "full_scale_noise":
        pcm[B:] = np.random.default_rng(8).integers(
            -(1 << 15), 1 << 15, (padded - B, 2, 4096))
    budget = {"plan_tree": 0}.get(mode, 18)
    kw = dict(bits_per_sample=16, block_size=4096, max_lpc_order=12,
              max_partition_order=6, mid_side=True, exhaustive=True,
              window_kind=("tukey", 0.5), analysis="f64",
              pack_budget=budget, frame_pack=mode == "frame_packed")
    stream = shard_streams(batch_mesh([dev]))[0]
    graph = teb.plan_graph(pcm.shape, torch.int16, stream, **kw)
    replay = graph.replay(torch.as_tensor(pcm).to(dev))
    stream.synchronize()
    got = _card_leaves(replay, padded)
    eager = _card_leaves(teb.encode_frames_plan(
        torch.as_tensor(pcm).to(dev), **kw), padded)
    alone = _card_leaves(teb.encode_frames_plan(
        torch.as_tensor(real).to(dev), **kw), B)
    assert sorted(got) == sorted(eager) == sorted(alone)
    for k in got:
        np.testing.assert_array_equal(got[k], eager[k], k)
        np.testing.assert_array_equal(got[k][:B], alone[k], k)


def _lpc_rows(rng, orders, N, sample_bits=23):
    """Bounded samples through a forward predictor scaled to a random
    shift in 0-15, so residuals fit int32; order-0 rows pass through."""
    R = len(orders)
    y = rng.integers(-(1 << sample_bits), 1 << sample_bits, (R, N))
    shift = rng.integers(0, 16, R)
    lim = np.minimum(2 << shift, (1 << 14) - 1)[:, None]
    q = rng.integers(-lim, lim + 1, (R, 32))
    q[np.arange(32)[None, :] >= np.asarray(orders)[:, None]] = 0
    acc = np.zeros((R, N), np.int64)
    for j in range(min(32, N - 1)):
        acc[:, j + 1:] += q[:, j:j + 1] * y[:, :N - 1 - j]
    x = np.where(np.arange(N)[None, :] >= np.asarray(orders)[:, None],
                 y - (acc >> shift[:, None]), y)
    return [x.astype(np.int32), q.astype(np.int32), shift.astype(np.int32),
            np.asarray(orders, np.int32)], y


@pytest.mark.parametrize("taps", TAP_BUCKETS)
@pytest.mark.parametrize("R,N", [(512, 4096), (37, 1000), (1, 17),
                                 (33, 23), (6, 25), (5, 4), (40, 1001)])
def test_predict_lpc_kernel_matches_plain(dev, taps, R, N):
    """Every tap bucket, rows that do not fill a warp, lengths below and
    not a multiple of the unrolled chunk (16, 24 or 32 steps), odd
    lengths (no 16-byte accesses), order-0 rows and full-order rows."""
    rng = np.random.default_rng(taps * R + N)
    orders = rng.integers(0, taps + 1, R)
    orders[0] = taps
    if R > 1:
        orders[1] = 0
    arrays, y = _lpc_rows(rng, orders, N)
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    n0 = kernels.LAUNCHES["predict_lpc"]
    got = predict_lpc(*args, taps)
    want = predict_batch_plain(*args, taps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["predict_lpc"] == n0 + 1
    assert got.dtype == torch.int64 and got.shape == (R, N)
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), y)


@pytest.mark.parametrize("taps", TAP_BUCKETS)
def test_predict_lpc_kernel_shift_semantics(dev, taps):
    """Orders past N, order 0 and order = taps in one batch, shifts -3,
    64 and 70 (sign bits only; those rows take the int64 path), and
    residuals read from a pointer that is not 16-byte aligned."""
    rng = np.random.default_rng(40 + taps)
    N = 48
    orders = np.array([0, taps, N + 7, taps, 1, taps // 2, taps, 0])
    arrays, _ = _lpc_rows(rng, orders, N, sample_bits=20)
    arrays[2] = np.array([-3, 64, 70, 2, 0, 63, 5, 70], np.int32)
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    want = predict_batch_plain(*args, taps)
    slow = torch.zeros(1, dtype=torch.int32, device=dev)
    assert torch.equal(predict_lpc(*args, taps, slow_rows=slow), want)
    # shifts -3, 64 and 70 read as 63, past 51: the int64 path
    assert int(slow) == int(int64_rows(want, args[1], args[2], taps).sum())
    flat = torch.zeros(args[0].numel() + 1, dtype=torch.int32, device=dev)
    flat[1:] = args[0].reshape(-1)
    shifted = flat[1:].view(args[0].shape)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(predict_lpc(shifted, *args[1:], taps), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("taps", TAP_BUCKETS)
@pytest.mark.parametrize("N", [4096, 1001, 256])
def test_predict_lpc_kernel_int32_edge(dev, taps, N):
    """Rows that leave int32 mid-row and come back, leave in the last
    chunk or the first, or sit at -2^31 and 2^31 - 1 without leaving
    (``chip_smoke.INT32_EDGE_CASES``, those with order <= taps), among
    seeded ordinary rows: bit-exact with the plain version, and exactly
    the rows that leave int32 take the int64 path."""
    x, q, shift, order, y = int32_edge_rows(N)
    keep = order <= taps
    rng = np.random.default_rng(taps + N)
    orders = rng.integers(0, taps + 1, 45)
    arrays, ry = _lpc_rows(rng, orders, N)
    arrays = [np.concatenate([a[keep], b])
              for a, b in zip((x, q, shift, order), arrays)]
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    slow = torch.zeros(1, dtype=torch.int32, device=dev)
    got = predict_lpc(*args, taps, slow_rows=slow)
    want = predict_batch_plain(*args, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), np.concatenate([y[keep], ry]))
    assert int(slow) == int(int64_rows(want, args[1], args[2], taps).sum()) > 0


def test_predict_lpc_refuses_mixed_devices(dev):
    x = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    q = torch.zeros((2, 32), dtype=torch.int32)
    s = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="different devices"):
        predict_lpc(x, q, s, s, 4)


@pytest.mark.parametrize("bps,channels,block,wasted,order", [
    (16, 2, 4096, 0, 12), (24, 2, 1152, 0, 12), (16, 1, 4608, 0, 32),
    (24, 8, 1024, 3, 12), (20, 6, 1024, 0, 8)])
def test_batch_decoder_on_card_is_lossless(dev, bps, channels, block, wasted,
                                           order):
    """LPC streams through the kernel: stereo, mono at order 32, eight
    channels with wasted bits, six channels."""
    rng = np.random.default_rng(bps + channels)
    n = block * 9 + 333
    t = np.arange(n)
    amp = 1 << (bps - 3 - wasted)
    inter = (np.stack([amp * np.sin(t * (0.01 + 0.003 * c))
                       + rng.integers(-99, 99, n) for c in range(channels)]
                      ).T.reshape(-1).astype(np.int32) << wasted)
    buf = io.BytesIO()
    opts = Options.best().with_block_size(block).with_max_lpc_order(order)
    enc = FlacSampleWriter(buf, opts, 48000, bps, channels, total_samples=n)
    enc.write(inter)
    enc.finalize()
    n0 = kernels.LAUNCHES["predict_lpc"]
    with BatchDecoder(io.BytesIO(buf.getvalue()), batch_frames=4,
                      device=dev) as dec:
        pcm = dec.read_all_device()
        assert dec.device_frames == 9 and dec.host_frames == 1
    assert pcm.device.type == "cuda" and pcm.dtype == torch.int32
    assert kernels.LAUNCHES["predict_lpc"] > n0
    assert np.array_equal(pcm.cpu().numpy().reshape(-1), inter)
    with FlacSampleReader(io.BytesIO(buf.getvalue())) as r:
        assert np.array_equal(r.read_to_end(), inter)


def _encode(inter, opts, rate, bps, channels, n):
    buf = io.BytesIO()
    enc = FlacSampleWriter(buf, opts, rate, bps, channels, total_samples=n)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue()


def _signal(rng, n, channels, bps, wasted=0, noise=99):
    t = np.arange(n)
    amp = 1 << (bps - 3 - wasted)
    noise = min(noise, amp // 2)
    return (np.stack([amp * np.sin(t * (0.01 + 0.003 * c))
                      + rng.integers(-noise, noise + 1, n)
                      for c in range(channels)]).T.reshape(-1)
            .astype(np.int32) << wasted)


def _parse_inputs(data, dev, frames=256):
    """The native scan of a stream's first ``frames`` frames as the
    inputs of parse_frame_bodies on ``dev``, and the native raw parse."""
    dec = Decoder(io.BytesIO(data))
    si = dec.streaminfo
    view = dec.r.np_view()
    nat = native.load()
    args = (view, dec.r.pos, frames, si.sample_rate, si.channels,
            si.bits_per_sample, si.maximum_block_size, dec.total_samples)
    scan, raw = nat.scan_frames(*args), nat.parse_frames_raw(*args)
    assert scan["n"] == raw["n"] > 0
    t = [torch.as_tensor(view.copy()),
         torch.as_tensor(scan["body_off"].astype(np.int64)),
         torch.as_tensor(scan["body_bytes"].astype(np.int32) * 8),
         torch.as_tensor(scan["assignment"].astype(np.int32))]
    return ([x.to(dev) for x in t] + [si.maximum_block_size, si.channels,
                                      si.bits_per_sample], raw)


def _k4_matches_plain(args):
    n0 = kernels.LAUNCHES["parse_frame_bodies"]
    got = tfs.parse_frame_bodies(*args)
    want = tfs.parse_frame_bodies_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["parse_frame_bodies"] == n0 + 1
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
    return got


@pytest.mark.parametrize("bps,channels,block,wasted,opts", [
    (16, 2, 4096, 0, Options.best()),
    (24, 2, 1152, 0, Options.best()),                 # rice2
    (16, 8, 1024, 2, Options.best()),                 # wasted bits
    (20, 6, 576, 0, Options.best().with_max_lpc_order(32)),
    (16, 1, 4608, 0, Options.fast()),                 # FIXED
    (8, 2, 192, 0, Options(block_size=192)),
])
def test_parse_frame_bodies_kernel_matches_plain(dev, bps, channels, block,
                                                 wasted, opts):
    """K4 against its plain version and the native raw parse."""
    rng = np.random.default_rng(bps * channels + block)
    n = block * 7 + 5
    data = _encode(_signal(rng, n, channels, bps, wasted),
                   opts.with_block_size(block), 48000, bps, channels, n)
    args, raw = _parse_inputs(data, dev)
    got = _k4_matches_plain(args)
    assert bool(got["ok"].all())
    for key in ("buf", "order", "shift", "wasted", "qcoeffs"):
        assert np.array_equal(got[key].cpu().numpy(),
                              raw[key].astype(np.int32)), key


def test_parse_frame_bodies_kernel_flags_like_plain(dev):
    """Damaged and garbage bodies: ok and every output as the plain
    version has them (zeros where not ok)."""
    rng = np.random.default_rng(11)
    n = 256 * 40
    data = _encode(_signal(rng, n, 2, 16, noise=3000),
                   Options.best().with_block_size(256), 44100, 16, 2, n)
    args, _ = _parse_inputs(data, dev)
    bad = 0
    for t in range(8):
        d = args[0].clone()
        flips = torch.as_tensor(rng.integers(0, d.shape[0], 30), device=dev)
        d[flips] ^= torch.as_tensor(1 << rng.integers(0, 8, 30),
                                    dtype=torch.uint8, device=dev)
        got = _k4_matches_plain([d, *args[1:]])
        bad += int((~got["ok"]).sum())
    assert bad > 0
    L, B = 5000, 64
    garbage = [torch.as_tensor(rng.integers(0, 256, L), dtype=torch.uint8),
               torch.as_tensor(rng.integers(-8, L, B), dtype=torch.int64),
               torch.as_tensor(rng.integers(-8, 4000, B), dtype=torch.int32),
               torch.as_tensor(rng.integers(0, 11, B), dtype=torch.int32)]
    _k4_matches_plain([x.to(dev) for x in garbage] + [32, 2, 16])


@pytest.mark.parametrize("name", WINDOW_EDGE_CASES)
def test_parse_frame_bodies_kernel_window_edges(dev, name):
    """Rice partitions at the edges of K4's 1024-bit windows
    (``chip_smoke.window_edge_stream``): K4 against its plain version, ok
    included, and against the native raw parse on the bodies that
    parse."""
    args, raw, ok = window_edge_inputs(name, dev)
    assert parses_as_built(_k4_matches_plain(args), raw, ok)


def test_parse_frame_bodies_kernel_unary_limit(dev):
    """Unary runs of MAX_Q and MAX_Q + 1 zeros (the second not ok)."""
    bodies = []
    for zeros in (tfs.MAX_Q, tfs.MAX_Q + 1):
        w = BitWriter()
        w.write(8 << 1, 8)              # FIXED order 0, one partition, k 0
        w.write(0, 10)
        w.write_unary(zeros)
        for _ in range(15):
            w.write_unary(1)
        bodies.append((w.bit_count, w))
        w.byte_align()
    data = b"".join(w.getvalue() for _, w in bodies)
    args = [torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev),
            torch.tensor([0, len(bodies[0][1].getvalue())], device=dev),
            torch.tensor([n for n, _ in bodies], dtype=torch.int32,
                         device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev), 16, 1, 16]
    got = _k4_matches_plain(args)
    assert got["ok"].tolist() == [True, False]


@pytest.mark.parametrize("bps,channels,block", [(16, 2, 4096), (24, 2, 1152),
                                                (16, 8, 1024)])
def test_batch_decoder_device_parse_on_card_is_lossless(dev, bps, channels,
                                                        block):
    rng = np.random.default_rng(bps + 7 * channels)
    n = block * 9 + 333
    inter = _signal(rng, n, channels, bps)
    data = _encode(inter, Options.best().with_block_size(block), 48000, bps,
                   channels, n)
    kernels.reset_launches()
    captured = set(tfs.PARSE_GRAPHS)
    with BatchDecoder(io.BytesIO(data), batch_frames=4, device=dev,
                      device_parse=True) as dec:
        pcm = dec.read_all_device()
        assert (dec.device_frames, dec.host_frames) == (9, 1)
        assert dec.parse_fallbacks == 1          # the short tail
    # three replays, and the warm-up of a graph captured here
    assert kernels.LAUNCHES["parse_frame_bodies"] == 3 + len(
        set(tfs.PARSE_GRAPHS) - captured)
    assert kernels.LAUNCHES["predict_lpc"] > 0
    assert pcm.device.type == "cuda"
    assert np.array_equal(pcm.cpu().numpy().reshape(-1), inter)


def test_eight_channel_24_bit_block_16384_encodes_on_card(dev):
    """A 420 KB frame slot (8 channels, 24 bits, block 16384; past one
    block's shared memory): byte-identical to the host encoder in f64, and
    lossless back through both parse paths."""
    rng = np.random.default_rng(16384)
    n = 16384 * 3 + 500
    inter = _signal(rng, n, 8, 24, noise=999)
    opts = Options.best().with_block_size(16384)
    host = _encode(inter, opts, 96000, 24, 8, n)
    kernels.reset_launches()
    buf = io.BytesIO()
    enc = BatchEncoder(buf, opts, 96000, 24, 8, total_samples=n,
                       batch_frames=4, analysis="f64", device=dev)
    enc.write(inter)
    enc.finalize()
    assert kernels.LAUNCHES["splice_subframes"] > 0
    assert enc.device_frames == 3 and enc.fallback_frames == 0
    assert buf.getvalue() == host
    for device_parse in (False, True):
        with BatchDecoder(io.BytesIO(host), batch_frames=4, device=dev,
                          device_parse=device_parse) as dec:
            pcm = dec.read_all_device()
        assert np.array_equal(pcm.cpu().numpy().reshape(-1), inter)


def _decode_replays() -> dict:
    """Each decode graph's replays so far, by ("parse" or "reconstruct",
    *its key)."""
    out = {("parse",) + k: g.replays for k, g in tfs.PARSE_GRAPHS.items()}
    out.update({("reconstruct",) + k: g.replays
                for k, g in tbd.RECONSTRUCT_GRAPHS.items()})
    return out


def _decode_replayed(before: dict) -> dict:
    """Replays since ``before``, summed by kind."""
    out = {"parse": 0, "reconstruct": 0}
    for k, n in _decode_replays().items():
        out[k[0]] += n - before.get(k, 0)
    return out


def _decode(data, dev, **kw):
    with BatchDecoder(io.BytesIO(data), batch_frames=4, device=dev,
                      **kw) as dec:
        pcm = dec.read_all_device()
        frames = (dec.device_frames, dec.host_frames)
    return pcm, frames


@pytest.mark.parametrize("device_parse", [False, True])
@pytest.mark.parametrize("bps,rate", [(16, 44100), (24, 96000)])
def test_decode_graphs_and_eager_give_the_same_pcm(dev, bps, rate,
                                                   device_parse):
    """Batches of 4, 4 and 1 frames (the last padded to 4) and a host
    tail: graph replays, ``graphs=False`` and the input agree, and each
    device batch was one reconstruct replay (and one parse replay when
    the device parsed it)."""
    inter, n = _stereo_clip(bps)
    data = _encode_on(FlacSampleWriter, inter, n, bps, rate)
    before = _decode_replays()
    got, frames = _decode(data, dev, device_parse=device_parse)
    replayed = _decode_replayed(before)
    before = _decode_replays()
    eager, eager_frames = _decode(data, dev, device_parse=device_parse,
                                  graphs=False)
    assert _decode_replayed(before) == {"parse": 0, "reconstruct": 0}
    assert frames == eager_frames == (9, 1)
    assert replayed == {"parse": 3 if device_parse else 0,
                        "reconstruct": 3}
    assert got.device.type == "cuda" and torch.equal(got, eager)
    assert np.array_equal(got.cpu().numpy().reshape(-1), inter)


@pytest.mark.parametrize("bps", [16, 24])
def test_multi_stream_graphs_and_eager_give_the_same_pcm(dev, bps):
    """Three streams of 9, 9 and 3 whole frames (and a host tail each)
    in batches of 4: 6 device batches, each one parse and one
    reconstruct replay; graph replays, ``graphs=False`` and the inputs
    agree, and the padding is zero."""
    clips = [_stereo_clip(bps, frames) for frames in (9, 9, 3)]
    data = [_encode_on(FlacSampleWriter, inter, n, bps, 44100)
            for inter, n in clips]
    before = _decode_replays()
    dec = tbd.MultiStreamDecoder(4, device=dev)
    got, lengths = dec.decode([io.BytesIO(d) for d in data])
    replayed = _decode_replayed(before)
    eager, eager_lengths = tbd.MultiStreamDecoder(
        4, device=dev, graphs=False).decode([io.BytesIO(d) for d in data])
    assert replayed == {"parse": 6, "reconstruct": 6}
    assert (dec.device_batches, dec.batch_streams, dec.host_frames) == \
        (6, 8, 3)
    assert got.device.type == "cuda" and torch.equal(got, eager)
    assert torch.equal(lengths, eager_lengths)
    for u, (inter, n) in enumerate(clips):
        assert int(lengths[u]) == n
        assert np.array_equal(got[u, :, :n].T.cpu().numpy().reshape(-1),
                              inter)
        assert not got[u, :, n:].any()


def test_decode_graphs_two_shards_on_one_card(dev):
    """cuda:0 listed twice: a reconstruct graph per shard stream; the
    1-frame batch's second shard holds only padding and is skipped."""
    mesh = batch_mesh([dev, dev])
    inter, n = _stereo_clip(16)
    data = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    before = _decode_replays()
    got, frames = _decode(data, None, mesh=mesh)
    streams = {}
    for k, r in _decode_replays().items():
        if r != before.get(k, 0):
            s = tbd.RECONSTRUCT_GRAPHS[k[1:]].stream
            streams[s] = streams.get(s, 0) + r - before.get(k, 0)
    eager, _ = _decode(data, None, mesh=mesh, graphs=False)
    s0, s1 = shard_streams(mesh)
    assert streams == {s0: 3, s1: 2}
    assert frames == (9, 1)
    assert got.device == mesh[0] and torch.equal(got, eager)
    assert np.array_equal(got.cpu().numpy().reshape(-1), inter)


@pytest.mark.parametrize("device_parse", [False, True])
def test_read_batch_device_results_outlive_later_batches(dev, device_parse):
    """Two consecutive batches of one graph stay distinct and right after
    a third batch replays the same graph: the decoder hands out copies
    of the static output, never the output itself."""
    inter, n = _stereo_clip(16, frames=13)
    data = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    with BatchDecoder(io.BytesIO(data), batch_frames=4, device=dev,
                      device_parse=device_parse) as dec:
        a, _ = dec.read_batch_device()
        b, _ = dec.read_batch_device()
        c, _ = dec.read_batch_device()
        torch.cuda.synchronize()
    frames = inter[:4096 * 12 * 2].reshape(12, 4096, 2).transpose(0, 2, 1)
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    for got, want in ((a, frames[:4]), (b, frames[4:8]), (c, frames[8:])):
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("device_parse", [False, True])
def test_consumer_on_a_side_stream_reads_the_pcm(dev, device_parse):
    """The caller's current stream is a side stream: it waits for the
    decoder's stream, so what it computes on each batch is right."""
    inter, n = _stereo_clip(24)
    data = _encode_on(FlacSampleWriter, inter, n, 24, 96000)
    side = torch.cuda.Stream()
    sums = []
    with torch.cuda.stream(side):
        with BatchDecoder(io.BytesIO(data), batch_frames=4, device=dev,
                          device_parse=device_parse) as dec:
            while (got := dec.read_batch_interleaved()) is not None:
                sums.append(got.to(torch.int64).sum(0))
        total = torch.stack(sums).sum(0).cpu()
    want = inter.reshape(-1, 2).astype(np.int64).sum(0)
    assert total.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# One memory pool per stream
# ---------------------------------------------------------------------------

def _stream_graphs(stream) -> list:
    """Every plan, parse and reconstruct graph captured on ``stream``."""
    return [g for g in [*teb.PLAN_GRAPHS.values(), *tfs.PARSE_GRAPHS.values(),
                        *tbd.RECONSTRUCT_GRAPHS.values()]
            if g.stream.cuda_stream == stream.cuda_stream
            and g.stream.device == stream.device]


@pytest.mark.parametrize("device_parse", [False, True])
def test_graphs_in_turns_on_one_stream_share_a_pool(dev, device_parse):
    """Two plan configurations and a decode configuration replayed in
    turns on one stream (A, B, A, decode, B), all captured into the
    stream's one pool: the bytes and samples of ``graphs=False``."""
    from flac_codec_tpu_torch import graphs

    inter, n = _stereo_clip(16, frames=8)
    opts = (Options.best(), Options.best().with_max_lpc_order(8))
    data = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    outs = {}
    for use_graphs in (True, False):
        bufs, encs = [], []
        for o in opts:
            buf = io.BytesIO()
            encs.append(BatchEncoder(buf, o, 44100, 16, 2, total_samples=n,
                                     batch_frames=2, analysis="f64",
                                     device=dev, graphs=use_graphs))
            bufs.append(buf)
        step = 2 * 4096 * 2
        a, b = encs
        with BatchDecoder(io.BytesIO(data), batch_frames=4, device=dev,
                          device_parse=device_parse,
                          graphs=use_graphs) as dec:
            a.write(inter[:step])
            b.write(inter[:step])
            a.write(inter[step:2 * step])
            pcm, _ = dec.read_batch_device()
            b.write(inter[step:2 * step])
            a.write(inter[2 * step:])
            b.write(inter[2 * step:])
        for enc in encs:
            enc.finalize()
        torch.cuda.synchronize()
        outs[use_graphs] = ([buf.getvalue() for buf in bufs], pcm.cpu())
    assert outs[True][0] == outs[False][0]
    assert outs[True][0][0] == data
    assert torch.equal(outs[True][1], outs[False][1])
    frames = inter[:4096 * 4 * 2].reshape(4, 4096, 2).transpose(0, 2, 1)
    assert np.array_equal(outs[True][1].numpy(), frames)
    stream = shard_streams(batch_mesh([dev]))[0]
    made = _stream_graphs(stream)
    assert len(made) >= 3 + device_parse
    assert {g.pool for g in made} == {graphs.stream_pool(stream)}


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a plan's leaves."""
    seen = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(tree)
    return sum(seen.values())


def test_a_smaller_capture_reuses_the_pool_of_a_larger(dev):
    """On a stream whose pool holds a larger graph, a second capture
    grows memory_reserved by no more than its static outputs plus 64
    MiB (alone on a fresh stream it grows it by more): its temporaries
    take the memory the first graph's left free.  Replayed after the
    larger graph, it plans as the eager planner does."""
    from chip_smoke import fresh_stream
    from flac_codec_tpu_torch import graphs

    kw = dict(bits_per_sample=16, block_size=4096, max_lpc_order=12,
              max_partition_order=6, mid_side=True, exhaustive=True,
              window_kind=("tukey", 0.5), analysis="f64", pack_budget=18,
              frame_pack=True)
    small_kw = {**kw, "max_lpc_order": 8}
    stream = fresh_stream(dev)
    big = teb.PlanGraph((256, 2, 4096), torch.int16, stream, **kw)
    small = teb.PlanGraph((64, 2, 4096), torch.int16, stream, **small_kw)
    alone = teb.PlanGraph((64, 2, 4096), torch.int16, fresh_stream(dev),
                          **small_kw)
    assert big.pool == small.pool == graphs.stream_pool(stream)
    assert alone.pool != big.pool
    limit = _storage_bytes(small.output) + (64 << 20)
    assert small.reserved_bytes <= limit < alone.reserved_bytes
    pcm = torch.as_tensor(np.random.default_rng(3).integers(
        -9999, 9999, (64, 2, 4096)), dtype=torch.int16, device=dev)
    torch.cuda.synchronize()
    big.replay(torch.zeros((256, 2, 4096), dtype=torch.int16, device=dev))
    out = small.replay(pcm)
    stream.synchronize()
    got = _card_leaves(out, 64)
    want = _card_leaves(teb.encode_frames_plan(pcm, **small_kw), 64)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_two_streams_of_one_card_keep_two_pools(dev):
    """cuda:0 listed twice: each shard stream's graphs capture into that
    stream's own pool, and the sharded encoder writes the host encoder's
    bytes (as chip_smoke's phase 15 does at full size)."""
    from flac_codec_tpu_torch import graphs

    mesh = batch_mesh([dev, dev])
    inter, n = _stereo_clip(16, frames=14)
    want = _encode_on(FlacSampleWriter, inter, n, 16, 44100)
    got = _encode_on(BatchEncoder, inter, n, 16, 44100, batch_frames=6,
                     analysis="f64", mesh=mesh)
    assert got == want
    s0, s1 = shard_streams(mesh)
    p0, p1 = graphs.stream_pool(s0), graphs.stream_pool(s1)
    assert p0 != p1
    for s, p in ((s0, p0), (s1, p1)):
        made = _stream_graphs(s)
        assert made and {g.pool for g in made} == {p}


# ---------------------------------------------------------------------------
# Warm-ups inside the stream's pool
# ---------------------------------------------------------------------------

def _pool_segments(pool) -> list:
    """The allocator's segments of ``pool``."""
    return [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == tuple(pool.id)]


def _live_blocks(pool) -> set:
    """The address of each block of ``pool`` that is allocated."""
    live = set()
    for seg in _pool_segments(pool):
        addr = seg["address"]
        for block in seg["blocks"]:
            if block["state"] == "active_allocated":
                live.add(addr)
            addr += block["size"]
    return live


def _in_pool(t: torch.Tensor, pool) -> bool:
    ptr = t.untyped_storage().data_ptr()
    return any(s["address"] <= ptr < s["address"] + s["total_size"]
               for s in _pool_segments(pool))


def _storages(tree) -> set:
    """The address of each distinct storage under a graph's output."""
    out = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.add(v.untyped_storage().data_ptr())
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(tree)
    return out


def _plan_kw(block: int, bps: int, channels: int, analysis: str,
             **opts) -> dict:
    o = Options.best().with_block_size(block)
    for name, v in opts.items():
        o = getattr(o, f"with_{name}")(v)
    return BatchEncoder(io.BytesIO(), o, 44100, bps, channels,
                        analysis=analysis, device="cuda")._plan_kw


def test_a_capture_leaves_only_static_outputs_in_the_pool(dev):
    """After each capture on a stream (a plan graph, a second one whose
    constants its warm-up builds on the first one's free scratch, a
    parse and a reconstruct graph), every block still allocated in the
    stream's pool is a graph's static output: nothing the warm-ups
    allocated outlives them there, and the constants the second graph
    built lie outside the pool."""
    from chip_smoke import fresh_stream
    from flac_codec_tpu_torch import graphs
    from flac_codec_tpu_torch.ops import framepack, lpc

    stream = fresh_stream(dev)
    made = []
    # block 2304 is no other test's: its window and CRC planes are new
    misses = (lpc.window_array.cache_info().misses,
              framepack._crc_planes.cache_info().misses)
    for build in (
            lambda: teb.PlanGraph((64, 2, 4096), torch.int16, stream,
                                  **_plan_kw(4096, 16, 2, "f64")),
            lambda: teb.PlanGraph((16, 2, 2304), torch.int16, stream,
                                  **_plan_kw(2304, 16, 2, "f64")),
            lambda: tfs.ParseGraph(stream, 64, 1 << 20, 4096, 2, 16),
            lambda: tbd.ReconstructGraph(stream, (64, 2, 4096), "lpc", 12)):
        made.append(build())
        torch.cuda.synchronize()
        pool = graphs.stream_pool(stream)
        assert {g.pool for g in made} == {pool}
        outputs = set().union(*(_storages(g.output) for g in made))
        assert _live_blocks(pool) <= outputs
        assert made[-1].peak_bytes >= made[-1].reserved_bytes >= 0
    assert lpc.window_array.cache_info().misses > misses[0]
    assert framepack._crc_planes.cache_info().misses > misses[1]
    card = made[1].input.device
    win = lpc.window_array(("tukey", 0.5), 2304, torch.float64, card)
    planes = framepack._crc_planes(
        framepack.frame_slot_words(2, 2304, 18), str(card))
    assert not _in_pool(win, pool) and not _in_pool(planes, pool)


def test_a_warm_up_on_the_scratch_of_other_graphs_keeps_its_constants(dev):
    """A, B, A, decode, B on one stream, where B's warm-up first builds
    its window and CRC planes while the stream's pool holds A's free
    scratch: every replay of A writes that scratch, and B still writes
    the bytes of ``graphs=False`` and of the host encoder, and the
    decode gives the samples of ``graphs=False``."""
    inter, n = _stereo_clip(16, frames=8)
    opts = (Options.best(), Options.best().with_block_size(2560))
    want = []
    for o in opts:
        buf = io.BytesIO()
        host = FlacSampleWriter(buf, o, 44100, 16, 2, total_samples=n)
        host.write(inter)
        host.finalize()
        want.append(buf.getvalue())
    misses = tlpc.window_array.cache_info().misses
    outs = {}
    for use_graphs in (True, False):
        bufs, encs = [], []
        for o in opts:
            buf = io.BytesIO()
            encs.append(BatchEncoder(buf, o, 44100, 16, 2, total_samples=n,
                                     batch_frames=2, analysis="f64",
                                     device=dev, graphs=use_graphs))
            bufs.append(buf)
        a, b = encs
        step = 2 * 4096 * 2
        with BatchDecoder(io.BytesIO(want[0]), batch_frames=4, device=dev,
                          graphs=use_graphs) as dec:
            a.write(inter[:step])
            b.write(inter[:step])
            a.write(inter[step:2 * step])
            pcm, _ = dec.read_batch_device()
            b.write(inter[step:2 * step])
            a.write(inter[2 * step:])
            b.write(inter[2 * step:])
        for enc in encs:
            enc.finalize()
        torch.cuda.synchronize()
        outs[use_graphs] = ([buf.getvalue() for buf in bufs], pcm.cpu())
        if use_graphs:
            assert tlpc.window_array.cache_info().misses > misses
    assert outs[True][0] == outs[False][0] == want
    assert torch.equal(outs[True][1], outs[False][1])


def test_eight_channel_f32_capture_fits_beside_the_f64_pool(dev):
    """The 8-channel 24-bit block-16384 f32 plan graph, captured after
    the f64 one on the same stream, raises ``max_memory_reserved`` by at
    most 1 GiB above what was reserved before it: its warm-up and
    capture run on the f64 graph's free scratch."""
    from chip_smoke import fresh_stream

    stream = fresh_stream(dev)
    shape = (256, 8, 16384)
    f64 = teb.PlanGraph(shape, torch.int32, stream,
                        **_plan_kw(16384, 24, 8, "f64"))
    f32 = teb.PlanGraph(shape, torch.int32, stream,
                        **_plan_kw(16384, 24, 8, "f32"))
    assert f32.pool is f64.pool
    assert f32.peak_bytes <= 1 << 30, (f64.reserved_bytes, f64.peak_bytes,
                                       f32.reserved_bytes, f32.peak_bytes)
    del f64, f32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
