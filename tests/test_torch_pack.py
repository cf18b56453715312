"""The port's bit packers against the JAX package's, on the CPU.

On the CPU the port's ``pack_symbols`` and ``splice_subframes`` run their
plain PyTorch versions (the CUDA kernels run only on the card; see
``tests/test_torch_cuda.py``).  The JAX side runs its Pallas
kernels in interpret mode, as its own tests do.  Everything here is
integer bit placement, so every comparison is exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from flac_codec_tpu.crc import crc16
from flac_codec_tpu.ops import encode_batch as jeb
from flac_codec_tpu.ops import framepack as jfp
from flac_codec_tpu.ops import packpanel as jpp
from flac_codec_tpu_torch import kernels
from flac_codec_tpu_torch.convert import plan_from_numpy, plan_to_numpy
from flac_codec_tpu_torch.ops import framepack as tfp
from flac_codec_tpu_torch.ops import packpanel as tpp

torch.set_num_threads(2)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(
        np.asarray(a).astype(np.uint32).view(np.int32)))


def _u32(t):
    return t.numpy().view(np.uint32)


def _symbols(seed, rows, n, mean_width=9.5):
    """Disjoint random symbols: cumulative ends, values within width."""
    r = np.random.default_rng(seed)
    widths = np.clip(r.poisson(mean_width, (rows, n)) + 1, 2, 30).astype(
        np.int64)
    ends = np.cumsum(widths, axis=1) + 6
    vals = r.integers(0, 1 << 30, (rows, n)).astype(np.int64) \
        & ((1 << widths) - 1)
    mask = r.random((rows, n)) > 0.05
    return vals, widths, ends, mask


def _port_pack(vals, widths, ends, mask, P):
    c = np.ascontiguousarray
    return tpp.pack_symbols(_i32(vals),
                            torch.as_tensor(c(widths), dtype=torch.int32),
                            torch.as_tensor(c(ends), dtype=torch.int32),
                            torch.as_tensor(c(mask)), P)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_symbols_matches_chunkmerge(seed):
    """Same panels as the JAX package's default packer (one-hot
    chunkmerge) and its Pallas merge pipeline, on non-overflowing rows."""
    N, P = 512, 512
    vals, widths, ends, mask = _symbols(seed, 6, N)
    got, ovf = _port_pack(vals, widths, ends, mask, P)
    assert not ovf.any()
    args = [jnp.asarray(a) for a in (vals, widths, ends, mask)]
    want, jovf = jax.jit(lambda *a: jpp.chunkmerge_panels(*a, P))(*args)
    panels, offs, _ = jax.jit(jpp.chunk_panels)(*args)
    ref = jpp.merge_panels_ref(np.asarray(panels), np.clip(
        np.asarray(offs), 0, P - 2 * jpp.CHUNK_R), P)
    ok = ~np.asarray(jovf)
    assert ok.any()
    np.testing.assert_array_equal(_u32(got)[ok], np.asarray(want)[ok])
    np.testing.assert_array_equal(_u32(got)[ok], ref[ok])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_symbols_permuted_matches_chunkmerge(seed):
    """A column-permuted symbol list packs to the panels of the list in
    order, and to the JAX package's chunkmerge panels: the contract holds
    for symbols in any order.  The flags are bool."""
    N, P = 512, 512
    sym = _symbols(seed, 6, N)
    perm = np.random.default_rng(seed + 50).permutation(N)
    got, ovf = _port_pack(*sym, P)
    pgot, povf = _port_pack(*(a[:, perm] for a in sym), P)
    assert ovf.dtype == povf.dtype == torch.bool and not povf.any()
    np.testing.assert_array_equal(_u32(pgot), _u32(got))
    want, jovf = jax.jit(lambda *a: jpp.chunkmerge_panels(*a, P))(
        *[jnp.asarray(a) for a in sym])
    ok = ~np.asarray(jovf)
    assert ok.any()
    np.testing.assert_array_equal(_u32(pgot)[ok], np.asarray(want)[ok])


def test_pack_symbols_has_no_chunk_span_cap():
    """Dense 32-bit symbols overflow the JAX one-hot chunk window (62
    words per 64 symbols); the port packs them, and its panel equals a
    bit-serial reference."""
    N, P = 256, 512
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 32, (2, N), dtype=np.uint64).astype(np.int64)
    widths = np.full((2, N), 32, np.int64)
    ends = np.cumsum(widths, axis=1) + 5
    mask = np.ones((2, N), bool)
    _, jovf = jpp.chunkmerge_panels(*[jnp.asarray(a) for a in
                                      (vals, widths, ends, mask)], P)
    assert np.asarray(jovf).all()
    got, ovf = _port_pack(vals, widths, ends, mask, P)
    assert not ovf.any()
    for r in range(2):
        bits = "00000" + "".join(format(int(v), "032b") for v in vals[r])
        bits = bits.ljust(P * 32, "0")
        want = np.array([int(bits[i:i + 32], 2) for i in range(0, P * 32, 32)],
                        np.uint32)
        np.testing.assert_array_equal(_u32(got)[r], want)


def test_pack_symbols_fields_match_fields_window():
    """Header fields through the symbol pack equal the JAX package's
    one-hot field window (fields end within its 64 words)."""
    rng = np.random.default_rng(4)
    rows, F = 5, 40
    widths = rng.integers(1, 33, (rows, F)).astype(np.int64)
    ends = np.cumsum(widths, axis=1) + 3
    vals = rng.integers(0, 1 << 32, (rows, F), dtype=np.uint64).astype(
        np.int64) & ((1 << widths) - 1)
    mask = rng.random((rows, F)) > 0.2
    mask &= ends <= 63 * 32
    want = np.asarray(jpp.pack_fields_window(
        jnp.asarray(vals.astype(np.uint32)), jnp.asarray(widths),
        jnp.asarray(ends), jnp.asarray(mask)))
    got, ovf = _port_pack(vals, widths, ends, mask, 128)
    assert not ovf.any()
    np.testing.assert_array_equal(_u32(got)[:, :64], want)
    assert not _u32(got)[:, 64:].any()


def test_pack_symbols_permuted_fields_match_fields_window():
    """Header fields in reverse and in a random order pack to the JAX
    package's one-hot field window."""
    rng = np.random.default_rng(5)
    rows, F = 5, 40
    widths = rng.integers(1, 33, (rows, F)).astype(np.int64)
    ends = np.cumsum(widths, axis=1) + 3
    vals = rng.integers(0, 1 << 32, (rows, F), dtype=np.uint64).astype(
        np.int64) & ((1 << widths) - 1)
    mask = (rng.random((rows, F)) > 0.2) & (ends <= 63 * 32)
    want = np.asarray(jpp.pack_fields_window(
        jnp.asarray(vals.astype(np.uint32)), jnp.asarray(widths),
        jnp.asarray(ends), jnp.asarray(mask)))
    for perm in (np.arange(F)[::-1], rng.permutation(F)):
        got, ovf = _port_pack(*(a[:, perm] for a in (vals, widths, ends,
                                                      mask)), 128)
        assert not ovf.any()
        np.testing.assert_array_equal(_u32(got)[:, :64], want)
        assert not _u32(got)[:, 64:].any()


def test_pack_symbols_flags_outside_and_wide():
    vals = np.array([[1, 3, 1], [1, 1, 1], [5, 1, 1]])
    widths = np.array([[1, 2, 3], [1, 1, 40], [3, 0, 1]])
    ends = np.array([[1, 3, 64 * 32 + 1], [5, 6, 50], [3, -4, 64 * 32]])
    mask = np.array([[True, True, True], [True, True, True],
                     [True, True, True]])
    got, ovf = _port_pack(vals, widths, ends, mask, 64)
    np.testing.assert_array_equal(ovf.numpy(), [True, True, False])
    w = _u32(got)
    assert w[0, 0] == 0b111 << 29           # outside symbol dropped
    assert w[1, 0] == 0b11 << 26            # 40-bit symbol dropped
    assert w[2, 0] == 0b101 << 29 and w[2, 63] == 1   # width 0 is a no-op


def _splice_inputs(seed, B, S, P, max_fill):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_fill, (B, S))
    lens[0, 0] = 32 * 7                     # off % 32 == 0 for slot 1
    panels = np.zeros((B, S, P), np.uint32)
    for b in range(B):
        for s in range(S):
            n = int(lens[b, s])
            bits = rng.integers(0, 2, n)
            bits[0] = bits[-1] = 1
            padded = np.zeros(P * 32, np.int64)
            padded[:n] = bits
            panels[b, s] = (padded.reshape(P, 32)
                            << np.arange(31, -1, -1)).sum(axis=1)
    offs = np.concatenate([np.zeros((B, 1), np.int64),
                           np.cumsum(lens, axis=1)[:, :-1]], axis=1)
    return panels, offs.astype(np.int32)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_splice_matches_pallas_and_ref(S):
    P = 256
    W = (S - 1) * P + P + 192
    panels, offs = _splice_inputs(S, 6, S, P, P * 32 - 1)
    got = tpp.splice_subframes(_i32(panels), torch.as_tensor(offs), W)
    ref = jpp.splice_subframes_ref(panels, offs, W)
    want = np.asarray(jpp.splice_subframes(jnp.asarray(panels),
                                           jnp.asarray(offs), W))
    np.testing.assert_array_equal(_u32(got), ref)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("S,same_offset", [(2, False), (3, False),
                                           (8, False), (4, True)])
def test_splice_adds_overlapping_panels_like_pallas(S, same_offset):
    """Panels whose set bits overlap, at in-range offsets (the Pallas
    kernel clamps others): the plain version adds, wrapping at 32 bits, as
    the Pallas kernel (in interpret mode) and the NumPy reference do; OR
    would give other words."""
    P, B = 128, 5
    W = 2 * P + 128
    rng = np.random.default_rng(40 + S)
    panels = rng.integers(0, 1 << 32, (B, S, P), dtype=np.uint64).astype(
        np.uint32)
    panels[0] = 0xFFFFFFFF                  # every bit set: sums carry
    top = (W - P - 128) * 32                # the Pallas kernel's largest
    offs = rng.integers(0, top + 1, (B, S)).astype(np.int32)
    offs[1, :] = [32 * (s % 3) for s in range(S)]   # word-aligned overlaps
    offs[2, 0] = top
    if same_offset:
        offs[:] = offs[:, :1]
    got = _u32(tpp.splice_subframes(_i32(panels), torch.as_tensor(offs), W))
    ref = jpp.splice_subframes_ref(panels, offs, W)
    want = np.asarray(jpp.splice_subframes(jnp.asarray(panels),
                                           jnp.asarray(offs), W))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)
    ored = np.zeros_like(ref)
    for b in range(B):
        for s in range(S):
            one = np.zeros((B, S, P), np.uint32)
            one[b, s] = panels[b, s]
            ored[b] |= jpp.splice_subframes_ref(one, offs, W)[b]
    assert not np.array_equal(got, ored)


def test_splice_guards_the_slot():
    """Offsets past the slot (fallback frames) drop the words outside it
    instead of writing into the next frame."""
    P, W = 128, 300
    panels = np.full((2, 1, P), 0xFFFFFFFF, np.uint32)
    offs = np.array([[(W - 10) * 32 + 5], [-70]], np.int32)
    got = _u32(tpp.splice_subframes(_i32(panels), torch.as_tensor(offs), W))
    assert got[0, :W - 10].sum() == 0 and got[0, W - 10] == 0x07FFFFFF
    assert (got[0, W - 9:] == 0xFFFFFFFF).all()
    assert (got[1, :P - 3] == 0xFFFFFFFF).all() and got[1, P - 3] == 0xFFFFFFC0
    assert got[1, P - 2:].sum() == 0


def test_wrappers_check_inputs():
    v = torch.zeros((2, 4), dtype=torch.int32)
    m = torch.zeros((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="different devices"):
        tpp.pack_symbols(v, v, v.to("meta"), m, 8)
    with pytest.raises(ValueError, match="different devices"):
        tpp.splice_subframes(torch.zeros((2, 1, 8), dtype=torch.int32),
                             torch.zeros((2, 1), dtype=torch.int32,
                                         device="meta"), 16)
    with pytest.raises(TypeError):
        tpp.pack_symbols(v.long(), v, v, m, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tpp.pack_symbols(v.t().contiguous().t(), v, v, m, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tpp.splice_subframes(torch.zeros((2, 1, 8), dtype=torch.int32,
                                         device="meta"),
                             torch.zeros((2, 1), dtype=torch.int32,
                                         device="meta"), 16)
    before = dict(kernels.LAUNCHES)
    tpp.pack_symbols(v, v, v, m, 8)          # CPU: plain version, no launch
    assert kernels.LAUNCHES == before


def test_crc16_inner_matches_jax_and_bytewise_crc():
    def gfmul(a, b):
        r = 0
        for i in range(16):
            if (b >> i) & 1:
                r ^= a << i
        for i in range(30, 15, -1):
            if (r >> i) & 1:
                r ^= tfp.CRC16_POLY << (i - 16)
        return r

    def xpow8(nbytes):
        r, v = 1, 0x100
        while nbytes:
            if nbytes & 1:
                r = gfmul(r, v)
            v = gfmul(v, v)
            nbytes >>= 1
        return r

    rng = np.random.default_rng(41)
    W, B = 24, 8
    np.testing.assert_array_equal(tfp.crc16_neg_pow_table(W * 32),
                                  jfp.crc16_neg_pow_table(W * 32))
    lengths = rng.integers(1, W * 4 - 3, B)
    slots = np.zeros((B, W), np.uint32)
    msgs = []
    for b in range(B):
        raw = rng.integers(0, 256, W * 4).astype(np.uint8)
        raw[lengths[b]:] = 0
        msgs.append(bytes(raw[:lengths[b]]))
        slots[b] = raw.view(">u4").astype(np.uint32)
    got = tfp.crc16_inner(_i32(slots)).numpy()
    want = np.asarray(jfp.crc16_inner(jnp.asarray(slots),
                                      jfp.crc16_neg_pow_table(W * 32)))
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        assert gfmul(int(got[b]), gfmul(xpow8(int(lengths[b])), 0x8000)) \
            == crc16(msgs[b])


def test_slot_geometry_matches_jax():
    for S, n, budget in ((2, 4096, 18), (2, 4096, 26), (1, 1152, 18),
                         (8, 4096, 18), (2, 16, 34)):
        assert tfp.subframe_panel_words(n, budget) == \
            jfp.subframe_panel_words(n, budget)
        assert tfp.frame_slot_words(S, n, budget) == \
            jfp.frame_slot_words(S, n, budget)
    assert tfp.subframe_panel_words(4096, 18) == 2688
    assert tfp.frame_slot_words(2, 4096, 18) == 5248


_PACK_CASES = {
    # name: (channels, bps, block, signal)
    "stereo16": (2, 16, 512, "music"),
    "stereo24": (2, 24, 256, "music"),
    "stereo16_noise": (2, 16, 256, "noise"),
    "stereo32_escapes": (2, 32, 256, "impulses"),
    # full-scale bursts coded as Rice k=30: denser than the JAX one-hot
    # chunk window (62 words per 64 symbols), so only JAX falls back
    "stereo32_burst": (2, 32, 2048, "burst"),
}


def _pcm(kind, C, bps, n, B, rng):
    t = np.arange(B * n).reshape(B, 1, n)
    lim = 1 << (bps - 1)
    if kind == "noise":
        return rng.integers(-lim, lim, (B, C, n)).astype(np.int64)
    if kind == "burst":
        x = rng.integers(-3, 4, (B, C, n))
        x[:, :, 64:576] = rng.integers(-lim, lim, (B, C, 512))
        return x
    if kind == "impulses":
        x = np.where(t % 7 == 0, lim - 1, 0) * np.ones((1, C, 1), np.int64)
        x[:, :, ::5] = -lim
        return x + rng.integers(-3, 4, (B, C, n))
    f = rng.uniform(0.003, 0.05, (B, C, 1))
    return ((lim >> 3) * np.sin(t * f)
            + rng.integers(-(lim >> 9), lim >> 9, (B, C, n))).astype(np.int64)


def _check_pack_frame_bodies(case):
    """The port's pack_frame_bodies against the JAX package's on the same
    JAX plan (see test_pack_frame_bodies_matches_jax_on_same_plan)."""
    C, bps, n, kind = _PACK_CASES[case]
    rng = np.random.default_rng(12)
    pcm = _pcm(kind, C, bps, n, 2 if kind == "burst" else 4, rng)
    if bps == 32:
        pcm = np.clip(pcm, -(1 << 31), (1 << 31) - 1)
    kw = dict(bits_per_sample=bps, block_size=n, max_lpc_order=8,
              max_partition_order=4, analysis="f64")
    plan = jax.tree_util.tree_map(np.asarray, jeb.encode_frames_plan(
        jnp.asarray(pcm.astype(np.int32)), **kw))
    budget = bps + 2
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jfp.pack_frame_bodies(p, n, bps, budget))(
            jax.tree_util.tree_map(jnp.asarray, plan)))
    got = plan_to_numpy(tfp.pack_frame_bodies(
        plan_from_numpy(plan, "cpu"), n, bps, budget))

    jfb, tfb = want["frame_fallback"], got["frame_fallback"]
    assert not (tfb & ~jfb).any(), "port falls back where JAX does not"
    keep = ~jfb
    B = len(keep)
    np.testing.assert_array_equal(got["body_bits"], want["body_bits"])
    assert got["frame_words"].dtype == np.uint32
    assert got["inner_crc"].dtype == np.uint16
    np.testing.assert_array_equal(
        got["frame_words"].reshape(B, -1)[keep],
        want["frame_words"].reshape(B, -1)[keep])
    np.testing.assert_array_equal(got["inner_crc"][keep],
                                  want["inner_crc"][keep])
    if kind == "music":
        assert keep.all()
    if kind == "burst":
        assert jfb.all() and not tfb.any()


@pytest.mark.parametrize("case", sorted(_PACK_CASES))
def test_pack_frame_bodies_matches_jax_on_same_plan(case):
    """The same JAX plan, handed over with plan_from_numpy, packs to the
    same slots, body lengths and CRC inner products wherever neither
    package falls back; the port falls back on a subset of frames."""
    _check_pack_frame_bodies(case)


@pytest.mark.parametrize("case", ["stereo16", "stereo32_escapes"])
def test_pack_frame_bodies_with_permuted_symbols_matches_jax(case,
                                                             monkeypatch):
    """Every symbol list the frame packer hands pack_symbols (residual
    section and header fields, the fields after the section whose bits
    they precede), packed with its columns in a random order, still gives
    the JAX package's slots."""
    from flac_codec_tpu_torch.ops import bitpack as tbp

    pack = tbp.pack_symbols
    rng = np.random.default_rng(21)
    calls = []

    def permuted(values, widths, ends, mask, P):
        perm = torch.as_tensor(rng.permutation(values.shape[1]))
        calls.append(values.shape)
        return pack(*(a[:, perm].contiguous()
                      for a in (values, widths, ends, mask)), P)

    monkeypatch.setattr(tbp, "pack_symbols", permuted)
    _check_pack_frame_bodies(case)
    assert len(calls) == 2


def test_plan_from_numpy_roundtrip():
    rng = np.random.default_rng(13)
    plan = {"assignment": np.array([1, 8], np.uint8),
            "frame_words": rng.integers(0, 1 << 32, 8, dtype=np.uint64)
            .astype(np.uint32),
            "inner_crc": np.array([0xFFFF, 3], np.uint16),
            "body_bits": np.array([5, 1 << 40], np.int64),
            "frame_fallback": np.array([True, False]),
            "channels": [{"shift": np.array([-3, 4], np.int8),
                          "kinds": np.zeros((2, 64), np.uint8)}]}
    t = plan_from_numpy(plan, "cpu")
    assert t["frame_words"].dtype == torch.int32
    back = plan_to_numpy(t)
    for k in ("assignment", "frame_words", "inner_crc", "body_bits",
              "frame_fallback"):
        assert back[k].dtype == plan[k].dtype, k
        np.testing.assert_array_equal(back[k], plan[k])
    for k, v in plan["channels"][0].items():
        np.testing.assert_array_equal(back["channels"][0][k], v)
