"""The port's frame-body parser (K4's plain version) and its device-parse
decode path on the CPU, held to the JAX package.

Inputs are made from numpy seeds, or are the committed conformance
corpus; every comparison is exact equality.

* ``parse_frame_bodies_plain`` (what ``parse_frame_bodies`` runs for CPU
  tensors) against the JAX ``parse_frame_bodies`` in interpret mode, as
  ``tests/test_framescan.py`` runs it (BS=48, one word-panel width), and
  against the native raw parse ``parse_frames_raw``, also on hand-built
  streams whose Rice partitions meet the CUDA kernel's window edges;
* each construct that makes a body not ``ok``, on hand-built bodies,
  against the JAX function's ``ok``;
* ``parse_gate`` against the JAX gate and ``fixed_compatible_mask``;
* ``BatchDecoder(device="cpu", device_parse=True)`` against the JAX
  ``BatchDecoder(device_parse=True)`` and against every corpus stream's
  ``pcm_md5``.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from chip_smoke import WINDOW_EDGE_CASES, parses_as_built, window_edge_inputs
from flac_codec_tpu.ops import framescan as jfs
from flac_codec_tpu.parallel.batch_decode import BatchDecoder as JaxDecoder
from flac_codec_tpu_torch import native
from flac_codec_tpu_torch.bitio import BitWriter
from flac_codec_tpu_torch.decode import Decoder
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.ops import framescan as tfs
from flac_codec_tpu_torch.ops.predict import fixed_compatible_mask
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder

torch.set_num_threads(2)

BS = 48           # small blocks: interpreter-friendly bit counts
W_BUCKET = 96     # shared word-panel width (one kernel compile)
KEYS = ("buf", "order", "shift", "wasted", "qcoeffs")

CORPUS = os.path.join(os.path.dirname(__file__), "data", "conformance")
with open(os.path.join(CORPUS, "manifest.json")) as _fp:
    MANIFEST = json.load(_fp)


def _stream(kind, n, bps, channels, seed, opts):
    """Seeded PCM through the port's host encoder.  "music": sines and
    noise; "mixed": silence, noise and loud tones in turn, and one channel
    copying the other (constant, verbatim and decorrelated subframes);
    "wasted": music with its low bits zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = 1 << (bps - 3)
    chans = [amp * np.sin(t * (0.03 + 0.01 * c)) + rng.normal(0, amp >> 6, n)
             for c in range(channels)]
    if kind == "mixed":
        seg = (t // BS) % 3
        left = np.where(seg == 0, 0.0, np.where(
            seg == 1, rng.integers(-50, 50, n), 2 * amp * np.sin(t * 0.9)))
        chans = [left, np.where((t // BS) % 2 == 0, left, 77.0)]
    pcm = np.stack(chans, 1).astype(np.int64)
    if kind == "wasted":
        pcm = pcm >> 3 << 3
    lim = (1 << (bps - 1)) - 1
    pcm = np.clip(pcm, -lim - 1, lim).reshape(-1)
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, opts, 44100, bps, channels, total_samples=n)
    w.write(pcm)
    w.finalize()
    return buf.getvalue(), pcm


def _scan(data, frames=10 ** 6):
    """The native scan of a stream, the parser's inputs as CPU tensors,
    and the native raw parse of the same frames."""
    dec = Decoder(io.BytesIO(data))
    si = dec.streaminfo
    view = dec.r.np_view()
    nat = native.load()
    args = (view, dec.r.pos, frames, si.sample_rate, si.channels,
            si.bits_per_sample, si.maximum_block_size, dec.total_samples)
    scan, raw = nat.scan_frames(*args), nat.parse_frames_raw(*args)
    assert scan["n"] == raw["n"] > 0
    inputs = (torch.from_numpy(view.copy()),
              torch.from_numpy(scan["body_off"].astype(np.int64)),
              torch.from_numpy(scan["body_bytes"].astype(np.int32) * 8),
              torch.from_numpy(scan["assignment"].astype(np.int32)),
              si.maximum_block_size, si.channels, si.bits_per_sample)
    return inputs, raw


def _jax_parse(bodies, nbits, assignment, N, C, bps, W=W_BUCKET):
    """The JAX parser in interpret mode on a list of body byte strings."""
    panel = np.zeros((jfs.LANES, W * 4), np.uint8)
    for f, body in enumerate(bodies):
        assert len(body) <= W * 4
        panel[f, :len(body)] = np.frombuffer(body, np.uint8)
    words = np.ascontiguousarray(panel.view(">u4").astype(np.uint32).T)
    lanes = np.zeros((2, jfs.LANES), np.int32)
    lanes[0, :len(bodies)] = nbits
    lanes[1, :len(bodies)] = assignment
    out = jfs.parse_frame_bodies(jnp.asarray(words), jnp.asarray(lanes[0]),
                                 jnp.asarray(lanes[1]), N, C, bps,
                                 interpret=True)
    return {k: np.asarray(v)[:len(bodies)] for k, v in out.items()}


def _port_parse(bodies, nbits, assignment, N, C, bps):
    """The port's parser on the same bodies, laid out as one byte span."""
    offs = np.cumsum([0] + [len(b) for b in bodies])[:-1]
    out = tfs.parse_frame_bodies(
        torch.frombuffer(bytearray(b"".join(bodies)), dtype=torch.uint8),
        torch.as_tensor(offs, dtype=torch.int64),
        torch.as_tensor(nbits, dtype=torch.int32),
        torch.as_tensor(assignment, dtype=torch.int32), N, C, bps)
    return {k: v.numpy() for k, v in out.items()}


_JAX_STREAMS = {
    "mixed16": ("mixed", 16, 2, Options.best()),
    "music24": ("music", 24, 2, Options.best()),
    "six_channels": ("music", 12, 6, Options(block_size=BS)),
    "wasted16": ("wasted", 16, 2, Options.best()),
}


@pytest.mark.parametrize("case", sorted(_JAX_STREAMS))
def test_plain_matches_jax_parse(case):
    kind, bps, channels, opts = _JAX_STREAMS[case]
    data, _ = _stream(kind, BS * 6, bps, channels, 3,
                      opts.no_seektable().with_block_size(BS))
    (d, off, nbits, assign, N, C, bps), raw = _scan(data)
    bodies = [d[o:o + n // 8].numpy().tobytes()
              for o, n in zip(off.tolist(), nbits.tolist())]
    want = _jax_parse(bodies, nbits.numpy(), assign.numpy(), N, C, bps)
    got = {k: v.numpy() for k, v in tfs.parse_frame_bodies(
        d, off, nbits, assign, N, C, bps).items()}
    np.testing.assert_array_equal(got["ok"], want["ok"])
    assert got["ok"].all()
    for key in KEYS:
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key], key)
    if case == "wasted16":
        assert got["wasted"].any()


_NATIVE_STREAMS = {
    "stereo16_best": ("music", 16, 2, Options.best(), 4096),
    "stereo24_1152": ("music", 24, 2, Options.best(), 1152),
    "mixed16_192": ("mixed", 16, 2, Options.best(), 192),
    "eight_channels": ("music", 20, 8, Options.best(), 256),
    "wasted_mono": ("wasted", 12, 1, Options.fast(), 576),
    "order32": ("music", 16, 2, Options.best().with_max_lpc_order(32), 1024),
}


@pytest.mark.parametrize("case", sorted(_NATIVE_STREAMS))
def test_plain_matches_native_raw_parse(case):
    kind, bps, channels, opts, block = _NATIVE_STREAMS[case]
    data, _ = _stream(kind, block * 5 + 7, bps, channels, 4,
                      opts.with_block_size(block))
    inputs, raw = _scan(data)
    got = tfs.parse_frame_bodies(*inputs)
    assert got["ok"].all()
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(),
                                      raw[key].astype(np.int32), key)


@pytest.mark.parametrize("name", WINDOW_EDGE_CASES)
def test_plain_window_edges_match_native_raw_parse(name):
    """Rice partitions at the edges of the CUDA kernel's 1024-bit windows
    (``chip_smoke.window_edge_stream``): ``ok`` as built, every body that
    parses equal to the native raw parse, zeros for a body that does
    not."""
    args, raw, ok = window_edge_inputs(name, torch.device("cpu"))
    got = tfs.parse_frame_bodies(*args)
    assert parses_as_built(got, raw, ok)
    for key in KEYS:
        assert not got[key][~got["ok"]].any(), key


# ---------------------------------------------------------------------------
# Bodies that are not ok
# ---------------------------------------------------------------------------

N_HAND = 24       # block size of the hand-built bodies (two channels)
MAX_Q_HAND = 64   # MAX_Q in both packages for the hand-built bodies


def _rice(w, vals, k):
    for v in vals:
        u = 2 * v if v >= 0 else -2 * v - 1
        w.write_unary(u >> k)
        w.write(u & ((1 << k) - 1), k)


def _residual(w, order, po=0, method=0, k=2, vals=None):
    """Residual section: every partition Rice-coded with parameter k."""
    w.write(method, 2)
    w.write(po, 4)
    plen = N_HAND >> po
    for p in range(1 << po):
        m = plen - order if p == 0 else plen
        w.write(k, 4 + method)
        _rice(w, vals if vals is not None else [(i % 7) - 3
                                                for i in range(m)], k)


def _fixed(w, order=2, bits=16, wasted=0):
    w.write((8 + order) << 1 | (wasted > 0), 8)
    if wasted:
        w.write_unary(wasted - 1)
    for i in range(order):
        w.write_signed(100 * i - 50, bits - wasted)


def _lpc(w, order=2, bits=16, prec_code=9, shift=3):
    w.write((32 + order - 1) << 1, 8)
    for i in range(order):
        w.write_signed(7 * i - 3, bits)
    w.write(prec_code, 4)
    w.write_signed(shift, 5)
    for i in range(order):
        w.write_signed(40 - 30 * i, prec_code + 1)


def _case_escape(w, first=0, last=5):
    """FIXED order 1, two partitions of 12, both escaped: ``first`` and
    ``last`` are their widths (0: all zeros)."""
    _fixed(w, order=1)
    w.write(0, 2)
    w.write(1, 4)
    for width, m in ((first, 11), (last, 12)):
        w.write(15, 4)
        w.write(width, 5)
        for i in range(m if width else 0):
            w.write_signed(i % 5 - 2, width)


def _case_verbatim(w):
    w.write(1 << 1, 8)
    for i in range(N_HAND):
        w.write_signed(1000 - 97 * i, 16)


def _case_long_unary(w, zeros):
    _fixed(w, order=0)
    w.write(0, 2)
    w.write(0, 4)
    w.write(0, 4)                       # k = 0: the code is its unary run
    w.write_unary(zeros)
    _rice(w, [1] * (N_HAND - 1), 0)


# name: (channel-1 subframe writer, assignment, ok, bits to cut)
_HAND = {
    "ok_fixed": (lambda w: (_fixed(w), _residual(w, 2, po=1)), 1, True, 0),
    "ok_lpc": (lambda w: (_lpc(w), _residual(w, 2, po=2, k=3)), 1, True, 0),
    "ok_escape": (_case_escape, 1, True, 0),
    "ok_verbatim": (_case_verbatim, 1, True, 0),
    "ok_side_wasted": (lambda w: (_fixed(w, 1, 17, wasted=16),
                                  _residual(w, 1)), 8, True, 0),
    "ok_unary_at_max_q": (lambda w: _case_long_unary(w, MAX_Q_HAND), 1, True,
                          0),
    "pad_bit": (lambda w: (w.write(0x80 | 10 << 1, 8),), 1, False, 0),
    "reserved_type": (lambda w: (w.write(2 << 1, 8),), 1, False, 0),
    "effective_bits_not_positive": (
        lambda w: (_fixed(w, 1, 16, wasted=16), _residual(w, 1)), 1, False,
        0),
    "order_above_block": (lambda w: (w.write(63 << 1, 8),), 1, False, 0),
    "precision_code_15": (lambda w: _lpc(w, 1, prec_code=15), 1, False, 0),
    "negative_shift": (lambda w: _lpc(w, 1, shift=-1), 1, False, 0),
    "method_above_1": (lambda w: (_fixed(w, 0), w.write(2, 2)), 1, False, 0),
    "block_not_divisible": (lambda w: (_fixed(w, 0), w.write(0, 2),
                                       w.write(4, 4)), 1, False, 0),
    "first_partition_empty": (lambda w: (_fixed(w, 3),
                                         _residual(w, 3, po=3)), 1, False, 0),
    "unary_past_max_q": (lambda w: _case_long_unary(w, MAX_Q_HAND + 1), 1,
                         False, 0),
    "rice_quotient_too_large": (lambda w: (
        _fixed(w, 0), w.write(1, 2), w.write(0, 4), w.write(30, 5),
        w.write_unary(2), w.write(0, 30)), 1, False, 0),   # q 2 > 2^30 >> 30
    "body_ends_early": (lambda w: (_fixed(w), _residual(w, 2)), 1, False, 1),
}


def _hand_body(name):
    """Channel 0 a constant subframe, channel 1 the case's subframe;
    nbits is where the parse ends (less the case's cut)."""
    write, assignment, _, cut = _HAND[name]
    w = BitWriter()
    w.write(0, 8)
    w.write_signed(-5, 16)
    write(w)
    nbits = w.bit_count - cut
    w.byte_align()
    return w.getvalue(), nbits, assignment


@pytest.fixture(scope="module")
def hand_parsed():
    """Both parsers over every hand-built body, with MAX_Q lowered to
    MAX_Q_HAND in both packages: the JAX interpreter cannot run bodies of
    2^20 bits (1024 lanes of bit rows), so the unary limit is held against
    JAX at this size; test_plain_unary_limit_at_full_max_q holds the real
    limit."""
    names = sorted(_HAND)
    bodies, nbits, assign = zip(*(_hand_body(n) for n in names))
    mp = pytest.MonkeyPatch()
    mp.setattr(jfs, "MAX_Q", MAX_Q_HAND)
    mp.setattr(tfs, "MAX_Q", MAX_Q_HAND)
    try:
        want = _jax_parse(bodies, nbits, assign, N_HAND, 2, 16, W=32)
        got = _port_parse(bodies, nbits, assign, N_HAND, 2, 16)
    finally:
        mp.undo()
        jax.clear_caches()          # no trace with the lowered MAX_Q stays
    return {n: i for i, n in enumerate(names)}, want, got


@pytest.mark.parametrize("name", sorted(_HAND))
def test_plain_flags_like_jax(hand_parsed, name):
    lane, want, got = hand_parsed
    i = lane[name]
    assert bool(got["ok"][i]) == bool(want["ok"][i]) == _HAND[name][2]
    for key in KEYS:
        if got["ok"][i]:
            np.testing.assert_array_equal(got[key][i], want[key][i], key)
        else:
            assert not got[key][i].any(), key


@pytest.mark.parametrize("first,last", [(3, 0), (5, 5), (7, 3)])
def test_plain_parses_escape_before_another_partition(first, last):
    """An escaped partition followed by another: the samples as written.
    The JAX kernel is not held here: after an escaped partition's last
    sample it reads the next partition header with the escape width
    (``flac_codec_tpu/ops/framescan.py:325`` tests ``cnt > 0`` after
    ``:285`` has reset ``cnt`` for the next partition), so such a body
    fails its parse and the JAX decoder falls back to the host."""
    w = BitWriter()
    w.write(0, 8)
    w.write_signed(-5, 16)
    _case_escape(w, first, last)
    nbits = w.bit_count
    w.byte_align()
    got = _port_parse([w.getvalue()], [nbits], [1], N_HAND, 2, 16)
    want = [-50] + [i % 5 - 2 if first else 0 for i in range(11)] \
        + [i % 5 - 2 if last else 0 for i in range(12)]
    assert got["ok"][0]
    assert got["buf"][0, 1].tolist() == want
    assert got["buf"][0, 0].tolist() == [-5] * N_HAND


def _max_q_bodies():
    """Mono bodies whose first Rice code (k = 0) is a unary run of MAX_Q
    and of MAX_Q + 1 zeros."""
    out = []
    for zeros in (tfs.MAX_Q, tfs.MAX_Q + 1):
        w = BitWriter()
        _case_long_unary(w, zeros)
        nbits = w.bit_count
        w.byte_align()
        out.append((w.getvalue(), nbits))
    return out


def test_plain_unary_limit_at_full_max_q():
    """A unary run of MAX_Q zeros is read; one of MAX_Q + 1 is not ok."""
    bodies, nbits = zip(*_max_q_bodies())
    got = _port_parse(bodies, nbits, [0, 0], N_HAND, 1, 16)
    assert got["ok"].tolist() == [True, False]
    assert got["buf"][0, 0, 0] == tfs.MAX_Q // 2      # zigzag of MAX_Q
    assert (got["buf"][0, 0, 1:] == 1).all()


def test_parse_frame_bodies_rejects_bad_inputs():
    d = torch.zeros(16, dtype=torch.uint8)
    off = torch.zeros(2, dtype=torch.int64)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="nbits must be torch.int32"):
        tfs.parse_frame_bodies(d, off, n.long(), n, 16, 2, 16)
    with pytest.raises(ValueError, match="1-D of one length"):
        tfs.parse_frame_bodies(d, off, n[:1], n, 16, 2, 16)
    with pytest.raises(ValueError, match="out of range"):
        tfs.parse_frame_bodies(d, off, n, n, 16, 2, 32)
    with pytest.raises(ValueError, match="different devices"):
        tfs.parse_frame_bodies(d.to("meta"), off, n, n, 16, 2, 16)


def test_parse_gate_matches_jax_gate_and_fixed_mask():
    data, _ = _stream("mixed", BS * 6, 16, 2, 5,
                      Options.best().no_seektable().with_block_size(BS))
    inputs, _ = _scan(data)
    parsed = tfs.parse_frame_bodies(*inputs)
    B = parsed["ok"].shape[0]
    valid = torch.ones(B, dtype=torch.bool)
    gate = tfs.parse_gate(parsed, valid).tolist()
    jgate = np.asarray(jfs.parse_gate(
        {k: jnp.asarray(v.numpy()) for k, v in parsed.items()},
        jnp.asarray(valid.numpy())))
    assert gate[:2] == [int(jgate[0]), int(jgate[1])] == [1, gate[1]]
    mask = fixed_compatible_mask(parsed["qcoeffs"].reshape(-1, 32).numpy(),
                                 parsed["shift"].reshape(-1).numpy(),
                                 parsed["order"].reshape(-1).numpy())
    assert gate[2] == int(mask.all())
    # a lane that is not ok fails the gate unless it is not valid
    parsed["ok"][1] = False
    assert tfs.parse_gate(parsed, valid).tolist()[0] == 0
    valid[1] = False
    assert tfs.parse_gate(parsed, valid).tolist()[0] == 1


# ---------------------------------------------------------------------------
# The device-parse decode path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,bps", [("music", 16), ("mixed", 16)])
def test_device_parse_decoder_matches_jax(monkeypatch, kind, bps):
    monkeypatch.setenv("FLAC_TPU_PALLAS", "force")
    n = BS * 6 + 30
    data, pcm = _stream(kind, n, bps, 2, 6,
                        Options.best().no_seektable().with_block_size(BS))
    with JaxDecoder(io.BytesIO(data), batch_frames=8,
                    device_parse=True) as jd:
        assert jd._device_parse
        want = np.asarray(jd.read_all_device())
    with BatchDecoder(io.BytesIO(data), batch_frames=8, device="cpu",
                      device_parse=True) as dec:
        got = dec.read_all_device()
        assert (dec.device_frames, dec.host_frames) == (6, 1)
        assert dec.parse_fallbacks == 1       # the short tail
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(-1), pcm)


def test_device_parse_falls_back_on_a_body_that_does_not_parse():
    """A CRC-valid frame whose body the parser refuses (a reserved
    subframe type) goes to the host parse, which raises what it raises
    without the device parse."""
    from flac_codec_tpu_torch.crc import crc16

    data, _ = _stream("music", BS * 3, 16, 2, 7,
                      Options.best().no_seektable().with_block_size(BS))
    (d, off, nbits, *_), _ = _scan(data)
    d = d.numpy().copy()
    o = int(off[1])
    d[o] = 2 << 1                       # frame 1, subframe 0: reserved type
    # mend frame 1's CRC-16 so the scan still finds it
    start = int(off[0]) + int(nbits[0]) // 8 + 2
    end = o + int(nbits[1]) // 8
    crc = crc16(bytes(d[start:end]))
    d[end:end + 2] = [crc >> 8, crc & 0xFF]
    bad = data[:len(data) - len(d)] + d.tobytes()
    errors = []
    for device_parse in (False, True):
        with BatchDecoder(io.BytesIO(bad), batch_frames=8, device="cpu",
                          device_parse=device_parse) as dec:
            with pytest.raises(Exception) as e:
                dec.read_all_device()
            errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    # frame 0 went through the host parse after the first fallback, and
    # the second fallback met frame 1 again
    assert (dec.device_frames, dec.parse_fallbacks) == (1, 2)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_stream_through_device_parse(name):
    with open(os.path.join(CORPUS, name), "rb") as fp:
        data = fp.read()
    with BatchDecoder(io.BytesIO(data), batch_frames=4, device="cpu",
                      device_parse=True) as dec:
        flat = dec.read_all_device().numpy().astype(np.int64).reshape(-1)
        si = dec.streaminfo
        parsed = dec._device_parse
    assert parsed == (si.minimum_block_size == si.maximum_block_size
                      and si.bits_per_sample <= 24)
    assert len(flat) == MANIFEST[name]["total_samples"]
    assert hashlib.md5(flat.astype("<i8").tobytes()).hexdigest() \
        == MANIFEST[name]["pcm_md5"], name
