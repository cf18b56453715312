"""The port's native CRC-16 and frame scan on the CPU.

``nat_crc16`` folds long inputs in four carry-less-multiply chains; it
must equal a table CRC-16 built here from the polynomial at every length,
start alignment and initial value.  ``scan_frames`` takes one AVX2 pass a
frame on a host with AVX2 and PCLMUL; every output of it must equal the
JAX package's native ``scan_frames`` (the loop the port's came from) and
the port's portable loop (``scan_frames_portable``, its own exported
symbol, the fallback on other hosts) on seeded streams, on streams whose
frame ends, false syncs and buffer ends are planted where the pass's 32-
and 64-byte blocks meet, and on damaged ones.  On a host without AVX2 and
PCLMUL the port runs the portable loop and the comparisons still hold.
"""

import ctypes
import io
import json

import numpy as np
import pytest

from flac_codec_tpu_torch import native
from flac_codec_tpu_torch.decode import Decoder
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.parallel.batch_decode import (BatchDecoder,
                                                        MultiStreamDecoder)
from flac_codec_tpu_torch.utils import trace

DEC_CRC16 = 4
KEYS = ("n", "body_off", "body_bytes", "assignment", "blocks", "end_bitpos",
        "error")


@pytest.fixture(scope="module")
def nat():
    return native.load()


@pytest.fixture(scope="module")
def ref():
    from flac_codec_tpu import native as jax_native
    lib = jax_native.load()
    assert lib is not None, "the JAX package's native engine did not build"
    return lib


def _table():
    table = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        table.append(c)
    return table


TABLE = _table()


def _table_crc16(data, crc=0):
    for b in data:
        crc = TABLE[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


def _crc16_at(nat, arr, off, n, crc):
    """``nat_crc16`` over ``arr[off:off + n]`` in place (the pointer keeps
    the bytes' alignment)."""
    ptr = ctypes.cast(arr.ctypes.data + off, ctypes.POINTER(ctypes.c_uint8))
    return nat._lib.nat_crc16(ptr, n, crc)


@pytest.mark.parametrize("crc", [0, 0xBEEF])
@pytest.mark.parametrize("start", range(16))
def test_crc16_matches_table(nat, start, crc):
    """Every length 0-300, then 4,096 and 16,811 bytes, from a start
    ``start`` bytes past a 64-byte boundary, continuing from ``crc``."""
    rng = np.random.default_rng(start)
    raw = rng.integers(0, 256, 16811 + 128).astype(np.uint8)
    base = (-raw.ctypes.data) % 64 + start
    data = raw[base:base + 16811].tobytes()
    want = crc
    for n in range(301):
        assert _crc16_at(nat, raw, base, n, crc) == want, n
        if n < 300:
            want = TABLE[((want >> 8) ^ data[n]) & 0xFF] ^ ((want << 8)
                                                           & 0xFFFF)
    for n in (4096, 16811):
        assert _crc16_at(nat, raw, base, n, crc) == \
            _table_crc16(data[:n], crc), n


def test_crc16_residue_of_a_frame_is_zero(nat):
    """A message followed by its own CRC-16 leaves residue 0, at lengths
    on both sides of the four-chain path's least."""
    rng = np.random.default_rng(5)
    for n in (30, 126, 127, 128, 129, 191, 192, 4093):
        msg = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        framed = msg + _table_crc16(msg).to_bytes(2, "big")
        assert nat.crc16(framed) == 0


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def _encode(n, bps, channels, rate, block, seed, kind="music"):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    if kind == "music":
        x = np.stack([amp * np.sin(t * (0.03 + 0.01 * c))
                      + rng.normal(0, amp >> 6, n) for c in range(channels)],
                     1)
    elif kind == "noise":
        x = rng.integers(-amp, amp, (n, channels))
    else:                                   # silence: constant subframes
        x = np.zeros((n, channels))
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, Options(block_size=block), rate, bps, channels,
                         total_samples=n)
    w.write(x.astype(np.int32).reshape(-1))
    w.finalize()
    return buf.getvalue()


class Stream:
    """A stream's frame section as the decoder holds it, its format and
    its frame starts (bytes into ``view``)."""

    def __init__(self, data):
        dec = Decoder(io.BytesIO(data))
        si = dec.streaminfo
        self.view = np.ascontiguousarray(dec.r.np_view())
        self.start = dec.r.pos // 8
        self.total = dec.total_samples
        self.fmt = (si.sample_rate, si.channels, si.bits_per_sample,
                    si.maximum_block_size)
        self.block = si.maximum_block_size
        scan = native.load().scan_frames_portable(
            self.view, self.start * 8, 10 ** 6, *self.fmt, None)
        self.starts = [self.start] + [
            int(o) + int(b) + 2 for o, b in zip(scan["body_off"],
                                                scan["body_bytes"])]

    def header_end(self, f):
        """Byte past frame ``f``'s header."""
        scan = native.load().scan_frames_portable(
            self.view, self.starts[f] * 8, 1, *self.fmt, None)
        return int(scan["body_off"][0])


STREAMS = {
    "stereo16": (1024 * 40 + 100, 16, 2, 44100, 1024, "music"),
    "stereo24": (1024 * 40 + 100, 24, 2, 96000, 1024, "music"),
    "mono16": (1024 * 40 + 100, 16, 1, 44100, 1024, "music"),
    # frames of 14 bytes: constant subframes, every frame under 64 bytes
    "silence16": (4096 * 12, 16, 2, 44100, 4096, "silence"),
    # 16-sample frames of noise: ~40 bytes mono, ~75 bytes stereo
    "tiny_mono16": (16 * 200, 16, 1, 44100, 16, "noise"),
    "tiny_stereo16": (16 * 200, 16, 2, 44100, 16, "noise"),
    # whole blocks only: the last frame ends at the buffer's end
    "whole16": (1024 * 12, 16, 2, 44100, 1024, "music"),
}


@pytest.fixture(scope="module")
def streams():
    return {name: Stream(_encode(*args[:5], seed=i, kind=args[5]))
            for i, (name, args) in enumerate(sorted(STREAMS.items()))}


def _both(nat, ref, view, start_byte, frames, fmt, remaining):
    """The port's scan of one call against the JAX package's and against
    the port's portable loop; asserts every output equal and returns the
    port's."""
    args = (view, start_byte * 8, frames, *fmt, remaining)
    got = nat.scan_frames(*args)
    for name, want in (("JAX package", ref.scan_frames(*args)),
                       ("portable", nat.scan_frames_portable(*args))):
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} against {name}")
    return got


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_scan_matches_references_from_every_tenth_frame(nat, ref, streams,
                                                        name):
    """From every tenth frame start to the stream's end, with the samples
    left known and unknown, and for a batch of 7 frames."""
    s = streams[name]
    for f in range(0, len(s.starts) - 1, 10):
        left = s.total - f * s.block
        got = _both(nat, ref, s.view, s.starts[f], 10 ** 6, s.fmt, left)
        whole = len(s.starts) - 1 - f
        assert got["n"] >= min(whole, 1)
        _both(nat, ref, s.view, s.starts[f], 10 ** 6, s.fmt, None)
        _both(nat, ref, s.view, s.starts[f], 7, s.fmt, left)


def test_scan_reads_the_stream_end_candidate(nat, ref, streams):
    """A stream of whole blocks: its last frame ends at the buffer's end,
    which only the stream-end candidate finds."""
    s = streams["whole16"]
    got = _both(nat, ref, s.view, s.start, 10 ** 6, s.fmt, None)
    assert got["n"] == len(s.starts) - 1
    assert got["end_bitpos"] == len(s.view) * 8


def _splice(s, f, length):
    """Frame ``f`` cut to ``length`` bytes (its CRC-16 remade), then the
    rest of the stream from frame ``f + 2``: the next sync lies ``length``
    bytes past frame ``f``'s start."""
    a = s.starts[f]
    head = s.view[a:a + length - 2].tobytes()
    return np.frombuffer(
        s.view[:a].tobytes() + head
        + _table_crc16(head).to_bytes(2, "big")
        + s.view[s.starts[f + 2]:].tobytes(), np.uint8).copy()


@pytest.mark.parametrize("length", [31, 32, 33, 63, 64, 65, 95, 96, 127,
                                    128, 129, 191, 192])
@pytest.mark.parametrize("name", ["stereo16", "mono16"])
def test_scan_finds_a_sync_at_each_block_edge(nat, ref, streams, name,
                                              length):
    """The next frame's sync pair planted ``length`` bytes past a frame's
    start: across (31, 63, ...), at (32, 64, ...) and past each 32- and
    64-byte edge of the pass's blocks."""
    s = streams[name]
    f = 3
    view = _splice(s, f, length)
    got = _both(nat, ref, view, s.starts[f], 4, s.fmt, None)
    assert got["n"] == 4
    assert int(got["body_off"][0]) + int(got["body_bytes"][0]) + 2 == \
        s.starts[f] + length


def _plant(s, f, count, fix_crc):
    """``count`` copies of frame ``f``'s header planted in its body, 37
    bytes apart from its 40th byte (so over block edges), its CRC-16
    remade when ``fix_crc``."""
    view = s.view.copy()
    a, e = s.starts[f], s.starts[f + 1]
    hdr = view[a:s.header_end(f)].copy()
    for i in range(count):
        p = a + 40 + 37 * i
        assert p + len(hdr) < e - 2
        view[p:p + len(hdr)] = hdr
    if fix_crc:
        view[e - 2:e] = np.frombuffer(
            _table_crc16(view[a:e - 2].tobytes()).to_bytes(2, "big"),
            np.uint8)
    return view


@pytest.mark.parametrize("count,found", [(1, True), (16, True), (17, False)])
def test_scan_caps_false_candidates(nat, ref, streams, count, found):
    """False candidates (valid headers inside a body whose CRC-16 still
    holds): 16 are passed over, the 17th stops the scan (``DEC_CRC16``).
    The buffer ends inside the third frame, so the stream-end candidate
    fails too (whole frames to the buffer's end would pass it: their
    CRC-16 residues are 0 together)."""
    s = streams["stereo16"]
    f = 2
    view = _plant(s, f, count, fix_crc=True)[:s.starts[f + 3] - 5]
    got = _both(nat, ref, view, s.starts[f], 3, s.fmt, None)
    assert (got["n"], got["error"]) == (2 if found else 0, DEC_CRC16)


def test_scan_stops_on_false_candidates_in_a_bad_frame(nat, ref, streams):
    """17 false candidates in a frame whose CRC-16 fails: ``DEC_CRC16``
    after the frames before it."""
    s = streams["stereo24"]
    view = _plant(s, 4, 17, fix_crc=False)
    got = _both(nat, ref, view, s.starts[1], 10, s.fmt, None)
    assert (got["n"], got["error"]) == (3, DEC_CRC16)


@pytest.mark.parametrize("tail", range(1, 34))
def test_scan_with_a_sync_in_the_buffer_end(nat, ref, streams, tail):
    """The buffer cut ``tail`` bytes past a frame's start: that sync lies
    in the buffer's last 1-33 bytes, its header whole or cut."""
    for name in ("stereo16", "tiny_stereo16"):
        s = streams[name]
        f = 5
        for back in (1, 2, 3):
            view = np.ascontiguousarray(s.view[:s.starts[f] + tail])
            got = _both(nat, ref, view, s.starts[f - back], 10, s.fmt,
                        None)
            # a header lies whole in its first 16 bytes; a cut one is no
            # candidate, and the frame before it then fails its CRC-16
            assert got["n"] == back if tail >= 16 else \
                got["n"] in (back - 1, back)


@pytest.mark.parametrize("cut", ["half", "less 1", "less 7", 50, 5, 42, 0])
def test_scan_truncated_stream(nat, ref, cut):
    """The truncated stream of the native fuzz tests, scanned from past
    its streaminfo block (as those tests do) and from its first frame."""
    n, bs = 4096 * 3, 1024
    rng = np.random.default_rng(0)
    inter = rng.integers(-3000, 3000, 2 * n).astype(np.int32)
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, Options(block_size=bs), 44100, 16, 2,
                         total_samples=n)
    w.write(inter)
    w.finalize()
    data = np.frombuffer(buf.getvalue(), np.uint8)
    dec = Decoder(io.BytesIO(buf.getvalue()))
    first = len(data) - len(dec.r.np_view()) + dec.r.pos // 8
    assert data[first] == 0xFF
    cut = {"half": len(data) // 2, "less 1": len(data) - 1,
           "less 7": len(data) - 7}.get(cut, cut)
    trunc = np.ascontiguousarray(data[:cut])
    fmt = (44100, 2, 16, bs)
    for start in (42, first):
        for remaining in (n, None):
            _both(nat, ref, trunc, start, 100, fmt, remaining)


@pytest.mark.parametrize("name", ["stereo16", "tiny_stereo16"])
def test_scan_matches_references_on_bit_flips(nat, ref, streams, name):
    """Seeded single-bit flips anywhere in the frames."""
    s = streams[name]
    rng = np.random.default_rng(9)
    for _ in range(40):
        view = s.view.copy()
        p = int(rng.integers(s.start, len(view)))
        view[p] ^= np.uint8(1 << int(rng.integers(0, 8)))
        _both(nat, ref, view, s.start, 10 ** 6, s.fmt, s.total)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return set(line.split(":", 1)[1].split())
    except OSError:
        pass
    return set()


def test_scan_takes_the_simd_pass_on_an_avx2_pclmul_host(nat):
    if not {"avx2", "pclmulqdq"} <= _cpu_flags():
        pytest.skip("this host lacks AVX2 or PCLMUL")
    assert nat.scan_simd is True


def test_both_call_sites_note_the_scan_path(nat, streams, tmp_path,
                                            monkeypatch):
    """Every ``decode.scan`` span of ``BatchDecoder``'s device parse and of
    ``MultiStreamDecoder`` carries ``simd``, the engine's path."""
    path = tmp_path / "trace.jsonl"
    trace._records.clear()
    monkeypatch.setattr(trace, "_MODE", str(path))
    data = _encode(1024 * 6 + 50, 16, 1, 16000, 1024, seed=3)
    with BatchDecoder(io.BytesIO(data), 4, None, True, device="cpu") as dec:
        dec.read_all_device()
    MultiStreamDecoder(4, device="cpu").decode(
        [io.BytesIO(data), io.BytesIO(data)])
    trace.flush()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    trace._records.clear()
    scans = [r for r in recs if r["stage"] == "decode.scan"]
    assert len({r["req"] for r in scans}) == 2
    assert scans and all(r["simd"] is nat.scan_simd for r in scans)
