"""``MultiStreamDecoder`` on the CPU: many streams decoded into one
padded batch, held exactly to the plain reference (``benchmark/reference``:
each stream encoded by its writer and decoded alone by its reader) and to
the source PCM.  Batches of 4 frames, so that streams straddle batches;
streams shorter than a block, of whole blocks with no tail, and of other
formats, damaged or of unknown length; the spans and counters of a call."""

import io
import json

import numpy as np
import pytest
import torch

from benchmark.reference import decode as ref_decode
from benchmark.reference import encode as ref_encode
from flac_codec_tpu_torch import errors
from flac_codec_tpu_torch.decode import Decoder, FlacSampleReader
from flac_codec_tpu_torch.parallel import batch_decode
from flac_codec_tpu_torch.parallel.batch_decode import (BatchDecoder,
                                                        MultiStreamDecoder)
from flac_codec_tpu_torch.utils import trace
from torch_sources import open_as  # noqa: F401 (fixture)

torch.set_num_threads(2)

BLOCK = 256
BATCH = 4


def _stream(samples: int, seed: int, channels: int = 1, bits: int = 16):
    """A seeded voiced-like signal (a drifting tone, its harmonics, a
    noise floor) encoded by the reference writer at -5's predictor
    settings; returns (stream bytes, (samples, channels) int32 PCM)."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    f0 = rng.uniform(85, 255) * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    x = sum(np.sin(h * phase) / h for h in range(1, 6))
    full = (1 << (bits - 1)) - 1
    x = 0.4 * full * x / max(np.abs(x).max(), 1e-9)
    pcm = np.round(x[:, None] + rng.normal(0, full * 1e-3,
                                           (samples, channels)))
    pcm = np.clip(pcm, -full - 1, full).astype(np.int32)
    buf = io.BytesIO()
    opts = ref_encode.Options(block_size=BLOCK, max_lpc_order=8,
                              max_partition_order=5,
                              exhaustive_channel_correlation=False)
    w = ref_encode.FlacSampleWriter(buf, opts, 16000, bits, channels,
                                    total_samples=samples)
    w.write(pcm.reshape(-1))
    w.finalize()
    return buf.getvalue(), pcm


def _reference(stream: bytes, channels: int) -> np.ndarray:
    """The plain reference's decode of ``stream`` alone, (samples,
    channels)."""
    got = ref_decode.FlacSampleReader(io.BytesIO(stream)).read_all()
    return got.reshape(-1, channels)


def _check(pcm, lengths, items) -> None:
    """Row u of ``pcm`` holds stream u exactly, as the reference decodes
    it and as its source was, and zeros past its length and channels."""
    pcm, lengths = pcm.numpy(), lengths.numpy()
    assert pcm.dtype == np.int32 and lengths.dtype == np.int64
    assert pcm.shape == (len(items), max(s.shape[1] for _, s in items),
                         max(len(s) for _, s in items))
    for u, (stream, src) in enumerate(items):
        n, c = src.shape
        assert lengths[u] == n
        assert np.array_equal(pcm[u, :c, :n].T, src)
        assert np.array_equal(pcm[u, :c, :n].T, _reference(stream, c))
        assert not pcm[u, :, n:].any() and not pcm[u, c:].any()


def _counters(dec) -> dict:
    return {k: getattr(dec, k) for k in (
        "streams", "device_frames", "host_frames", "device_batches",
        "batch_streams", "parse_fallbacks", "stream_fallbacks")}


# lengths in samples: shorter than a block, whole blocks (no tail), and
# streams whose whole frames straddle 4-frame batches
MONO = {
    "short_whole_straddling": [100, 3 * BLOCK, 7 * BLOCK + 5, 2 * BLOCK + 1],
    "straddling_only": [5 * BLOCK + 17, 6 * BLOCK + 200, 9 * BLOCK + 1],
    "whole_blocks_only": [4 * BLOCK, BLOCK, 8 * BLOCK],
    "one_stream": [11 * BLOCK + 31],
    "tails_only": [17, BLOCK - 1, 200],
}


@pytest.mark.parametrize("case", MONO)
def test_mono_streams_decode_to_the_reference(case, open_as):
    items = [_stream(n, seed=100 + i) for i, n in enumerate(MONO[case])]
    dec = MultiStreamDecoder(BATCH, device="cpu")
    pcm, lengths = dec.decode([open_as("bytesio", s) for s, _ in items])
    _check(pcm, lengths, items)
    whole = [n // BLOCK for n in MONO[case]]
    parts = 0          # the streams each 4-frame batch holds frames of
    for batch in range(-(-sum(whole) // BATCH)):
        lo, hi = batch * BATCH, (batch + 1) * BATCH
        ends = np.cumsum([0] + whole)
        parts += sum(min(hi, b) > max(lo, a) for a, b in zip(ends, ends[1:]))
    assert _counters(dec) == {
        "streams": len(items), "device_frames": sum(whole),
        "host_frames": sum(n % BLOCK > 0 for n in MONO[case]),
        "device_batches": -(-sum(whole) // BATCH), "batch_streams": parts,
        "parse_fallbacks": 0, "stream_fallbacks": 0}


@pytest.mark.parametrize("kind", ["file", "unseekable", "path"])
def test_sources_of_every_kind(kind, open_as, tmp_path):
    items = [_stream(n, seed=200 + i)
             for i, n in enumerate([3 * BLOCK + 9, 2 * BLOCK])]
    if kind == "path":
        sources = []
        for i, (s, _) in enumerate(items):
            path = tmp_path / f"u{i}.flac"
            path.write_bytes(s)
            sources.append(str(path))
    else:
        sources = [open_as(kind, s) for s, _ in items]
    dec = MultiStreamDecoder(BATCH, device="cpu")
    _check(*dec.decode(sources), items)
    assert dec.device_batches == 2 and dec.stream_fallbacks == 0


@pytest.mark.parametrize("order", ["mono_first", "stereo_first"])
def test_other_formats_are_decoded_alone(order):
    """A stereo and a 24-bit stream among mono 16-bit ones: the call's
    device batches take the first stream's format, and each stream of
    another goes alone through ``BatchDecoder``."""
    mono = [_stream(n, seed=300 + i)
            for i, n in enumerate([5 * BLOCK + 3, 2 * BLOCK + 77])]
    other = [_stream(3 * BLOCK + 11, seed=310, channels=2),
             _stream(2 * BLOCK + 40, seed=311, bits=24)]
    if order == "mono_first":
        items = [mono[0], other[0], mono[1], other[1]]
        alone = 2
    else:
        items = [other[0], mono[0], other[1], mono[1]]
        alone = 3       # the stereo stream sets the format
    dec = MultiStreamDecoder(BATCH, device="cpu")
    _check(*dec.decode([io.BytesIO(s) for s, _ in items]), items)
    assert dec.stream_fallbacks == alone and dec.parse_fallbacks == 0


def test_a_stream_of_unknown_length_is_decoded_alone():
    """STREAMINFO's total of 0 (unknown): the stream goes alone through
    ``BatchDecoder``, which decodes to the end of its frames."""
    items = [_stream(n, seed=400 + i)
             for i, n in enumerate([4 * BLOCK + 2, 3 * BLOCK + 50])]
    s = bytearray(items[1][0])
    # fLaC, the block header, then STREAMINFO: the 36-bit total is the
    # low nibble of its byte 13 and its bytes 14-17
    s[8 + 13] &= 0xF0
    s[8 + 14:8 + 18] = bytes(4)
    items[1] = (bytes(s), items[1][1])
    dec = MultiStreamDecoder(BATCH, device="cpu")
    _check(*dec.decode([io.BytesIO(x) for x, _ in items]), items)
    assert dec.stream_fallbacks == 1


def test_empty_sources():
    dec = MultiStreamDecoder(BATCH, device="cpu")
    pcm, lengths = dec.decode([])
    assert pcm.shape == (0, 0, 0) and pcm.dtype == torch.int32
    assert lengths.shape == (0,) and lengths.dtype == torch.int64
    assert _counters(dec)["streams"] == 0 and dec.device_batches == 0


def _damaged(frame: int):
    """A stream of 6 whole frames and a tail with one byte of frame
    ``frame`` (6: the tail) flipped in its body."""
    stream, src = _stream(6 * BLOCK + 70, seed=500)
    start = Decoder(io.BytesIO(stream)).frames_start
    scan = batch_decode.native.load().scan_frames(
        np.frombuffer(stream, np.uint8)[start:], 0, 6, 16000, 1, 16, BLOCK,
        None)
    assert scan["n"] == 6
    # inside a whole frame's body, or the tail's, before its CRC-16
    at = (start + int(scan["body_off"][frame]) + 3 if frame < 6
          else len(stream) - 6)
    bad = bytearray(stream)
    bad[at] ^= 0x5A
    return bytes(bad), src


@pytest.mark.parametrize("frame", [0, 3, 6], ids=["first", "middle", "tail"])
def test_a_damaged_stream_raises_as_batch_decoder_does(frame):
    bad, _ = _damaged(frame)
    with pytest.raises(errors.FlacError) as alone:
        with BatchDecoder(io.BytesIO(bad), BATCH, None, True,
                          device="cpu") as dec:
            dec.read_all_device()
    good = _stream(5 * BLOCK + 9, seed=501)
    dec = MultiStreamDecoder(BATCH, device="cpu")
    with pytest.raises(type(alone.value)):
        dec.decode([io.BytesIO(good[0]), io.BytesIO(bad)])


# ---------------------------------------------------------------------------
# The batch step and the tail both decoders share
# ---------------------------------------------------------------------------

def test_one_stream_decodes_alike_in_both_decoders():
    """The same stream through ``BatchDecoder``'s device parse and through
    ``MultiStreamDecoder``: the same PCM, device frames and host frames."""
    stream, src = _stream(9 * BLOCK + 77, seed=800, channels=2)
    with BatchDecoder(io.BytesIO(stream), BATCH, None, True,
                      device="cpu") as alone:
        want = alone.read_all_device()
    dec = MultiStreamDecoder(BATCH, device="cpu")
    pcm, lengths = dec.decode([io.BytesIO(stream)])
    assert np.array_equal(want.numpy(), src)
    assert torch.equal(pcm[0].T, want) and lengths.tolist() == [len(src)]
    assert (dec.device_frames, dec.host_frames) == (9, 1)
    assert (alone.device_frames, alone.host_frames) == (9, 1)


@pytest.mark.parametrize("path", ["host_parse", "device_parse", "loader"])
def test_a_short_last_frame_takes_the_shared_tail(path, monkeypatch):
    """The short last frame goes through ``batch_decode._host_frame`` once,
    and its native half decodes it (``Decoder.read_frame`` is not
    called); the stream equals ``FlacSampleReader``'s."""
    stream, src = _stream(5 * BLOCK + 123, seed=801, channels=2)
    frames, reads = [], []
    real_tail, real_read = batch_decode._host_frame, Decoder.read_frame

    def tail(*args, **kwargs):
        frame = real_tail(*args, **kwargs)
        frames.append(frame.shape)
        return frame

    def read_frame(self):
        reads.append(self)
        return real_read(self)

    monkeypatch.setattr(batch_decode, "_host_frame", tail)
    monkeypatch.setattr(Decoder, "read_frame", read_frame)
    if path == "loader":
        dec = MultiStreamDecoder(BATCH, device="cpu")
        pcm, _ = dec.decode([io.BytesIO(stream)])
        got = pcm[0].T.numpy()
    else:
        with BatchDecoder(io.BytesIO(stream), BATCH, None,
                          path == "device_parse", device="cpu") as dec:
            got = dec.read_all_device().numpy()
    want = FlacSampleReader(io.BytesIO(stream)).read_all().reshape(-1, 2)
    assert np.array_equal(got, want) and np.array_equal(got, src)
    assert dec.host_frames == 1 and frames == [(2, 123)] and not reads


def _read_frame_error(stream: bytes) -> type:
    """The error ``Decoder.read_frame`` raises on ``stream``, read frame
    by frame from its first."""
    dec = Decoder(io.BytesIO(stream))
    with pytest.raises(errors.FlacError) as err:
        while dec.read_frame() is not None:
            pass
    return type(err.value)


@pytest.mark.parametrize("device_parse", [False, True],
                         ids=["host_parse", "device_parse"])
@pytest.mark.parametrize("damage", ["cut_in_last_frame",
                                    "bit_flip_in_middle_residuals"])
def test_a_damaged_frame_raises_what_read_frame_raises(damage, device_parse):
    """The native decoder, tried first on the frame where the parsers
    stop, must not accept a frame ``Decoder.read_frame`` refuses: the
    decode raises ``read_frame``'s error, of the same type."""
    stream, _ = _stream(6 * BLOCK + 70, seed=802, channels=2)
    if damage == "cut_in_last_frame":
        bad = stream[:-9]
    else:
        start = Decoder(io.BytesIO(stream)).frames_start
        scan = batch_decode.native.load().scan_frames(
            np.frombuffer(stream, np.uint8)[start:], 0, 6, 16000, 2, 16,
            BLOCK, None)
        assert scan["n"] == 6
        # the middle of frame 3's body: its residuals
        at = start + int(scan["body_off"][3]) + int(scan["body_bytes"][3]) // 2
        bad = bytearray(stream)
        bad[at] ^= 0x08
        bad = bytes(bad)
    want = _read_frame_error(bad)
    with pytest.raises(errors.FlacError) as got:
        with BatchDecoder(io.BytesIO(bad), BATCH, None, device_parse,
                          device="cpu") as dec:
            dec.read_all_device()
    assert type(got.value) is want


def test_a_batch_the_gate_refuses_goes_to_the_host_parse(monkeypatch):
    """The second batch's gate reads not ok: its streams are decoded
    alone through the host parse, exactly, and the batch is counted."""
    real = batch_decode._parse_device
    calls = []

    def refused(*args, **kwargs):
        parsed, ok, order_max, fixed = real(*args, **kwargs)
        calls.append(ok)
        return parsed, ok and len(calls) != 2, order_max, fixed

    monkeypatch.setattr(batch_decode, "_parse_device", refused)
    items = [_stream(n, seed=600 + i) for i, n in
             enumerate([3 * BLOCK + 5, 3 * BLOCK + 6, 5 * BLOCK, 70])]
    dec = MultiStreamDecoder(BATCH, device="cpu")
    _check(*dec.decode([io.BytesIO(s) for s, _ in items]), items)
    # batches [0 0 0 1] and [1 1 2 2], refused: streams 1 and 2 then go
    # alone, whole, and stream 2's last three frames make no batch
    assert len(calls) == 2 and dec.parse_fallbacks == 1
    assert dec.device_batches == 1 and dec.stream_fallbacks == 0


def test_one_call_is_one_request_with_its_spans(tmp_path, monkeypatch):
    """One ``decode.streams`` span a call, flushed at its end; a
    ``decode.open`` a stream and a ``decode.read`` a device batch under
    it, with today's stage names below each batch."""
    path = tmp_path / "trace.jsonl"
    trace._records.clear()
    monkeypatch.setattr(trace, "_MODE", str(path))
    lengths = [5 * BLOCK + 9, 3 * BLOCK, 2 * BLOCK + 100]
    items = [_stream(n, seed=700 + i) for i, n in enumerate(lengths)]
    dec = MultiStreamDecoder(BATCH, device="cpu")
    for _ in range(2):
        dec.decode([io.BytesIO(s) for s, _ in items])
        assert not trace._records          # flushed by the call
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    trace._records.clear()
    spans = {r["id"]: r for r in recs if "id" in r}
    tops = [r for r in spans.values() if r["parent"] is None]
    assert [r["stage"] for r in tops] == ["decode.streams"] * 2
    assert tops[0]["req"] != tops[1]["req"]
    first = [r for r in spans.values() if r["req"] == tops[0]["req"]]

    def under(stage):
        return [spans[r["parent"]]["stage"] for r in first
                if r["stage"] == stage]

    assert under("decode.open") == ["decode.streams"] * 3
    assert under("decode.fill") == ["decode.open"] * 3
    assert under("decode.read") == ["decode.streams"] * 3   # 10 frames
    assert under("decode.place") == ["decode.streams"]
    assert under("decode.host_frame") == ["decode.streams"] * 2
    for stage in ("decode.scan", "decode.upload", "decode.parse_device",
                  "decode.reconstruct"):
        assert under(stage) == ["decode.read"] * 3
    assert under("decode.gate_wait") == ["decode.parse_device"] * 3
    reads = {r["id"] for r in first if r["stage"] == "decode.read"}
    assert {r["span"] for r in recs
            if r["stage"] == "decode.read.self"} >= reads
    scans = [r for r in first if r["stage"] == "decode.scan"]
    assert [(r["frames"], r["parts"]) for r in scans] == \
        [(4, 1), (4, 2), (2, 1)]
    assert _counters(dec) == {
        "streams": 6, "device_frames": 20, "host_frames": 4,
        "device_batches": 6, "batch_streams": 8, "parse_fallbacks": 0,
        "stream_fallbacks": 0}


def test_refuses_missing_cuda(monkeypatch):
    """The default device is CUDA, and without it the decoder raises, as
    ``BatchDecoder`` does, instead of decoding on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiStreamDecoder(BATCH)
