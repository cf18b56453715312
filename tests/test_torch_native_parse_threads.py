"""The port's native raw parse on several threads, on the CPU.

``parse_frames_raw`` cuts a batch's uniform-block prefix into contiguous
spans of about equal bytes and pumps each on a thread of its own.  Every
output of a call must be exactly equal to the same call on one thread
(``nthreads=1``, the one-thread pump) and to the JAX package's native
``parse_frames_raw``, the arrays' padding rows included: on CD and 24-bit
batches from a stream's first frame and from its middle, at frame counts
around two spans' worth of the auto rule's 16 frames, with the samples
left ending inside the last span, and on damaged streams (a flipped bit,
false syncs that pass the header check, a cut stream), which the spans
hand back to the one-thread path.  ``spans`` says how many spans parsed
the prefix.
"""

import io
import json
import os

import numpy as np
import pytest

from flac_codec_tpu_torch import native
from flac_codec_tpu_torch.decode import Decoder
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder
from flac_codec_tpu_torch.utils import trace

ARRAYS = ("buf", "order", "shift", "wasted", "qcoeffs", "assignment",
          "blocks")
SPAN_FRAMES = 16        # the auto rule's frames a span
THREADED = (2, 3, 8)


@pytest.fixture(scope="module")
def nat():
    return native.load()


@pytest.fixture(scope="module")
def ref():
    from flac_codec_tpu import native as jax_native
    lib = jax_native.load()
    assert lib is not None, "the JAX package's native engine did not build"
    return lib


def _encode(x, bps, rate, block):
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, Options(block_size=block), rate, bps,
                         x.shape[1], total_samples=len(x))
    w.write(x.astype(np.int32).reshape(-1))
    w.finalize()
    return buf.getvalue()


def _music(n, bps, channels, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    return np.stack([amp * np.sin(t * (0.03 + 0.01 * c))
                     + rng.normal(0, amp >> 6, n) for c in range(channels)],
                    1)


class Stream:
    """A stream's frame section as the decoder holds it, its format, and
    its frame starts (bytes into ``view``; the last is the section's
    end), from the native decoder a frame at a time (a scan by CRC-16
    alone would take a planted frame for a real one)."""

    def __init__(self, data):
        dec = Decoder(io.BytesIO(data))
        si = dec.streaminfo
        self.data = data
        self.view = np.ascontiguousarray(dec.r.np_view())
        self.total = dec.total_samples
        self.block = si.maximum_block_size
        self.fmt = (si.sample_rate, si.channels, si.bits_per_sample,
                    self.block)
        self.starts = [dec.r.pos // 8]
        while True:
            _, sizes, end, _ = native.load().decode_frames(
                self.view, self.starts[-1] * 8, 1, *self.fmt, None,
                nthreads=1)
            if not len(sizes):
                break
            self.starts.append(end // 8)

    def left(self, f):
        """Samples left from frame ``f``."""
        return self.total - f * self.block


# 100 whole frames of 1024 samples and a short last frame
STREAMS = {"cd": (16, 44100), "hires24": (24, 96000)}


@pytest.fixture(scope="module")
def streams():
    return {name: Stream(_encode(_music(1024 * 100 + 300, bps, 2, seed=i),
                                 bps, rate, 1024))
            for i, (name, (bps, rate)) in enumerate(sorted(STREAMS.items()))}


@pytest.fixture(scope="module")
def noise():
    """Mono 16-bit white noise at full scale: every frame is a verbatim
    subframe (2,048 bytes of samples, byte-aligned), 80 frames of 1024;
    and what any frame's samples can hold: frame 39's header (CRC-8
    included), and a whole frame of silence (a constant subframe and its
    CRC-16) of the same format."""
    x = np.random.default_rng(11).integers(-32768, 32768, (1024 * 80, 1))
    s = Stream(_encode(x, 16, 44100, 1024))
    got = native.load().scan_frames_portable(
        s.view, s.starts[39] * 8, 1, *s.fmt, None)
    head = s.view[s.starts[39]:int(got["body_off"][0])].tobytes()
    quiet = Stream(_encode(np.zeros((1024 * 3, 1)), 16, 44100, 1024))
    frame = quiet.view[quiet.starts[1]:quiet.starts[2]].tobytes()
    return x, s, head, frame


def _parse(lib, view, start_byte, frames, fmt, left, **kw):
    return lib.parse_frames_raw(view, start_byte * 8, frames, *fmt, left,
                                **kw)


def _all_three(nat, ref, s, view, f, frames, left, nt):
    """One call on ``nt`` spans, on one thread and in the JAX package's
    engine, from frame ``f`` of ``s`` (starts from the whole stream) over
    ``view``: every output equal, the padding rows of the arrays too.
    Returns the threaded call's dict."""
    args = (view, s.starts[f], frames, s.fmt, left)
    got = _parse(nat, *args, nthreads=nt)
    one = _parse(nat, *args, nthreads=1)
    want = _parse(ref, *args)
    assert one["spans"] in (0, 1)
    for k in ARRAYS:
        # the whole array the engine wrote: the rows past n too
        np.testing.assert_array_equal(got[k].base, one[k].base, err_msg=k)
        np.testing.assert_array_equal(got[k].base, want[k].base,
                                      err_msg=f"{k} against JAX")
    for k in ("n", "end_bitpos", "error"):
        assert got[k] == one[k], k
    assert (got["n"], got["error"]) == (want["n"], want["error"])
    n = got["n"]
    if f + n < len(s.starts):
        # the port reports where the frame it stopped at starts (the JAX
        # package's raw parse steps past a frame that fails its CRC-16)
        assert got["end_bitpos"] == 8 * s.starts[f + n]
    if got["error"] == 0:
        assert got["end_bitpos"] == want["end_bitpos"]
    return got


def _spans_expected(frames, nt):
    """The spans a clean batch of ``frames`` pumpable frames runs on."""
    if nt == 0:
        nt = min(len(os.sched_getaffinity(0)), frames // SPAN_FRAMES)
    return max(1, min(nt, frames))


@pytest.mark.parametrize("nt", THREADED)
@pytest.mark.parametrize("first", [0, 17])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_batch_from_the_head_and_mid_stream(nat, ref, streams, name, first,
                                            nt):
    """64 frames from the first frame and from frame 17, the buffer
    holding the whole stream; every span runs."""
    s = streams[name]
    for left in (s.left(first), None):
        got = _all_three(nat, ref, s, s.view, first, 64, left, nt)
        assert (got["n"], got["error"]) == (64, 0)
        assert got["spans"] == nt


@pytest.mark.parametrize("nt", (0,) + THREADED)
@pytest.mark.parametrize("frames", [2 * SPAN_FRAMES - 1, 2 * SPAN_FRAMES,
                                    2 * SPAN_FRAMES + 1, 37, 83])
def test_frame_counts_around_two_spans(nat, ref, streams, frames, nt):
    """Frame counts around two spans of the auto rule, and 37 and 83
    (prime: no span count divides them), from frame 5; auto (``nt`` 0)
    takes min(usable CPUs, frames // 16) spans."""
    s = streams["cd"]
    got = _all_three(nat, ref, s, s.view, 5, frames, s.left(5), nt)
    assert (got["n"], got["error"]) == (frames, 0)
    if nt == 0:
        assert got["spans"] == _spans_expected(frames, 0)
    else:
        assert 2 <= got["spans"] <= nt


@pytest.mark.parametrize("nt", THREADED)
@pytest.mark.parametrize("cut", [0, 1, 512, 1023])
def test_samples_left_end_inside_the_last_span(nat, ref, streams, nt, cut):
    """The samples left end ``cut`` samples short of frame 50's end, 64
    frames asked from frame 0: the prefix stops at the frames the samples
    hold whole, and the sequential parser classifies the rest."""
    s = streams["cd"]
    left = 51 * s.block - cut
    got = _all_three(nat, ref, s, s.view, 0, 64, left, nt)
    assert got["n"] == (51 if cut == 0 else 50)
    assert got["spans"] >= 2


@pytest.mark.parametrize("nt", THREADED)
@pytest.mark.parametrize("frame", [9, 30, 31, 52])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_a_flipped_bit_in_a_middle_span(nat, ref, streams, name, frame, nt):
    """One bit flipped in frame ``frame``'s body: the span that holds it
    fails, the one-thread pump fails too, and the sequential parser stops
    at that frame."""
    s = streams[name]
    rng = np.random.default_rng(frame)
    for _ in range(3):
        view = s.view.copy()
        a, e = s.starts[frame], s.starts[frame + 1]
        p = int(rng.integers(a + 8, e - 2))
        view[p] ^= np.uint8(1 << int(rng.integers(0, 8)))
        got = _all_three(nat, ref, s, view, 0, 64, s.left(0), nt)
        assert got["n"] == frame and got["error"] != 0
        assert got["spans"] == 0


def _plant(x, planted, frames, back):
    """``x`` with the bytes ``planted`` in the samples of each of
    ``frames``, ``back`` bytes before the frame's end (its CRC-16
    included), encoded again."""
    y = x.copy()
    pad = planted + b"\x00" * (len(planted) % 2)
    words = np.frombuffer(pad, ">i2").astype(np.int64)
    for f in frames:
        i = 1024 * (f + 1) - (back - 2) // 2
        y[i:i + len(words), 0] = words
    s = Stream(_encode(y, 16, 44100, 1024))
    for f in frames:
        # verbatim samples: the bytes lie where they were put
        at = s.starts[f + 1] - back
        assert s.view[at:at + len(planted)].tobytes() == planted, f
    return s


def _end_in_a_frame(nat, x, s, f, frame):
    """``x`` with frame ``f``'s last samples holding ``frame`` (a whole
    frame of ``s``'s format) but for its CRC-16, and one sample before it
    chosen so that frame ``f``'s own CRC-16 is ``frame``'s, encoded again:
    a valid frame that ends where frame ``f`` ends."""
    got = nat.scan_frames_portable(s.view, s.starts[f] * 8, 1, *s.fmt, None)
    hdr = s.view[s.starts[f]:int(got["body_off"][0]) + 1].tobytes()
    assert hdr[-1] == 0x02          # a verbatim subframe, no wasted bits
    y = x.copy()
    rows = slice(1024 * f, 1024 * (f + 1))
    samples = bytearray(y[rows, 0].astype(">i2").tobytes())
    body = frame[:-2]
    samples[len(samples) - len(body):] = body
    k = (len(samples) - len(body)) // 2 * 2 - 2     # the chosen sample
    head = nat.crc16(hdr + bytes(samples[:k]))
    want = int.from_bytes(frame[-2:], "big")
    rest = bytes(samples[k + 2:])
    word = next(w for w in range(1 << 16)
                if nat.crc16(w.to_bytes(2, "big") + rest, head) == want)
    samples[k:k + 2] = word.to_bytes(2, "big")
    y[rows, 0] = np.frombuffer(bytes(samples), ">i2")
    planted = Stream(_encode(y, 16, 44100, 1024))
    end = planted.starts[f + 1]
    assert planted.view[end - len(frame):end].tobytes() == frame
    return planted


@pytest.mark.parametrize("nt", THREADED + (64,))
@pytest.mark.parametrize("where", ["one", "every", "whole frame"])
def test_false_syncs_in_frame_bodies(nat, ref, noise, where, nt):
    """A valid frame header in a frame's verbatim samples, 42 bytes
    before its end: a false candidate that the frame's own end does not
    meet.  ``one``: in frame 31, where the two-span split of these equal
    frames falls; ``every``: in all 64, so that the last frame of every
    span fails its retire; ``whole frame``: a whole valid frame of
    silence in the last bytes of frame 31, ending where frame 31 ends, so
    that it parses and meets the next candidate: only frame 31's own
    retire against it (the last frame of span 0 against the first of span
    1, on two spans) finds it.  The sequential parser reads all 64."""
    x, clean, head, frame = noise
    if where == "whole frame":
        s = _end_in_a_frame(nat, x, clean, 31, frame)
    else:
        s = _plant(x, head, range(64) if where == "every" else [31], 42)
    got = _all_three(nat, ref, s, s.view, 0, 64, s.left(0), nt)
    assert (got["n"], got["error"]) == (64, 0)
    assert got["spans"] == 0


@pytest.mark.parametrize("nt", THREADED)
@pytest.mark.parametrize("cut", ["mid frame 40", "less 1", "frame 41"])
def test_truncated_stream(nat, ref, streams, nt, cut):
    """The buffer cut inside frame 40, one byte short of the section's
    end, and where frame 41 starts; 64 frames and then every frame
    asked."""
    s = streams["cd"]
    at = {"mid frame 40": s.starts[40] + 700, "less 1": len(s.view) - 1,
          "frame 41": s.starts[41]}[cut]
    view = np.ascontiguousarray(s.view[:at])
    for frames in (64, 200):
        got = _all_three(nat, ref, s, view, 0, frames, s.left(0), nt)
        assert got["spans"] in (0, 1, _spans_expected(got["n"], nt))
        if cut != "less 1":
            assert got["n"] == 40 + (cut == "frame 41")


def test_one_thread_reports_one_span(nat, streams):
    """``nthreads=1`` is the one-thread pump; a call of one frame, which
    the pump does not take, is the sequential parser's."""
    s = streams["cd"]
    assert _parse(nat, s.view, s.starts[0], 64, s.fmt, None,
                  nthreads=1)["spans"] == 1
    assert _parse(nat, s.view, s.starts[0], 1, s.fmt, None,
                  nthreads=8)["spans"] == 0


def test_decode_frames_threads_from_the_head_of_a_long_stream(nat):
    """A 256-frame ``decode_frames`` call from the head of a 600-frame
    stream on 4 threads gives the one-thread call's samples (its spans are
    sized over the call's own frames, not the buffer's bytes)."""
    s = Stream(_encode(_music(1024 * 600 + 10, 16, 2, seed=5), 16, 44100,
                       1024))
    args = (s.view, s.starts[0] * 8, 256, *s.fmt, s.total)
    one = nat.decode_frames(*args, nthreads=1)
    four = nat.decode_frames(*args, nthreads=4)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)
    assert len(one[1]) == 256 and one[2] == 8 * s.starts[256]


def test_batch_decoder_counts_threaded_batches(streams, tmp_path,
                                               monkeypatch):
    """``BatchDecoder``'s host parse of 64-frame batches on the CPU: the
    PCM equals the source, ``threaded_batches`` counts the full batches
    (where the host has two CPUs or more), and every ``decode.parse``
    span notes ``spans``."""
    s = streams["cd"]
    src = _music(1024 * 100 + 300, 16, 2, seed=0).astype(np.int32)
    path = tmp_path / "trace.jsonl"
    trace._records.clear()
    monkeypatch.setattr(trace, "_MODE", str(path))
    with BatchDecoder(io.BytesIO(s.data), 64, device="cpu") as dec:
        got = dec.read_all_device().numpy().reshape(-1)
    trace.flush()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    trace._records.clear()
    np.testing.assert_array_equal(got, src.reshape(-1))
    parses = [r for r in recs if r["stage"] == "decode.parse"]
    want = [_spans_expected(64, 0), _spans_expected(36, 0)]
    assert [r["spans"] for r in parses][:2] == want
    assert all("spans" in r for r in parses)
    assert dec.threaded_batches == sum(n >= 2 for n in want)
