"""The port's native decoder on random, truncated and bit-flipped buffers.

Twin of ``tests/test_native_fuzz.py``'s garbage, truncated, bit-flip and
raw-parse cases, run through ``flac_codec_tpu_torch.native`` with a stream
from the port's own ``FlacSampleWriter``.  Each call must return an error
code (or a clean end), never abort the process.  The truncated cases
include cuts that leave the buffer shorter than the stream's metadata, so
the start position lies past the buffer's end.
"""

import io

import numpy as np
import pytest

from flac_codec_tpu_torch import native
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options

START_BIT = 42 * 8  # past fLaC and the streaminfo block


@pytest.fixture(scope="module")
def nat():
    return native.load()


@pytest.fixture(scope="module")
def stream():
    n, bs = 4096 * 3, 1024
    rng = np.random.default_rng(0)
    inter = rng.integers(-3000, 3000, 2 * n).astype(np.int32)
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, Options(block_size=bs), 44100, 16, 2,
                         total_samples=n)
    w.write(inter)
    w.finalize()
    return np.frombuffer(buf.getvalue(), np.uint8), bs, n


def test_decode_random_garbage(nat):
    rng = np.random.default_rng(1)
    for _ in range(50):
        data = rng.integers(0, 256, int(rng.integers(1, 5000))).astype(
            np.uint8)
        out, sizes, end, err = nat.decode_frames(
            data, 0, 100, 44100, 2, 16, 4096, None)
        assert err != 0 or len(sizes) == 0


@pytest.mark.parametrize("nthreads", [1, 4])
@pytest.mark.parametrize("cut", ["half", "less 1", "less 7", 50, 5, 42, 0])
def test_decode_truncated_stream(nat, stream, cut, nthreads):
    """A buffer that ends inside a frame, inside the metadata (5, 42 and
    50 bytes: the start lies past or at the end) or holds nothing."""
    data, bs, n = stream
    cut = {"half": len(data) // 2, "less 1": len(data) - 1,
           "less 7": len(data) - 7}.get(cut, cut)
    trunc = np.ascontiguousarray(data[:cut])
    out, sizes, end, err = nat.decode_frames(
        trunc, START_BIT, 100, 44100, 2, 16, bs, n, nthreads=nthreads)
    assert err >= 0
    if cut <= START_BIT // 8:
        assert len(sizes) == 0 and err != 0


@pytest.mark.parametrize("cut", [5, 42, 50])
def test_scan_and_raw_parse_truncated_stream(nat, stream, cut):
    """The frame scan and the raw parse stop cleanly on a start at or past
    the buffer's end."""
    data, bs, n = stream
    trunc = np.ascontiguousarray(data[:cut])
    raw = nat.parse_frames_raw(trunc, START_BIT, 16, 44100, 2, 16, bs, n)
    assert raw["n"] == 0
    scan = nat.scan_frames(trunc, START_BIT, 16, 44100, 2, 16, bs, n)
    assert scan["n"] == 0


def test_decode_bitflips_detected_or_clean(nat, stream):
    data, bs, n = stream
    rng = np.random.default_rng(3)
    for _ in range(60):
        corrupted = data.copy()
        pos = int(rng.integers(42, len(data)))
        corrupted[pos] ^= 1 << int(rng.integers(0, 8))
        out, sizes, end, err = nat.decode_frames(
            np.ascontiguousarray(corrupted), START_BIT, 10 ** 6, 44100, 2,
            16, bs, n)
        assert err >= 0


def test_parse_raw_garbage(nat):
    rng = np.random.default_rng(4)
    for _ in range(30):
        data = rng.integers(0, 256, int(rng.integers(8, 3000))).astype(
            np.uint8)
        raw = nat.parse_frames_raw(data, 0, 16, 44100, 2, 16, 1024, None)
        assert raw["n"] >= 0
