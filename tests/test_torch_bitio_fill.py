"""The port's ``BitReader.fill_to_eof`` over each kind of source, on the
CPU: a ``BytesIO`` lends its bytes (``how`` "view"), any other source
is read a MiB at a time ("chunks").  Every kind must read what a reader
over the same bytes in memory reads."""

import io

import numpy as np
import pytest

from flac_codec_tpu_torch.bitio import BitReader, BitWriter
from flac_codec_tpu_torch.utils import trace
from torch_sources import open_as  # noqa: F401 (fixture)

N_RICE, K = 60_000, 6          # ~70 KB of Rice codes: past one CHUNK
N_SIGNED, WIDTH = 20_000, 20
OFFSET = 7                     # the reader starts this far into the source


def _payload() -> bytes:
    rng = np.random.default_rng(23)
    w = BitWriter()
    w.write(0xABCD, 16)
    w.write_signed(-5, 12)
    w.write_unary(9)
    w.byte_align()
    w.write_bytes(b"xyz")
    w.write_rice_array(rng.normal(0, 100, N_RICE).astype(np.int32), K)
    w.byte_align()
    w.write_signed_array(
        rng.integers(-(1 << (WIDTH - 1)), 1 << (WIDTH - 1), N_SIGNED), WIDTH)
    w.byte_align()
    w.write(0xDEADBEEF, 32)
    w.write_bytes(rng.integers(0, 256, 1000, np.uint8).tobytes())
    return w.getvalue()


PAYLOAD = _payload()
BLOB = b"\x5a" * OFFSET + PAYLOAD


def _source(kind, open_as):
    """(source at OFFSET, the ``how`` its fill takes, what to keep alive)."""
    if kind in ("file", "unseekable"):
        src = open_as(kind, BLOB)
        src.read(OFFSET)
        return src, "chunks", None
    if kind == "writes":
        src = io.BytesIO()
        src.write(BLOB[:1000])
        src.write(BLOB[1000:])
    else:
        src = io.BytesIO(BLOB)
    # a live export makes getvalue() copy
    held = src.getbuffer() if kind == "exported" else None
    src.seek(OFFSET)
    return src, "view", held


def _walk(r: BitReader) -> list:
    """Scalar, byte and array reads, discards before and after the fill,
    ``abs_byte_pos``, ``buffer_slice`` and ``np_view``'s bytes."""
    got = [r.read(16), r.read_signed(12), r.read_unary()]
    r.byte_align()
    r.discard_consumed()                         # before the fill
    got += [r.abs_byte_pos, r._base, r.read_bytes(3)]
    got.append(r.read_rice_array(N_RICE, K).tolist())   # fills
    r.byte_align()
    start = r.abs_byte_pos
    got.append(r.read_signed_array(N_SIGNED, WIDTH).tolist())
    r.byte_align()
    got += [start, r.buffer_slice(start, r.abs_byte_pos)]
    r.discard_consumed()                         # after the fill
    got += [r.abs_byte_pos, r._base, r.read(32)]
    view = r.np_view()
    r.discard_consumed()                         # pinned: a no-op
    got += [r._base, bytes(view), r.read_bytes(1000), r.at_eof()]
    return got


WANT = _walk(BitReader(PAYLOAD))
KINDS = ["bytes", "writes", "exported", "file", "unseekable"]


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """Tracing on, its records kept in memory for the test."""
    trace._records.clear()
    monkeypatch.setattr(trace, "_MODE", str(tmp_path / "trace.jsonl"))
    yield
    trace._records.clear()


def _fills() -> list:
    return [rec for span in trace._records
            for rec in trace._records_of(span)
            if rec["stage"] == "decode.fill"]


@pytest.mark.parametrize("kind", KINDS)
def test_every_source_reads_as_memory_does(kind, open_as, traced):
    src, how, held = _source(kind, open_as)
    r = BitReader.from_stream(src)
    got = _walk(r)
    assert got == WANT
    assert WANT[-3] == PAYLOAD[WANT[-4]:] and WANT[-1]
    fill, = _fills()
    assert fill["how"] == how
    # the buffer the fill leaves: the stream from where data[0] sat
    assert fill["bytes"] == len(PAYLOAD) - WANT[4]
    assert not r.np_view().flags.writeable
    if kind != "unseekable":
        # the source stands where a full read leaves it
        assert src.tell() == len(BLOB)
    shares = np.shares_memory(r.np_view(), np.frombuffer(BLOB, np.uint8))
    assert shares == (kind == "bytes")
    if how == "view":
        # lent, uncopied, unless an export made getvalue() copy
        own = np.frombuffer(src.getvalue(), np.uint8)
        assert np.shares_memory(r.np_view(), own) == (kind != "exported")
    if held is not None:
        held.release()
    src.close()


@pytest.mark.parametrize("kind", ["bytes", "writes"])
def test_a_later_write_to_the_bytesio_changes_nothing_read(kind, open_as):
    src, _, _ = _source(kind, open_as)
    r = BitReader.from_stream(src)
    first = r.read(16)
    view = r.np_view()
    src.seek(0)
    src.write(b"\xff" * len(BLOB))
    assert bytes(view) == PAYLOAD
    assert [first, r.read_signed(12), r.read_unary()] == WANT[:3]
    assert src.getvalue() == b"\xff" * len(BLOB)


def test_a_reader_over_bytes_never_fills(traced):
    r = BitReader(PAYLOAD)
    assert _walk(r) == WANT
    assert _fills() == []
