"""Host bit engine: MSB-first bit reader/writer/recorder.

Re-implements the subset of the reference's external ``bitstream-io`` crate
that the FLAC format needs (reference: SURVEY §2.1 — BitReader, BitWriter,
BitRecorder, read/write_unary, signed counted reads/writes).  Unary coding is
FLAC's: a value ``n`` is ``n`` zero bits followed by a one bit.

Hot array paths (Rice runs, fixed-width runs, blob concatenation) delegate to
the native C++ engine; scalar paths are pure Python.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional

import numpy as np

from .errors import EndOfStream
from .utils import trace


def _native():
    from . import native

    return native.load()


class BitWriter:
    """MSB-first bit writer backed by a bytearray."""

    __slots__ = ("buf", "_acc", "_accbits")

    def __init__(self) -> None:
        self.buf = bytearray()
        self._acc = 0
        self._accbits = 0

    # -- core ---------------------------------------------------------------

    def write(self, value: int, nbits: int) -> None:
        """Write the low ``nbits`` bits of ``value`` (unsigned)."""
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._accbits += nbits
        while self._accbits >= 8:
            self._accbits -= 8
            self.buf.append((self._acc >> self._accbits) & 0xFF)
        self._acc &= (1 << self._accbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        """Write a two's-complement signed value of ``nbits`` bits."""
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        """Write ``q`` zero bits followed by a one bit."""
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def write_bit(self, bit: bool) -> None:
        self.write(1 if bit else 0, 1)

    def write_bytes(self, data: bytes) -> None:
        if self._accbits == 0:
            self.buf.extend(data)
        else:
            for b in data:
                self.write(b, 8)

    def byte_align(self) -> None:
        if self._accbits:
            self.write(0, 8 - self._accbits)

    # -- introspection ------------------------------------------------------

    @property
    def bit_count(self) -> int:
        return len(self.buf) * 8 + self._accbits

    def written(self) -> int:
        """Bit count written so far (reference: BitRecorder::written())."""
        return self.bit_count

    def getvalue(self) -> bytes:
        assert self._accbits == 0, "bitstream not byte-aligned"
        return bytes(self.buf)

    # -- array fast paths ---------------------------------------------------

    def write_rice_array(self, residuals: np.ndarray, k: int) -> None:
        """Rice-encode an int32 residual array with parameter ``k``.

        Zigzag + unary + k LSBs per residual (reference:
        src/stream.rs:3044-3078).
        """
        nat = _native()
        wide = len(residuals) and (
            int(np.max(residuals)) > 0x7FFFFFFF
            or int(np.min(residuals)) < -0x80000000)
        if len(residuals) > 8 and not wide:
            res = np.ascontiguousarray(residuals, dtype=np.int32)
            v = res.astype(np.int64)
            u = np.where(v < 0, ((-v - 1) << 1) + 1, v << 1).astype(np.uint64)
            total_bits = int((u >> np.uint64(k)).sum()) + (k + 1) * len(res)
            self._reserve_and_pack(
                total_bits, lambda out, pos: nat.pack_rice(out, pos, res, k))
        else:
            for r in residuals:
                r = int(r)
                u = ((-r - 1) << 1) + 1 if r < 0 else r << 1
                self.write_unary(u >> k)
                if k:
                    self.write(u & ((1 << k) - 1), k)

    def write_signed_array(self, values: np.ndarray, width: int) -> None:
        """Write two's-complement values; raises OverflowError when a value
        does not fit (mirrors bitstream-io's checked signed writes, which the
        reference encoder relies on to reject impossible escape codes)."""
        if width == 0:
            return  # zero-width fields carry no bits (read side zero-fills)
        if len(values):
            v = np.asarray(values)
            lo, hi = -(1 << (width - 1)), (1 << (width - 1)) - 1
            if int(v.min()) < lo or int(v.max()) > hi:
                raise OverflowError(f"value out of range for {width}-bit write")
        nat = _native()
        if len(values) > 8:
            vals = np.ascontiguousarray(values, dtype=np.int64)
            self._reserve_and_pack(
                width * len(vals),
                lambda out, pos: nat.pack_signed(out, pos, vals, width))
        else:
            for v in values:
                self.write_signed(int(v), width)

    def _reserve_and_pack(self, total_bits: int, packer) -> None:
        """Flush accumulator into a zeroed numpy area and pack via native."""
        # flush accumulator bits into buf, remembering partial-bit position
        head_bits = self._accbits
        head_val = self._acc
        self._acc = 0
        self._accbits = 0
        nbytes = (head_bits + total_bits + 7) // 8
        area = np.zeros(nbytes + 8, dtype=np.uint8)
        pos = 0
        if head_bits:
            # place pending accumulator bits at the head of the area
            area[0] = (head_val << (8 - head_bits)) & 0xFF
            pos = head_bits
        end = packer(area, pos)
        # re-absorb the trailing partial byte into the accumulator
        full_bytes = end // 8
        rem = end % 8
        self.buf.extend(area[:full_bytes].tobytes())
        if rem:
            self._acc = int(area[full_bytes]) >> (8 - rem)
            self._accbits = rem

    def append_recorder(self, rec: "BitWriter") -> None:
        """Append all bits recorded in ``rec`` (BitRecorder playback;
        reference: src/encode.rs:2332-2333)."""
        if self._accbits == 0:
            self.buf.extend(rec.buf)
        else:
            nat = _native()
            if len(rec.buf) > 16:
                src = np.frombuffer(bytes(rec.buf), dtype=np.uint8)
                self._reserve_and_pack(
                    len(rec.buf) * 8,
                    lambda out, pos: nat.append_bits(out, pos, src, len(src) * 8))
            else:
                for b in rec.buf:
                    self.write(b, 8)
        if rec._accbits:
            self.write(rec._acc, rec._accbits)


# The reference distinguishes BitRecorder from BitWriter; here a recorder is
# simply a BitWriter whose bits are later appended to another writer.
BitRecorder = BitWriter


class BitReader:
    """MSB-first bit reader over an in-memory buffer with optional refill.

    When constructed from a stream, bytes are pulled in chunks; consumed
    prefix can be discarded with :meth:`discard_consumed` between frames.
    :meth:`fill_to_eof` takes the rest of the stream as one read-only
    buffer, after which ``data`` is a ``memoryview``.
    Raises :class:`EndOfStream` past the end.
    """

    __slots__ = ("data", "pos", "_source", "_base", "_eof", "_np_view",
                 "_gbuf", "_gbuf_len")

    CHUNK = 1 << 16

    def __init__(self, data: bytes | bytearray | None = None,
                 source: Optional[BinaryIO] = None) -> None:
        self.data = bytearray(data or b"")
        self.pos = 0  # bit position within self.data
        self._gbuf = None       # cached guarded numpy view of self.data
        self._gbuf_len = -1
        self._source = source
        self._base = 0  # absolute byte offset of data[0] in the source
        self._eof = source is None
        self._np_view: Optional[np.ndarray] = None

    @classmethod
    def from_stream(cls, fp: BinaryIO) -> "BitReader":
        return cls(source=fp)

    # -- buffer management --------------------------------------------------

    def _ensure_bits(self, nbits: int) -> bool:
        """Ensure at least ``nbits`` readable bits; False at EOF."""
        need_bytes = (self.pos + nbits + 7) // 8
        while len(self.data) < need_bytes:
            if self._eof:
                return False
            chunk = self._source.read(max(self.CHUNK, need_bytes - len(self.data)))
            if not chunk:
                self._eof = True
                return len(self.data) >= need_bytes
            self.data.extend(chunk)
        return True

    def fill_to_eof(self) -> None:
        """Take the rest of the source as one read-only buffer (once: the
        ``decode.fill`` span, whose ``how`` says which way and ``bytes``
        how large the buffer is).

        ``view``: a source with ``getvalue()`` returning ``bytes`` (a
        ``BytesIO``) lends them, uncopied; ``chunks``: any other is read
        a MiB at a time."""
        if self._eof:
            return
        with trace.stage("decode.fill"):
            how, data = "view", self._lend()
            if data is None:
                how = "chunks"
                while chunk := self._source.read(1 << 20):
                    self.data.extend(chunk)
                data = memoryview(self.data)
            self.data = data.toreadonly()
            self._eof = True
            trace.note("decode.fill", how=how, bytes=len(data))

    def _lend(self) -> Optional[memoryview]:
        """The source's own bytes from where ``data[0]`` sits, the source
        left at its end; None when it cannot lend them."""
        src = self._source
        try:
            whole = src.getvalue()
            if not isinstance(whole, bytes):
                return None
            start = src.tell() - len(self.data)
            src.seek(0, io.SEEK_END)
        except (AttributeError, OSError, ValueError):
            return None
        return memoryview(whole)[start:]

    def np_view(self) -> np.ndarray:
        """Zero-copy uint8 view of the (fully read) buffer, read-only
        when a fill made it; pins it so discard_consumed becomes a no-op
        while the view is live."""
        self.fill_to_eof()
        if self._np_view is None or len(self._np_view) != len(self.data):
            self._np_view = np.frombuffer(self.data, dtype=np.uint8)
        return self._np_view

    def _guarded(self) -> np.ndarray:
        """Cached copy of the buffer with 8 guard bytes for the native
        array readers — rebuilding per call made each partition read
        O(remaining stream)."""
        if self._gbuf is None or self._gbuf_len != len(self.data):
            self._gbuf = np.frombuffer(
                bytes(self.data) + b"\x00" * 8, dtype=np.uint8)
            self._gbuf_len = len(self.data)
        return self._gbuf

    def discard_consumed(self) -> None:
        """Drop fully consumed bytes (call only at byte alignment points).
        No-op while a numpy view pins the buffer."""
        if self._np_view is not None:
            return
        nbytes = self.pos // 8
        if nbytes:
            if isinstance(self.data, bytearray):
                del self.data[:nbytes]
            else:
                self.data = self.data[nbytes:]
            self._base += nbytes
            self.pos -= nbytes * 8
            self._gbuf = None  # same-length refills must not reuse the cache

    @property
    def abs_byte_pos(self) -> int:
        """Absolute byte offset in the source (requires byte alignment)."""
        return self._base + self.pos // 8

    def buffer_slice(self, start_byte: int, end_byte: int) -> bytes:
        """Bytes [start, end) by absolute offset — both must be buffered."""
        return bytes(self.data[start_byte - self._base:end_byte - self._base])

    def at_eof(self) -> bool:
        """True when no further bits are available."""
        return not self._ensure_bits(1)

    # -- scalar reads -------------------------------------------------------

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if not self._ensure_bits(nbits):
            raise EndOfStream("bit read past end of stream")
        pos = self.pos
        start = pos >> 3
        end = (pos + nbits + 7) >> 3
        chunk = int.from_bytes(self.data[start:end], "big")
        shift = end * 8 - (pos + nbits)
        self.pos = pos + nbits
        return (chunk >> shift) & ((1 << nbits) - 1)

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= 1 << (nbits - 1):
            v -= 1 << nbits
        return v

    def read_bit(self) -> bool:
        return bool(self.read(1))

    def read_unary(self) -> int:
        """Count zero bits until (and consuming) a one bit."""
        count = 0
        while True:
            if not self._ensure_bits(1):
                raise EndOfStream("unary read past end of stream")
            pos = self.pos
            byte = self.data[pos >> 3]
            bit_in_byte = pos & 7
            cur = (byte << bit_in_byte) & 0xFF
            if cur == 0:
                avail = 8 - bit_in_byte
                count += avail
                self.pos += avail
            else:
                lz = 8 - cur.bit_length() - 0  # leading zeros within window
                count += lz
                self.pos += lz + 1
                return count

    def skip(self, nbits: int) -> None:
        if not self._ensure_bits(nbits):
            raise EndOfStream("skip past end of stream")
        self.pos += nbits

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        assert self.pos % 8 == 0
        if not self._ensure_bits(n * 8):
            raise EndOfStream("byte read past end of stream")
        start = self.pos // 8
        self.pos += n * 8
        return bytes(self.data[start:start + n])

    # -- array fast paths ---------------------------------------------------

    def read_rice_array(self, n: int, k: int) -> np.ndarray:
        """Read ``n`` Rice codes with parameter ``k`` into int64 (33-bit
        side-channel residuals exceed int32; reference SubframeWidth::Wide)."""
        nat = _native()
        if n <= 8:
            out = np.empty(n, dtype=np.int64)
            for i in range(n):
                q = self.read_unary()
                lsb = self.read(k) if k else 0
                u = (q << k) | lsb
                out[i] = -(u >> 1) - 1 if (u & 1) else (u >> 1)
            return out
        # native path: operate on the contiguous guarded buffer
        if self._source is not None and not self._eof:
            self.fill_to_eof()
        buf = self._guarded()
        limit = len(self.data) * 8
        res, end = nat.unpack_rice(buf, self.pos, n, k, limit)
        if end > limit:
            raise EndOfStream("rice read past end of stream")
        self.pos = end
        return res

    def read_signed_array(self, n: int, width: int) -> np.ndarray:
        """Read ``n`` fixed-width two's-complement values into int64."""
        if width == 0:
            return np.zeros(n, dtype=np.int64)
        nat = _native()
        if n <= 8:
            out = np.empty(n, dtype=np.int64)
            for i in range(n):
                out[i] = self.read_signed(width)
            return out
        if not self._ensure_bits(n * width):
            raise EndOfStream("signed array read past end of stream")
        buf = self._guarded()
        res, end = nat.unpack_signed(buf, self.pos, n, width)
        self.pos = end
        return res
