"""Decode layer: core frame decoder + reader API surfaces.

Re-creates the reference's reader family (reference: src/decode.rs:55-1309):
``FlacByteReader`` (PCM bytes), ``FlacSampleReader`` (interleaved i32),
``FlacChannelReader`` (channel-major), ``FlacStreamReader`` (metadata-less
sync-scan), plus ``verify``.  The core per-frame work (Rice runs, the LPC
recurrence, decorrelation) runs on numpy/native; the batched device decode
path lives in ``ops.predict`` and is used by the batch pipeline.
"""

from __future__ import annotations

import hashlib
import io
from dataclasses import dataclass
from enum import Enum
from typing import BinaryIO, List, Optional

import numpy as np

from . import crc as crcmod
from . import metadata as meta
from .bitio import BitReader
from .byteorder import bytes_per_sample, interleave, samples_to_bytes
from .errors import (
    Crc16Mismatch,
    EndOfStream,
    ExcessiveWastedBits,
    FlacError,
    InvalidFixedOrder,
    InvalidLpcOrder,
    InvalidQlpPrecision,
    InvalidSeek,
    NegativeLpcShift,
    NotSeekable,
    ShortBlock,
)
from .format.frame import ChannelAssignment, FrameHeader
from .format.subframe import (
    CONSTANT,
    FIXED,
    FIXED_COEFFS,
    LPC,
    VERBATIM,
    read_residuals,
    read_subframe_header,
)


def _native():
    from . import native

    return native.load()


def predict(coefficients: np.ndarray, qlp_shift: int, channel: np.ndarray) -> None:
    """In-place LPC synthesis recurrence on an int64 channel buffer:
    ``x[n] += (sum_j q[j] * x[n-1-j]) >> shift``
    (reference: src/decode.rs:1738-1752).
    """
    order = len(coefficients)
    if order == 0 or len(channel) <= order:
        return
    _native().lpc_predict64(channel, coefficients, qlp_shift)


def read_subframe(r: BitReader, bits_per_sample: int, n: int) -> np.ndarray:
    """Decode one subframe into an int64 array of length ``n``
    (reference: src/decode.rs:1635-1736)."""
    header = read_subframe_header(r)
    eff_bps = bits_per_sample - header.wasted_bps
    if eff_bps <= 0:
        raise ExcessiveWastedBits()

    if header.type == CONSTANT:
        channel = np.full(n, r.read_signed(eff_bps), dtype=np.int64)
    elif header.type == VERBATIM:
        channel = r.read_signed_array(n, eff_bps).astype(np.int64)
    elif header.type == FIXED:
        order = header.order
        if order > n:
            raise InvalidFixedOrder()
        channel = np.empty(n, dtype=np.int64)
        channel[:order] = r.read_signed_array(order, eff_bps)
        channel[order:] = read_residuals(r, order, n)
        predict(FIXED_COEFFS[order], 0, channel)
    else:  # LPC
        order = header.order
        if order > n:
            raise InvalidLpcOrder()
        channel = np.empty(n, dtype=np.int64)
        channel[:order] = r.read_signed_array(order, eff_bps)
        precision_code = r.read(4)
        if precision_code == 0b1111:
            raise InvalidQlpPrecision()
        precision = precision_code + 1
        shift = r.read_signed(5)
        if shift < 0:
            raise NegativeLpcShift()
        coeffs = r.read_signed_array(order, precision).astype(np.int32)
        channel[order:] = read_residuals(r, order, n)
        predict(coeffs, shift, channel)

    if header.wasted_bps:
        channel <<= header.wasted_bps
    return channel


def read_subframes(r: BitReader, header: FrameHeader) -> np.ndarray:
    """Decode all subframes of a frame, apply inverse decorrelation, and
    return a (channels, block_size) int32 array
    (reference: src/decode.rs:1494-1633)."""
    n = header.block_size
    bps = header.bits_per_sample
    ca = header.channel_assignment

    if not ChannelAssignment.is_correlated(ca):
        chans = [read_subframe(r, bps, n) for _ in range(header.channel_count)]
        out = np.stack(chans)
    elif ca == ChannelAssignment.LEFT_SIDE:
        left = read_subframe(r, bps, n)
        side = read_subframe(r, bps + 1, n)
        out = np.stack([left, left - side])
    elif ca == ChannelAssignment.SIDE_RIGHT:
        side = read_subframe(r, bps + 1, n)
        right = read_subframe(r, bps, n)
        out = np.stack([side + right, right])
    else:  # MID_SIDE
        mid = read_subframe(r, bps, n)
        side = read_subframe(r, bps + 1, n)
        total = mid * 2 + (np.abs(side) % 2)
        out = np.stack([(total + side) >> 1, (total - side) >> 1])

    r.byte_align()
    return out.astype(np.int32)


class Decoder:
    """Core frame decoder over a buffered bit reader
    (reference: src/decode.rs:1311-1491)."""

    def __init__(self, fp: BinaryIO, blocks: Optional[meta.BlockList] = None,
                 frames_start: Optional[int] = None):
        if blocks is None:
            blocks = meta.read_blocks(fp)
        if frames_start is None:
            # works for pre-read blocks too: the caller's fp sits at the
            # first frame right after reading the metadata
            try:
                frames_start = fp.tell()
            except (OSError, io.UnsupportedOperation):
                frames_start = None
        self.fp = fp
        self.blocks = blocks
        self.frames_start = frames_start
        self.r = BitReader.from_stream(fp)
        self.current_sample = 0

    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self.blocks.streaminfo

    @property
    def channels(self) -> int:
        return self.streaminfo.channels

    @property
    def sample_rate(self) -> int:
        return self.streaminfo.sample_rate

    @property
    def bits_per_sample(self) -> int:
        return self.streaminfo.bits_per_sample

    @property
    def total_samples(self) -> Optional[int]:
        return self.streaminfo.total_samples

    def read_frame(self) -> Optional[np.ndarray]:
        """Decode the next frame into (channels, block_size) int32, or None
        at end of stream (reference: src/decode.rs:1388-1437)."""
        self.r.discard_consumed()
        total = self.total_samples
        if total is not None:
            remaining = total - self.current_sample
            if remaining <= 0:
                return None
            start = self.r.abs_byte_pos
            header = FrameHeader.read(self.r, self.streaminfo)
            # only the last block in a stream may have <= 14 samples
            if not (header.block_size == remaining or header.block_size > 14):
                raise ShortBlock()
        else:
            if self.r.at_eof():
                return None
            start = self.r.abs_byte_pos
            try:
                header = FrameHeader.read(self.r, self.streaminfo)
            except EndOfStream:
                return None

        samples = read_subframes(self.r, header)
        crc_pos = self.r.abs_byte_pos
        expected = self.r.read(16)
        actual = crcmod.crc16(self.r.buffer_slice(start, crc_pos))
        if actual != expected:
            raise Crc16Mismatch(f"frame crc {actual:#x} != {expected:#x}")
        self.current_sample += header.block_size
        self.last_header = header
        return samples

    def read_frames_bulk(self, n_frames: int = 256) -> Optional[np.ndarray]:
        """Decode up to ``n_frames`` frames at once via the native decoder,
        returning interleaved int32 samples (None at end of stream).

        Re-runs the Python parser at the failure point to raise the
        precise error when the native decoder stops early.
        """
        nat = _native()
        max_block = self.streaminfo.maximum_block_size or 65535

        buf = self.r.np_view()
        total = self.total_samples
        remaining = None if total is None else total - self.current_sample
        if remaining is not None and remaining <= 0:
            return None
        si = self.streaminfo
        out, sizes, end_bitpos, err = nat.decode_frames(
            buf, self.r.pos, n_frames, si.sample_rate, si.channels,
            si.bits_per_sample, max_block, remaining)
        self.r.pos = end_bitpos
        self.current_sample += int(sizes.sum())
        if err != 0 and len(sizes) < n_frames:
            at_end = (
                # declared total reached exactly
                (total is not None and self.current_sample >= total)
                # unknown total: clean EOF means too few bytes remain for
                # even a frame header (reference: EOF while reading the
                # header ends the stream, decode.rs:1412-1421); a DEC_EOF
                # with a header's worth of bytes left is a truncated frame
                # and must raise via the scalar reparse below
                or (total is None and err == 1
                    and len(buf) * 8 - end_bitpos < 40))
            if not at_end:
                # let the Python parser raise the precise error
                self.r.pos = (self.r.pos + 7) & ~7
                f = self.read_frame()
                if f is not None:
                    extra = interleave(f)
                    out = np.concatenate([out, extra]) if len(out) else extra
        return out if len(out) else None

    def seek(self, sample: int) -> int:
        """Seek to <= ``sample`` using the SEEKTABLE; returns the sample
        actually positioned to (reference: src/decode.rs:1452-1491)."""
        if self.frames_start is None:
            raise NotSeekable()
        table = self.blocks.get(meta.SeekTable)
        target_offset = 0
        target_sample = 0
        if table is not None:
            for p in table.points:
                if not p.is_placeholder and p.sample_offset <= sample:
                    target_offset = p.byte_offset
                    target_sample = p.sample_offset
        self.fp.seek(self.frames_start + target_offset)
        self.r = BitReader.from_stream(self.fp)
        self.current_sample = target_sample
        return target_sample


class Verified(Enum):
    MD5_MATCH = "md5-match"
    MD5_MISMATCH = "md5-mismatch"
    NO_MD5 = "no-md5"


def verify(path_or_fp) -> Verified:
    """Full-decode + MD5 compare (reference: src/decode.rs:1270-1309).

    >>> import io
    >>> from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
    >>> from flac_codec_tpu_torch.decode import verify, Verified
    >>> buf = io.BytesIO()
    >>> opts = Options().with_block_size(16).no_seektable()
    >>> with FlacSampleWriter(buf, opts, 44100, 16, 1,
    ...                       total_samples=16) as w:
    ...     w.write(list(range(16)))
    >>> verify(io.BytesIO(buf.getvalue())) == Verified.MD5_MATCH
    True
    """
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, "rb") as fp:
            return verify(fp)
    dec = Decoder(path_or_fp)
    md5 = hashlib.md5()
    bps = dec.bits_per_sample
    while True:
        chunk = dec.read_frames_bulk()
        if chunk is None:
            break
        md5.update(samples_to_bytes(chunk, bps))
    if dec.streaminfo.md5 is None:
        return Verified.NO_MD5
    return (Verified.MD5_MATCH if md5.digest() == dec.streaminfo.md5
            else Verified.MD5_MISMATCH)


class FlacSampleReader:
    """Interleaved i32 sample reader (reference: src/decode.rs:374-713).

    Example (seek to a sample position, mirrors decode.rs:819-861):

    >>> import io
    >>> from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
    >>> from flac_codec_tpu_torch.decode import FlacSampleReader
    >>> buf = io.BytesIO()
    >>> opts = Options().with_block_size(16).no_seektable()
    >>> with FlacSampleWriter(buf, opts, 44100, 16, 1,
    ...                       total_samples=64) as w:
    ...     w.write(list(range(64)))
    >>> r = FlacSampleReader(io.BytesIO(buf.getvalue()))
    >>> r.seek(40)
    >>> r.read(3).tolist()
    [40, 41, 42]
    """

    def __init__(self, fp_or_path, blocks: Optional[meta.BlockList] = None):
        if isinstance(fp_or_path, (str, bytes)):
            fp_or_path = open(fp_or_path, "rb")
            self._owns_fp = True
        else:
            self._owns_fp = False
        self.decoder = Decoder(fp_or_path, blocks)
        self._buf = np.empty(0, dtype=np.int32)
        self._pos = 0

    # passthrough metadata
    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self.decoder.streaminfo

    def metadata(self) -> meta.BlockList:
        return self.decoder.blocks

    @property
    def channels(self) -> int:
        return self.decoder.channels

    @property
    def sample_rate(self) -> int:
        return self.decoder.sample_rate

    @property
    def bits_per_sample(self) -> int:
        return self.decoder.bits_per_sample

    def fill_buf(self) -> np.ndarray:
        """Buffered interleaved samples, decoding a frame if empty."""
        if self._pos >= len(self._buf):
            frame = self.decoder.read_frame()
            if frame is None:
                return np.empty(0, dtype=np.int32)
            self._buf = interleave(frame)
            self._pos = 0
        return self._buf[self._pos:]

    def consume(self, n: int) -> None:
        self._pos += n

    def read(self, n: int) -> np.ndarray:
        """Read up to ``n`` interleaved samples."""
        out: List[np.ndarray] = []
        got = 0
        while got < n:
            buf = self.fill_buf()
            if buf.size == 0:
                break
            take = min(n - got, buf.size)
            out.append(buf[:take])
            self.consume(take)
            got += take
        if not out:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(out)

    def read_all(self) -> np.ndarray:
        out = [self.fill_buf()] if self._pos < len(self._buf) else []
        if out:
            self.consume(out[0].size)
        while True:
            chunk = self.decoder.read_frames_bulk()
            if chunk is None:
                break
            out.append(chunk)
        if not out:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(out)

    # reference name (src/decode.rs read_to_end): alias of read_all
    read_to_end = read_all

    def seek(self, sample: int) -> None:
        """Position so the next read returns interleaved samples starting at
        channel-independent sample ``sample``."""
        total = self.decoder.total_samples
        if total is not None and sample > total:
            raise InvalidSeek(f"sample {sample} > total {total}")
        actual = self.decoder.seek(sample)
        self._buf = np.empty(0, dtype=np.int32)
        self._pos = 0
        to_skip = (sample - actual) * self.channels
        while to_skip > 0:
            buf = self.fill_buf()
            if buf.size == 0:
                break
            take = min(to_skip, buf.size)
            self.consume(take)
            to_skip -= take

    def __iter__(self):
        while True:
            buf = self.fill_buf()
            if buf.size == 0:
                return
            self.consume(buf.size)
            yield from (int(s) for s in buf)

    def close(self):
        if self._owns_fp:
            self.decoder.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FlacChannelReader:
    """Channel-major (non-interleaved) reader
    (reference: src/decode.rs:907-1097).

    Example: see :class:`flac_codec_tpu_torch.encode.FlacChannelWriter` — the
    two form a channel-major roundtrip pair.
    """

    def __init__(self, fp_or_path, blocks: Optional[meta.BlockList] = None):
        self._owns_fp = isinstance(fp_or_path, (str, bytes))
        if self._owns_fp:
            fp_or_path = open(fp_or_path, "rb")
        self.decoder = Decoder(fp_or_path, blocks)
        self._buf: Optional[np.ndarray] = None
        self._pos = 0

    def close(self):
        if self._owns_fp:
            self.decoder.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self.decoder.streaminfo

    @property
    def channels(self) -> int:
        return self.decoder.channels

    @property
    def sample_rate(self) -> int:
        return self.decoder.sample_rate

    @property
    def bits_per_sample(self) -> int:
        return self.decoder.bits_per_sample

    def fill_buf(self) -> Optional[List[np.ndarray]]:
        if self._buf is None or self._pos >= self._buf.shape[1]:
            frame = self.decoder.read_frame()
            if frame is None:
                return None
            self._buf = frame
            self._pos = 0
        return [ch[self._pos:] for ch in self._buf]

    def consume(self, n: int) -> None:
        self._pos += n

    def read_all(self) -> np.ndarray:
        """All remaining samples as (channels, n)."""
        parts = []
        while True:
            bufs = self.fill_buf()
            if bufs is None:
                break
            parts.append(np.stack(bufs))
            self.consume(parts[-1].shape[1])
        if not parts:
            return np.empty((self.channels, 0), dtype=np.int32)
        return np.concatenate(parts, axis=1)

    def seek(self, sample: int) -> None:
        actual = self.decoder.seek(sample)
        self._buf = None
        self._pos = 0
        to_skip = sample - actual
        while to_skip > 0:
            bufs = self.fill_buf()
            if bufs is None:
                break
            take = min(to_skip, bufs[0].size)
            self.consume(take)
            to_skip -= take


class FlacByteReader:
    """PCM-bytes reader in a chosen endianness with byte-level seeking
    (reference: src/decode.rs:103-331, 715-817).

    Example (byte-level ``seek`` over decoded PCM, decode.rs:718-816):

    >>> import io
    >>> from flac_codec_tpu_torch.encode import FlacByteWriter, Options
    >>> from flac_codec_tpu_torch.decode import FlacByteReader
    >>> pcm = b"".join(i.to_bytes(2, "little") for i in range(64))
    >>> buf = io.BytesIO()
    >>> opts = Options().with_block_size(16).no_seektable()
    >>> with FlacByteWriter(buf, opts, 44100, 16, 1,
    ...                     total_bytes=len(pcm)) as w:
    ...     w.write(pcm)
    >>> r = FlacByteReader(io.BytesIO(buf.getvalue()))
    >>> _ = r.seek(20)
    >>> r.read(4) == pcm[20:24]
    True
    """

    def __init__(self, fp_or_path, big_endian: bool = False,
                 blocks: Optional[meta.BlockList] = None):
        self._samples = FlacSampleReader(fp_or_path, blocks)
        self.big_endian = big_endian
        self._byte_buf = b""
        self._byte_pos = 0
        self._abs_pos = 0

    # constructors mirroring the reference surface
    @classmethod
    def open(cls, path: str, big_endian: bool = False) -> "FlacByteReader":
        return cls(path, big_endian)

    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self._samples.streaminfo

    def metadata(self) -> meta.BlockList:
        return self._samples.metadata()

    @property
    def _frame_bytes(self) -> int:
        si = self.streaminfo
        return bytes_per_sample(si.bits_per_sample) * si.channels

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._byte_pos >= len(self._byte_buf):
                buf = self._samples.fill_buf()
                if buf.size == 0:
                    break
                self._samples.consume(buf.size)
                self._byte_buf = samples_to_bytes(
                    buf, self.streaminfo.bits_per_sample, self.big_endian)
                self._byte_pos = 0
            avail = len(self._byte_buf) - self._byte_pos
            take = avail if n < 0 else min(avail, n - len(out))
            out += self._byte_buf[self._byte_pos:self._byte_pos + take]
            self._byte_pos += take
        self._abs_pos += len(out)
        return bytes(out)

    def tell(self) -> int:
        return self._abs_pos

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        si = self.streaminfo
        width = bytes_per_sample(si.bits_per_sample) * si.channels
        if whence == io.SEEK_SET:
            target = offset
        elif whence == io.SEEK_CUR:
            target = self._abs_pos + offset
        elif whence == io.SEEK_END:
            if si.total_samples is None:
                raise NotSeekable("total samples unknown")
            target = si.total_samples * width + offset
        else:
            raise ValueError(f"bad whence {whence}")
        if target < 0:
            raise InvalidSeek(str(target))
        sample, rem = divmod(target, width)
        self._samples.seek(sample)
        self._byte_buf = b""
        self._byte_pos = 0
        self._abs_pos = sample * width
        if rem:
            self.read(rem)
        return self._abs_pos

    def close(self):
        self._samples.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class FrameBuf:
    """One decoded frame from a metadata-less stream
    (reference: src/decode.rs FrameBuf)."""

    samples: np.ndarray  # interleaved
    sample_rate: int
    channels: int
    bits_per_sample: int


class FlacStreamReader:
    """Metadata-less raw frame stream decoder with sync-code scanning
    (reference: src/decode.rs:1149-1268).

    Parameters may change from frame to frame; each read returns a
    FrameBuf.  Re-syncs by scanning for the 15-bit sync code, tolerating
    codes split across buffer refills.
    """

    def __init__(self, fp: BinaryIO):
        self.r = BitReader.from_stream(fp)

    def read_frame(self) -> Optional[FrameBuf]:
        # scan for sync code: 0xFF byte followed by top bits 111110
        self.r.discard_consumed()
        while True:
            if self.r.at_eof():
                return None
            start = self.r.abs_byte_pos
            try:
                b0 = self.r.read(8)
                if b0 != 0xFF:
                    self.r.discard_consumed()
                    continue
                b1 = self.r.read(8)
                if (b1 >> 2) != 0b111110:
                    # could be 0xFF 0xFF — re-examine from second byte
                    if b1 == 0xFF:
                        self.r.pos -= 8
                    self.r.discard_consumed()
                    continue
            except EndOfStream:
                return None
            # rewind to frame start and parse properly
            self.r.pos -= 16
            try:
                header = FrameHeader.read(self.r, None)
                samples = read_subframes(self.r, header)
                crc_pos = self.r.abs_byte_pos
                expected = self.r.read(16)
                actual = crcmod.crc16(self.r.buffer_slice(start, crc_pos))
                if actual != expected:
                    raise Crc16Mismatch()
                return FrameBuf(
                    samples=interleave(samples),
                    sample_rate=header.sample_rate,
                    channels=header.channel_count,
                    bits_per_sample=header.bits_per_sample,
                )
            except EndOfStream:
                return None
            except FlacError:
                # bad sync — resume scanning one byte past the candidate
                self.r.pos = (start - self.r._base) * 8 + 8
                self.r.discard_consumed()
