# Frozen copy of flac_codec_tpu_torch/decode.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Decode layer: the core frame decoder and ``FlacSampleReader``
(interleaved i32; reference: src/decode.rs:374-713, 1311-1491).  The
program's other readers (bytes, channels, sync scan, ``verify``) are left
out of this copy: the benchmark decodes through these two alone."""

from __future__ import annotations

import io
from typing import BinaryIO, List, Optional

import numpy as np

from . import crc as crcmod
from . import metadata as meta
from .bitio import BitReader
from .byteorder import interleave
from .errors import (
    Crc16Mismatch,
    EndOfStream,
    ExcessiveWastedBits,
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


def predict(coefficients: np.ndarray, qlp_shift: int, channel: np.ndarray) -> None:
    """In-place LPC synthesis recurrence on an int64 channel buffer:
    ``x[n] += (sum_j q[j] * x[n-1-j]) >> shift``
    (reference: src/decode.rs:1738-1752).
    """
    order = len(coefficients)
    if order == 0 or len(channel) <= order:
        return
    q = [int(c) for c in coefficients]
    x = channel
    for i in range(order, len(x)):
        acc = 0
        for j in range(order):
            acc += q[j] * int(x[i - 1 - j])
        x[i] += acc >> qlp_shift


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
        """Decode up to ``n_frames`` frames, one at a time through the
        Python parser, returning interleaved int32 samples (None at end of
        stream)."""
        frames = []
        for _ in range(n_frames):
            f = self.read_frame()
            if f is None:
                break
            frames.append(interleave(f))
        if not frames:
            return None
        return np.concatenate(frames)

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


class FlacSampleReader:
    """Interleaved i32 sample reader (reference: src/decode.rs:374-713).

    Example (seek to a sample position, mirrors decode.rs:819-861):

    >>> import io
    >>> from benchmark.reference.encode import FlacSampleWriter, Options
    >>> from benchmark.reference.decode import FlacSampleReader
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
