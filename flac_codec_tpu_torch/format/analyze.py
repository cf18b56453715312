"""Structured whole-frame analysis model (reference: src/stream.rs:1621-2035
``Frame``/``Subframe``/``FrameIterator``).

Parses frames into inspectable structures — subframe types, orders, wasted
bits, LPC parameters, residual partitioning — without reconstructing PCM.
Drives flac-analyze and seektable generation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from .. import metadata as meta
from ..bitio import BitReader
from ..errors import (
    EndOfStream,
    ExcessiveWastedBits,
    InvalidCodingMethod,
    InvalidPartitionOrder,
    InvalidQlpPrecision,
    NegativeLpcShift,
)
from .frame import ChannelAssignment, FrameHeader
from .subframe import read_subframe_header


@dataclass
class PartitionInfo:
    kind: str            # rice | escape | constant
    parameter: int       # rice parameter or escape size
    sample_count: int


@dataclass
class SubframeInfo:
    type: str            # constant | verbatim | fixed | lpc
    order: int
    wasted_bps: int
    precision: Optional[int] = None   # lpc only
    shift: Optional[int] = None       # lpc only
    coefficients: Optional[np.ndarray] = None
    coding_method: Optional[int] = None
    partition_order: Optional[int] = None
    partitions: List[PartitionInfo] = field(default_factory=list)


@dataclass
class FrameInfo:
    header: FrameHeader
    subframes: List[SubframeInfo]
    byte_size: int = 0


def _skip_residuals(r: BitReader, predictor_order: int, block_size: int,
                    info: SubframeInfo) -> None:
    method = r.read(2)
    if method > 1:
        raise InvalidCodingMethod(str(method))
    rice_bits, escape_code = (4, 0b1111) if method == 0 else (5, 0b11111)
    info.coding_method = method
    po = r.read(4)
    info.partition_order = po
    count = 1 << po
    part_len = block_size // count
    n_res = block_size - predictor_order
    p0 = n_res - (count - 1) * part_len
    if part_len == 0 or not 1 <= p0 <= part_len:
        raise InvalidPartitionOrder(str(po))
    for p in range(count):
        n = p0 if p == 0 else part_len
        param = r.read(rice_bits)
        if param == escape_code:
            width = r.read(5)
            if width == 0:
                info.partitions.append(PartitionInfo("constant", 0, n))
            else:
                info.partitions.append(PartitionInfo("escape", width, n))
                r.read_signed_array(n, width)
        else:
            info.partitions.append(PartitionInfo("rice", param, n))
            r.read_rice_array(n, param)


def parse_subframe(r: BitReader, bits_per_sample: int, n: int) -> SubframeInfo:
    header = read_subframe_header(r)
    eff = bits_per_sample - header.wasted_bps
    if eff <= 0:
        raise ExcessiveWastedBits()
    info = SubframeInfo(header.type, header.order, header.wasted_bps)
    if header.type == "constant":
        r.read_signed(eff)
    elif header.type == "verbatim":
        r.read_signed_array(n, eff)
    elif header.type == "fixed":
        r.read_signed_array(header.order, eff)
        _skip_residuals(r, header.order, n, info)
    else:
        r.read_signed_array(header.order, eff)
        pcode = r.read(4)
        if pcode == 0b1111:
            raise InvalidQlpPrecision()
        info.precision = pcode + 1
        info.shift = r.read_signed(5)
        if info.shift < 0:
            raise NegativeLpcShift()
        info.coefficients = r.read_signed_array(header.order, info.precision)
        _skip_residuals(r, header.order, n, info)
    return info


def parse_frame(r: BitReader, streaminfo=None) -> FrameInfo:
    """Parse one frame structurally (header + subframes + CRC-16 skip)."""
    start = r.abs_byte_pos
    header = FrameHeader.read(r, streaminfo)
    subframes = []
    ca = header.channel_assignment
    for ch in range(header.channel_count):
        bps = header.bits_per_sample
        if ChannelAssignment.side_channel(ca) == ch:
            bps += 1
        subframes.append(parse_subframe(r, bps, header.block_size))
    r.byte_align()
    r.read(16)  # CRC-16
    return FrameInfo(header, subframes, byte_size=r.abs_byte_pos - start)


class FrameIterator:
    """Iterate (FrameInfo, byte_offset) over a FLAC file (reference:
    src/stream.rs:1930-2035).  Offsets are absolute file positions."""

    def __init__(self, fp: BinaryIO):
        self.blocks = meta.read_blocks(fp)
        self.metadata_len = fp.tell()
        self.r = BitReader.from_stream(fp)
        self._samples_remaining = self.blocks.streaminfo.total_samples

    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self.blocks.streaminfo

    def __iter__(self) -> Iterator[Tuple[FrameInfo, int]]:
        while True:
            self.r.discard_consumed()
            if self._samples_remaining is not None and self._samples_remaining <= 0:
                return
            if self.r.at_eof():
                return
            offset = self.metadata_len + self.r.abs_byte_pos
            try:
                frame = parse_frame(self.r, self.streaminfo)
            except EndOfStream:
                if self._samples_remaining is None:
                    return
                raise
            if self._samples_remaining is not None:
                self._samples_remaining -= frame.header.block_size
            yield frame, offset
