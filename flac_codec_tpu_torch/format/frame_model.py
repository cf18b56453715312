"""Structured whole-frame model: parse frames into complete data
structures and rebuild the original bytes exactly.

This is the reference's "Analyzes Files" capability (README.md: "Parses
FLAC files to Rust data structures / Can rebuild FLAC files from those
same data structures / round-trip files that are byte-for-byte identical"
— the `Frame` read/build pair at src/stream.rs:1679-1928): unlike
`format.analyze`, which skips residual payloads, this model captures
every warm-up sample, coefficient, and residual partition verbatim, so a
stream can be inspected, transformed, and re-serialized without decoding
to PCM.

Exactness notes: subframe bodies re-serialize from structure (the
type/order/wasted/partition encodings are bijective), while the frame
header's raw bytes are preserved alongside the parsed fields — FLAC
headers admit multiple encodings of the same values (e.g. an uncommon
block-size escape spelling a common size), and the reference keeps the
chosen variant in its enums for the same reason.  The CRC-16 is
recomputed on write, which doubles as a self-check: it can only match
the original when every bit upstream matched.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, List, Optional

import numpy as np

from .. import metadata as meta
from ..bitio import BitReader, BitWriter
from ..crc import crc16
from ..errors import InvalidSubframeHeader
from .frame import FrameHeader
from .subframe import (CONSTANT, FIXED, LPC, VERBATIM, SubframeHeader,
                       read_subframe_header, write_residuals_verbatim)


@dataclass
class PartitionData:
    """One residual partition, exactly as coded in the stream."""

    kind: str                 # "rice" | "escape" | "constant"
    param: int                # rice parameter or escape width (0 if constant)
    values: np.ndarray        # residuals (empty for "constant")
    count: int = 0            # residual count for "constant" partitions


@dataclass
class SubframeData:
    header: SubframeHeader
    bits_per_sample: int                      # effective, incl. side +1
    constant: Optional[int] = None            # CONSTANT value
    verbatim: Optional[np.ndarray] = None     # VERBATIM samples
    warmup: Optional[np.ndarray] = None       # FIXED/LPC warm-up samples
    precision: Optional[int] = None           # LPC coefficient precision
    shift: Optional[int] = None               # LPC quantization shift
    coefficients: Optional[np.ndarray] = None
    rice_bits: Optional[int] = None           # 4 (method 0) or 5 (method 1)
    partitions: List[PartitionData] = field(default_factory=list)


@dataclass
class FrameData:
    header: FrameHeader
    header_bytes: bytes       # raw header incl. CRC-8 (variant-preserving)
    subframes: List[SubframeData]
    crc16: int

    def write(self, w: BitWriter) -> None:
        """Re-serialize; byte-identical to the parsed stream."""
        w.byte_align()
        body = BitWriter()
        body.write_bytes(self.header_bytes)
        for sf in self.subframes:
            _write_subframe(body, sf)
        body.byte_align()
        payload = body.getvalue()
        w.write_bytes(payload)
        w.write(crc16(payload), 16)


def _read_structured_residuals(r: BitReader, order: int, block_size: int):
    """Like subframe.read_residuals but keeps the partition structure
    (reference: src/stream.rs:2973-3079)."""
    from ..errors import InvalidCodingMethod, InvalidPartitionOrder

    method = r.read(2)
    if method not in (0, 1):
        raise InvalidCodingMethod(f"method {method}")
    rice_bits = 4 if method == 0 else 5
    escape_code = (1 << rice_bits) - 1
    partition_order = r.read(4)
    count = 1 << partition_order
    part_len = block_size // count
    n_res = block_size - order
    if part_len == 0 or n_res <= 0:
        raise InvalidPartitionOrder(
            f"order {partition_order} for block {block_size}")
    p0_len = n_res - (count - 1) * part_len
    if not 1 <= p0_len <= part_len:
        raise InvalidPartitionOrder(
            f"order {partition_order} for block {block_size}")
    parts: List[PartitionData] = []
    for p in range(count):
        n = p0_len if p == 0 else part_len
        param = r.read(rice_bits)
        if param == escape_code:
            width = r.read(5)
            if width == 0:
                parts.append(PartitionData("constant", 0,
                                           np.empty(0, np.int64), n))
            else:
                parts.append(PartitionData(
                    "escape", width, r.read_signed_array(n, width)))
        else:
            parts.append(PartitionData(
                "rice", param, r.read_rice_array(n, param)))
    return rice_bits, parts


def parse_subframe_data(r: BitReader, bps: int, n: int) -> SubframeData:
    hdr = read_subframe_header(r)
    if hdr.wasted_bps >= bps:
        raise InvalidSubframeHeader(
            f"wasted bits {hdr.wasted_bps} >= bps {bps}")
    eff = bps - hdr.wasted_bps
    sf = SubframeData(hdr, bps)
    if hdr.type == CONSTANT:
        sf.constant = r.read_signed(eff)
    elif hdr.type == VERBATIM:
        sf.verbatim = r.read_signed_array(n, eff)
    elif hdr.type == FIXED:
        sf.warmup = r.read_signed_array(hdr.order, eff)
        sf.rice_bits, sf.partitions = _read_structured_residuals(r, hdr.order, n)
    else:  # LPC
        sf.warmup = r.read_signed_array(hdr.order, eff)
        pcode = r.read(4)
        if pcode == 0xF:
            raise InvalidSubframeHeader("invalid coefficient precision")
        sf.precision = pcode + 1
        sf.shift = r.read_signed(5)
        if sf.shift < 0:
            raise InvalidSubframeHeader("negative LPC shift")
        sf.coefficients = r.read_signed_array(hdr.order, sf.precision)
        sf.rice_bits, sf.partitions = _read_structured_residuals(r, hdr.order, n)
    return sf


def _write_subframe(w: BitWriter, sf: SubframeData) -> None:
    sf.header.write(w)
    eff = sf.bits_per_sample - sf.header.wasted_bps
    if sf.header.type == CONSTANT:
        w.write_signed(int(sf.constant), eff)
        return
    if sf.header.type == VERBATIM:
        w.write_signed_array(sf.verbatim, eff)
        return
    w.write_signed_array(sf.warmup, eff)
    if sf.header.type == LPC:
        w.write(sf.precision - 1, 4)
        w.write_signed(sf.shift, 5)
        w.write_signed_array(sf.coefficients, sf.precision)
    tuples = [(p.kind, p.param, p.values if p.kind != "constant" else p.count)
              for p in sf.partitions]
    write_residuals_verbatim(w, tuples, sf.rice_bits)


def parse_frame_data(r: BitReader,
                     streaminfo: Optional[meta.Streaminfo] = None) -> FrameData:
    """Parse one complete frame starting at the reader's (byte-aligned)
    position; CRC-16 is validated."""
    start_byte = r.abs_byte_pos
    hdr = FrameHeader.read(r, streaminfo)
    hdr_end = r.abs_byte_pos
    header_bytes = bytes(r.buffer_slice(start_byte, hdr_end))
    subframes = []
    ca = hdr.channel_assignment
    for c in range(hdr.channel_count):
        bps = hdr.bits_per_sample
        # side channels carry one extra bit (reference: src/stream.rs:903-936)
        if (ca == 0b1000 and c == 1) or (ca == 0b1001 and c == 0) \
                or (ca == 0b1010 and c == 1):
            bps += 1
        subframes.append(parse_subframe_data(r, bps, hdr.block_size))
    r.byte_align()
    body_end = r.abs_byte_pos
    expected = r.read(16)
    actual = crc16(bytes(r.buffer_slice(start_byte, body_end)))
    if actual != expected:
        from ..errors import Crc16Mismatch

        raise Crc16Mismatch(f"frame at byte {start_byte}")
    return FrameData(hdr, header_bytes, subframes, expected)


def iter_frame_data(fp: BinaryIO) -> Iterator[FrameData]:
    """Yield a FrameData per frame of a FLAC file."""
    import io as _io

    data = fp.read() if not isinstance(fp, (bytes, bytearray)) else bytes(fp)
    bio = _io.BytesIO(data)
    blocks = meta.read_blocks(bio)
    si = blocks.streaminfo
    r = BitReader(data[bio.tell():])
    total = si.total_samples or None
    decoded = 0
    while not (total is not None and decoded >= total) and not r.at_eof():
        fd = parse_frame_data(r, si)
        decoded += fd.header.block_size
        yield fd


def rebuild_stream(fp: BinaryIO) -> bytes:
    """Parse every metadata block and frame of a FLAC file into structures
    and re-serialize the whole stream from them; byte-for-byte identical
    to the input for any valid fixed- or variable-blocksize stream
    (reference: README.md "Analyzes Files" round-trip claim)."""
    import io as _io

    data = fp.read() if not isinstance(fp, (bytes, bytearray)) else bytes(fp)
    bio = _io.BytesIO(data)
    blocks = meta.read_blocks(bio)
    si = blocks.streaminfo
    frames_start = bio.tell()
    out_meta = _io.BytesIO()
    meta.write_blocks(out_meta, blocks)

    r = BitReader(data[frames_start:])
    w = BitWriter()
    total = si.total_samples or None
    decoded = 0
    while not (total is not None and decoded >= total) and not r.at_eof():
        fd = parse_frame_data(r, si)
        fd.write(w)
        decoded += fd.header.block_size
    return out_meta.getvalue() + w.getvalue()
