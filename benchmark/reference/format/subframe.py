# Frozen copy of flac_codec_tpu_torch/format/subframe.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Subframe header + residual partition codecs (reference:
src/stream.rs:1358-1619, 2754-3079).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitio import BitReader, BitWriter
from ..errors import (
    InvalidCodingMethod,
    InvalidPartitionOrder,
    InvalidSubframeHeader,
)

# Fixed predictor coefficients per order, already reversed to "most recent
# sample first" (reference: src/stream.rs:1534 FIXED_COEFFS).
FIXED_COEFFS = [
    np.array([], dtype=np.int32),
    np.array([1], dtype=np.int32),
    np.array([2, -1], dtype=np.int32),
    np.array([3, -3, 1], dtype=np.int32),
    np.array([4, -6, 4, -1], dtype=np.int32),
]

CONSTANT = "constant"
VERBATIM = "verbatim"
FIXED = "fixed"
LPC = "lpc"


@dataclass
class SubframeHeader:
    """Parsed subframe header (reference: src/stream.rs:1374-1413)."""

    type: str      # constant | verbatim | fixed | lpc
    order: int     # 0-4 for fixed, 1-32 for lpc, 0 otherwise
    wasted_bps: int

    def write(self, w: BitWriter) -> None:
        w.write(0, 1)  # pad
        if self.type == CONSTANT:
            w.write(0b000000, 6)
        elif self.type == VERBATIM:
            w.write(0b000001, 6)
        elif self.type == FIXED:
            w.write(0b001000 | self.order, 6)
        elif self.type == LPC:
            w.write(0b100000 | (self.order - 1), 6)
        else:
            raise InvalidSubframeHeader(self.type)
        if self.wasted_bps == 0:
            w.write_bit(False)
        else:
            w.write_bit(True)
            w.write_unary(self.wasted_bps - 1)


def read_subframe_header(r: BitReader) -> SubframeHeader:
    if r.read(1) != 0:
        raise InvalidSubframeHeader("pad bit set")
    code = r.read(6)
    if code == 0b000000:
        type_, order = CONSTANT, 0
    elif code == 0b000001:
        type_, order = VERBATIM, 0
    elif 0b001000 <= code <= 0b001100:
        type_, order = FIXED, code - 0b001000
    elif code >= 0b100000:
        type_, order = LPC, (code & 0b011111) + 1
    else:
        raise InvalidSubframeHeader(f"reserved type code {code:#08b}")
    wasted = 0
    if r.read_bit():
        wasted = r.read_unary() + 1
    return SubframeHeader(type_, order, wasted)


def read_residuals(r: BitReader, predictor_order: int, block_size: int) -> np.ndarray:
    """Read the residual section of a FIXED/LPC subframe into int64
    (reference: src/decode.rs:1800-1856).

    Partition p0 holds ``block/parts - order`` residuals, the rest
    ``block/parts`` each.
    """
    method = r.read(2)
    if method == 0:
        rice_bits, escape_code = 4, 0b1111
    elif method == 1:
        rice_bits, escape_code = 5, 0b11111
    else:
        raise InvalidCodingMethod(f"method {method}")
    partition_order = r.read(4)
    partition_count = 1 << partition_order
    # Mirror the reference's acceptance rule: residuals split into
    # rchunks(block/count) must yield exactly `count` chunks
    # (reference: src/decode.rs:1815-1819).
    n_res = block_size - predictor_order
    part_len = block_size // partition_count
    if part_len == 0 or n_res <= 0:
        raise InvalidPartitionOrder(
            f"order {partition_order} for block {block_size}")
    p0_len = n_res - (partition_count - 1) * part_len
    if not 1 <= p0_len <= part_len:
        raise InvalidPartitionOrder(
            f"order {partition_order} for block {block_size}")

    out = np.empty(n_res, dtype=np.int64)
    pos = 0
    for p in range(partition_count):
        n = p0_len if p == 0 else part_len
        param = r.read(rice_bits)
        if param == escape_code:
            width = r.read(5)
            if width == 0:
                out[pos:pos + n] = 0
            else:
                out[pos:pos + n] = r.read_signed_array(n, width)
        else:
            out[pos:pos + n] = r.read_rice_array(n, param)
        pos += n
    return out


def write_residuals_verbatim(w: BitWriter, partitions, rice_bits: int) -> None:
    """Write residual partitions given explicit (kind, param, values) tuples.

    ``partitions`` is a list of ("rice", k, values) / ("escape", width,
    values) / ("constant", 0, n) entries; used by the host encoder once the
    partition search has chosen parameters.
    """
    escape_code = (1 << rice_bits) - 1
    w.write(0 if rice_bits == 4 else 1, 2)
    w.write(len(partitions).bit_length() - 1, 4)  # exact: count is 2**po
    # the whole section as one list of fields (value, value bits, width),
    # packed in one call
    fields = []

    def field(value: int, nbits: int) -> None:
        fields.append((np.array([value], dtype=np.uint64),
                       np.array([nbits]), np.array([nbits])))

    for kind, param, values in partitions:
        if kind == "rice":
            field(param, rice_bits)
            v = np.asarray(values).astype(np.int64)
            u = np.where(v < 0, ((-v - 1) << 1) + 1, v << 1).astype(np.uint64)
            q = (u >> np.uint64(param)).astype(np.int64)
            # a code: q zeros, then the stop bit and the param low bits
            low = u & np.uint64((1 << param) - 1)
            fields.append(((np.uint64(1) << np.uint64(param)) | low,
                           np.full(len(v), param + 1), q + param + 1))
        elif kind == "escape":
            field(escape_code, rice_bits)
            field(param, 5)
            if param and len(values):
                v = np.asarray(values).astype(np.int64)
                lo, hi = -(1 << (param - 1)), (1 << (param - 1)) - 1
                if int(v.min()) < lo or int(v.max()) > hi:
                    raise OverflowError(
                        f"value out of range for {param}-bit write")
                fields.append((v.astype(np.uint64), np.full(len(v), param),
                               np.full(len(v), param)))
        else:  # constant
            field(escape_code, rice_bits)
            field(0, 5)
    w.write_fields(*(np.concatenate(f) for f in zip(*fields)))
