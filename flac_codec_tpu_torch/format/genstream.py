"""Conformance-stream generator: build arbitrary valid FLAC streams frame
by frame, with full control over every format feature the decoder must
handle — the stand-in for the IETF decoder testbench the reference is
validated against (reference README.md:53-55; header/subframe/partition
semantics per src/stream.rs:84-1356, 1358-1619, 2754-3079).

Streams are constructed residuals-first: each subframe spec carries the
warm-ups/residuals (or literal samples), the generator reconstructs the
channel signal by running the predictor, applies inverse stereo
decorrelation for the PCM oracle, and serializes headers, subframes,
partitions and CRCs directly through the format layer.  The returned
(stream_bytes, pcm) pair lets tests assert bit-level acceptance AND
sample-exact decode including MD5.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import crc as crcmod
from .. import metadata as meta
from ..bitio import BitWriter
from ..byteorder import samples_to_bytes
from .frame import ChannelAssignment, FrameHeader
from .subframe import (CONSTANT, FIXED, FIXED_COEFFS, LPC, VERBATIM,
                       SubframeHeader, write_residuals_verbatim)


def _predict(coeffs: np.ndarray, shift: int, x: np.ndarray) -> None:
    """In-place x[n] += (sum q_j x[n-1-j]) >> shift (int64 exact;
    reference: src/decode.rs:1738-1752)."""
    order = len(coeffs)
    q = coeffs.astype(np.int64)
    for i in range(order, len(x)):
        acc = int((q * x[i - order:i][::-1]).sum())
        x[i] += acc >> shift


@dataclass
class SubframeSpec:
    """One subframe's exact wire content.

    type:    constant | verbatim | fixed | lpc
    values:  CONSTANT -> scalar in values[0]; VERBATIM -> all samples;
             FIXED/LPC -> warm-ups (order values) in ``warmups`` and
             residuals in ``residuals``.
    partitions: explicit residual partitioning as a list of
             ("rice", k, n) / ("escape", width, n) / ("constant", 0, n)
             tuples whose n sum to block - order; None -> one auto-k rice
             partition (partition order 0).
    """

    type: str = VERBATIM
    values: Optional[np.ndarray] = None
    warmups: Optional[np.ndarray] = None
    residuals: Optional[np.ndarray] = None
    order: int = 0
    coeffs: Optional[np.ndarray] = None     # LPC quantized coefficients
    shift: int = 0                          # LPC shift (0..15)
    precision: int = 15                     # LPC coeff precision in bits
    wasted: int = 0
    partition_order: Optional[int] = None   # None -> 0
    rice2: bool = False                     # 5-bit Rice parameters
    partition_kinds: Optional[Sequence[str]] = None  # per-partition kind

    def signal(self, block_size: int) -> np.ndarray:
        """Reconstructed (pre-wasted-shift) subframe signal, the decode
        oracle for this subframe."""
        if self.type == CONSTANT:
            return np.full(block_size, int(self.values[0]), dtype=np.int64)
        if self.type == VERBATIM:
            assert len(self.values) == block_size
            return np.asarray(self.values, dtype=np.int64).copy()
        coeffs = (np.asarray(self.coeffs) if self.type == LPC
                  else FIXED_COEFFS[self.order])
        shift = self.shift if self.type == LPC else 0
        x = np.concatenate([
            np.asarray(self.warmups, dtype=np.int64),
            np.asarray(self.residuals, dtype=np.int64)])
        assert len(x) == block_size, (len(x), block_size)
        _predict(np.asarray(coeffs), shift, x)
        return x

    def write(self, w: BitWriter, bps: int, block_size: int) -> None:
        eff = bps - self.wasted
        SubframeHeader(self.type, self.order, self.wasted).write(w)
        if self.type == CONSTANT:
            w.write_signed(int(self.values[0]), eff)
            return
        if self.type == VERBATIM:
            w.write_signed_array(np.asarray(self.values, np.int64), eff)
            return
        w.write_signed_array(np.asarray(self.warmups, np.int64), eff)
        if self.type == LPC:
            w.write(self.precision - 1, 4)
            w.write_signed(self.shift, 5)
            for c in np.asarray(self.coeffs):
                w.write_signed(int(c), self.precision)
        res = np.asarray(self.residuals, dtype=np.int64)
        po = self.partition_order or 0
        count = 1 << po
        part_len = block_size // count
        lens = [part_len - self.order] + [part_len] * (count - 1)
        assert sum(lens) == len(res) and min(lens) >= 1, \
            f"partition order {po} invalid for block {block_size}"
        kinds = self.partition_kinds or ["rice"] * count
        rice_bits = 5 if self.rice2 else 4
        parts = []
        pos = 0
        for kind, n in zip(kinds, lens):
            vals = res[pos:pos + n]
            pos += n
            if kind == "constant":
                assert not vals.any(), "constant partition needs 0 residuals"
                parts.append(("constant", 0, vals))
            elif kind == "escape":
                width = max(int(np.abs(vals).max()).bit_length() + 1, 1) \
                    if len(vals) and vals.any() else 1
                parts.append(("escape", width, vals))
            else:
                k = _auto_rice(vals, rice_bits)
                parts.append(("rice", k, vals))
        write_residuals_verbatim(w, parts, rice_bits)


def _auto_rice(vals: np.ndarray, rice_bits: int) -> int:
    """Smallest reasonable Rice parameter for the given residuals."""
    if not len(vals):
        return 0
    mean = max(int(np.abs(vals).mean()), 0)
    k = max(mean * 2, 1).bit_length() - 1
    return min(k, (1 << rice_bits) - 2)


@dataclass
class FrameSpec:
    """One frame: block size, channel assignment, subframe specs."""

    block_size: int
    subframes: List[SubframeSpec]
    assignment: Optional[int] = None   # default independent

    def pcm(self) -> np.ndarray:
        """(C, N) int64 decode oracle (post decorrelation + wasted)."""
        sigs = [s.signal(self.block_size) << s.wasted
                for s in self.subframes]
        a = self.assignment
        if a is None or a <= 0b0111:
            return np.stack(sigs)
        s0, s1 = sigs
        if a == ChannelAssignment.LEFT_SIDE:
            return np.stack([s0, s0 - s1])
        if a == ChannelAssignment.SIDE_RIGHT:
            return np.stack([s0 + s1, s1])
        total = s0 * 2 + (np.abs(s1) % 2)
        return np.stack([(total + s1) >> 1, (total - s1) >> 1])


def build_frame(spec: FrameSpec, number: int, sample_rate: int, bps: int,
                variable: bool = False,
                streaminfo: Optional[meta.Streaminfo] = None) -> bytes:
    """Serialize one frame (header + subframes + CRC-16).  ``number`` is
    the frame number (fixed blocking) or first-sample number (variable).
    Pass ``streaminfo`` to force the non-subset escapes (sample rate / bps
    taken from STREAMINFO, reference: src/stream.rs:214-240)."""
    a = (spec.assignment if spec.assignment is not None
         else ChannelAssignment.independent(len(spec.subframes)))
    hdr = FrameHeader(
        blocking_strategy=variable, block_size=spec.block_size,
        sample_rate=sample_rate, channel_assignment=a,
        bits_per_sample=bps, frame_number=number)
    w = BitWriter()
    hdr.write(w)
    side = ChannelAssignment.side_channel(a)
    for c, sub in enumerate(spec.subframes):
        sub.write(w, bps + (1 if c == side else 0), spec.block_size)
    w.byte_align()
    body = w.getvalue()
    w2 = BitWriter()
    w2.write_bytes(body)
    w2.write(crcmod.crc16(body), 16)
    return w2.getvalue()


def build_stream(frames: Sequence[FrameSpec], sample_rate: int = 44100,
                 bps: int = 16, variable: bool = False,
                 non_subset: bool = False,
                 declare_total: bool = True,
                 extra_blocks: Sequence = ()) -> Tuple[bytes, np.ndarray]:
    """Assemble a complete FLAC file; returns (bytes, interleaved PCM
    oracle).  STREAMINFO min/max block sizes, total samples and MD5 are
    derived from the frames."""
    channels = len(frames[0].subframes)
    pcms = [f.pcm() for f in frames]
    inter = np.concatenate([p.T.reshape(-1) for p in pcms])
    total = sum(f.block_size for f in frames)
    md5 = hashlib.md5(samples_to_bytes(inter, bps)).digest()
    si = meta.Streaminfo(
        minimum_block_size=min(f.block_size for f in frames),
        maximum_block_size=max(f.block_size for f in frames),
        sample_rate=sample_rate, channels=channels, bits_per_sample=bps,
        total_samples=total if declare_total else None, md5=md5)
    import io

    out = io.BytesIO()
    blocks = meta.BlockList(si, list(extra_blocks))
    meta.write_blocks(out, blocks)
    number = 0
    for f in frames:
        out.write(build_frame(f, number, sample_rate, bps, variable,
                              streaminfo=si if non_subset else None))
        number += f.block_size if variable else 1
    return out.getvalue(), inter
