# Frozen copy of flac_codec_tpu_torch/rice.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Rice partition search + residual cost model (host; reference:
src/encode.rs:3747-3962 write_residuals).

Given a residual array, chooses the partition order and per-partition Rice
parameters/escapes minimizing the reference's estimated-bits cost model,
then describes the partitions for serialization.  The batched device mirror
lives in ops/rice.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MAX_PARTITIONS = 64  # reference: src/encode.rs:3756

U32_MAX = (1 << 32) - 1


def _partition_costs(abs_sums: np.ndarray, lens: np.ndarray, rice_max: int):
    """Vectorized cost + coding decision for one candidate order.

    Returns (total_estimated_bits, const_mask, escape_mask, rice_params,
    escape_sizes) or None if the candidate must be dropped (mirrors the
    Option-collect in the reference's best_partitions).  The per-partition
    Python loop this replaces was the host encoder's hottest function
    (~40% of encode at preset -8); only the rare escape partitions still
    loop (they need exact integer bit_length).
    """
    s = abs_sums
    n = lens
    if len(s) <= 8:
        # numpy per-op overhead beats the plain loop at tiny counts
        return _partition_costs_scalar(s, n, rice_max)
    if bool((n == 0).any()):
        return None
    const = s == 0
    gt = s > n
    bn = np.zeros(len(s), dtype=np.int64)
    if bool(gt.any()):
        # float division exactly as the scalar code did: the cost model's
        # rounding is part of the stream-level behavior
        bn[gt] = np.ceil(
            np.log2(s[gt].astype(np.float64) / n[gt].astype(np.float64))
        ).astype(np.int64)
    esc = gt & (bn >= rice_max)
    rice = np.where(gt & ~esc, bn, 0)
    live = ~const & ~esc
    tail = np.where(rice > 0, s >> np.maximum(rice - 1, 0), s << 1)
    size = 4 + (1 + rice) * n + tail - n // 2
    if bool((tail[live] > U32_MAX).any()) or bool((size[live] > U32_MAX).any()):
        return None
    total = int(size[live].sum())
    esc_sizes = np.zeros(len(s), dtype=np.int64)
    for i in np.nonzero(esc)[0]:
        escape_size = int(s[i]).bit_length() - 1 + 2  # ilog2(sum) + 2
        if escape_size > 31:
            return None
        esc_sizes[i] = escape_size
        total += escape_size * int(n[i])
    return total, const, esc, rice, esc_sizes


def _partition_costs_scalar(abs_sums: np.ndarray, lens: np.ndarray,
                            rice_max: int):
    """Scalar twin of _partition_costs for small partition counts."""
    count = len(abs_sums)
    const = np.zeros(count, dtype=bool)
    esc = np.zeros(count, dtype=bool)
    rice = np.zeros(count, dtype=np.int64)
    esc_sizes = np.zeros(count, dtype=np.int64)
    total = 0
    for i, (s, n) in enumerate(zip(abs_sums.tolist(), lens.tolist())):
        if n == 0:
            return None
        if s == 0:
            const[i] = True
            continue
        if s > n:
            bits_needed = int(np.ceil(np.log2(float(s) / float(n))))
            if bits_needed >= rice_max:
                escape_size = s.bit_length() - 1 + 2  # ilog2(sum) + 2
                if escape_size > 31:
                    return None
                total += escape_size * n
                esc[i] = True
                esc_sizes[i] = escape_size
                continue
            r = bits_needed
        else:
            r = 0
        tail = (s >> (r - 1)) if r > 0 else (s << 1)
        if tail > U32_MAX:
            return None
        size = 4 + (1 + r) * n + tail - n // 2
        if size > U32_MAX:
            return None
        total += size
        rice[i] = r
    return total, const, esc, rice, esc_sizes


def best_partitions(residuals: np.ndarray, predictor_order: int,
                    max_partition_order: int, rice_max: int):
    """Search partition orders 0..=min(tz(block), max_order) for minimum
    estimated bits (ties -> lowest order).

    Returns a list of (kind, param, values) with kind in
    {"rice", "escape", "constant"} ready for
    format.subframe.write_residuals_verbatim, or the escape-31 fallback.
    """
    res = np.asarray(residuals, dtype=np.int64)
    block_size = predictor_order + len(res)
    abs_res = np.abs(res)
    tz = (block_size & -block_size).bit_length() - 1 if block_size else 0

    best: Optional[Tuple[int, int, tuple]] = None  # (bits, order, costs)
    for po in range(0, min(tz, max_partition_order) + 1):
        count = 1 << po
        if count > MAX_PARTITIONS:
            break
        part_len = block_size // count
        p0 = part_len - predictor_order
        if p0 <= 0:
            continue
        lens = np.full(count, part_len, dtype=np.int64)
        lens[0] = p0
        bounds = np.concatenate([[0], np.cumsum(lens)[:-1]])
        sums = np.add.reduceat(abs_res, bounds) if len(abs_res) else np.zeros(count, np.int64)
        got = _partition_costs(sums, lens, rice_max)
        if got is None:
            continue
        if best is None or got[0] < best[0]:
            best = (got[0], po, got)

    if best is None:
        # fallback: single partition escaped at 31 bits
        return [("escape", 31, res)]

    _, po, (_, const, esc, rice, esc_sizes) = best
    count = 1 << po
    part_len = block_size // count
    out = []
    pos = 0
    for i in range(count):
        n = (part_len - predictor_order) if i == 0 else part_len
        values = res[pos:pos + n]
        pos += n
        if const[i]:
            out.append(("constant", 0, len(values)))
        elif esc[i]:
            out.append(("escape", int(esc_sizes[i]), values))
        else:
            out.append(("rice", int(rice[i]), values))
    return out


def residual_section_bits(partitions, rice_bits: int) -> int:
    """Exact bit length of a residual section as serialized (coding method
    2 bits + partition order 4 bits + per-partition header/data)."""
    total = 2 + 4
    for kind, param, values in partitions:
        total += rice_bits
        if kind == "rice":
            v = np.asarray(values, dtype=np.int64)
            u = np.where(v < 0, ((-v - 1) << 1) + 1, v << 1)
            total += int((u >> param).sum()) + (param + 1) * len(v)
        elif kind == "escape":
            total += 5 + param * len(values)
        else:
            total += 5
    return total


def choose_rice_coding(partitions, use_rice2: bool):
    """Pick 4-bit vs 5-bit coding (reference: src/encode.rs:3910-3961).

    With rice2 enabled the search runs at RICE_MAX=31 and shrinks back to
    the 4-bit method when every partition's parameter fits.
    """
    if not use_rice2:
        return 4, partitions
    for kind, param, _ in partitions:
        if kind == "rice" and param >= 15:
            return 5, partitions
    return 4, partitions
