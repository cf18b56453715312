# Frozen copy of flac_codec_tpu_torch/models/fixed.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""FIXED predictor selection (orders 0-4; reference:
src/encode.rs:3020-3088).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1


def fixed_diffs(channel: np.ndarray) -> List[np.ndarray]:
    """Successive-difference residual buffers for orders 0..4.

    Differences are taken in int64 and any i32 overflow aborts that order
    and all higher ones (reference checked_sub at src/encode.rs:3043-3056).
    The order-k buffer has len(channel) - k entries.  Stops early when a
    buffer would be empty.
    """
    buffers = [np.asarray(channel, dtype=np.int64)]
    for _ in range(4):
        prev = buffers[-1]
        if len(prev) < 2:
            break
        diff = prev[1:] - prev[:-1]
        if diff.max(initial=0) > I32_MAX or diff.min(initial=0) < I32_MIN:
            break
        buffers.append(diff)
    return buffers


def best_fixed_order(channel: np.ndarray) -> Tuple[int, np.ndarray]:
    """Choose the order whose residuals minimize the abs-sum over the
    common suffix (ties -> lowest order; reference: src/encode.rs:3058-3087).

    Returns (order, residual buffer for that order).
    """
    buffers = fixed_diffs(channel)
    min_len = len(buffers[-1])
    best_order = 0
    best_sum = None
    for order, buf in enumerate(buffers):
        s = int(np.abs(buf[len(buf) - min_len:]).sum())
        if best_sum is None or s < best_sum:
            best_sum = s
            best_order = order
    return best_order, buffers[best_order]
