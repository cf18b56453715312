"""Batched LPC synthesis (decode side).

Counterpart of ``flac_codec_tpu/ops/predict.py``.  The inverse-LPC
recurrence ``x[n] += (sum_j q_j x[n-1-j]) >> shift`` for n >= order is
sequential in n (the exact ``>> shift`` truncation forbids associative
reformulations), so the batch axis supplies the parallelism: one row per
subframe, taps zero-padded to a bucket, positions below the order pass
their warm-up samples through.

* :func:`predict_batch_plain` is the plain PyTorch version of the
  ``predict_lpc`` kernel (``ops/predict_pallas.py``): the JAX package's
  int64 scan ``predict_batch`` as a loop over n, vectorized over rows.
* :func:`predict_fixed_batch` inverts the FIXED predictors (orders 0-4)
  as k-fold cumulative sums, with no sequential step.  It is an XLA
  cumsum in the JAX package and stays plain PyTorch here.
* :func:`fixed_compatible_mask` (numpy) picks the rows the cumsum inverse
  may take.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ORDER = 32

# fixed-predictor taps, most recent first, padded to 4
# (reference: src/stream.rs:1534 FIXED_COEFFS)
FIXED_ROWS = np.array([[0, 0, 0, 0],
                       [1, 0, 0, 0],
                       [2, -1, 0, 0],
                       [3, -3, 1, 0],
                       [4, -6, 4, -1]], dtype=np.int64)


def shift_amount(shift: torch.Tensor) -> torch.Tensor:
    """int64 right-shift amounts with XLA's ``shift_right_arithmetic``
    meaning: an amount outside [0, 63] shifts in sign bits only."""
    s = shift.to(torch.int64)
    return torch.where((s < 0) | (s > 63), 63, s)


def predict_batch_plain(x: torch.Tensor, qcoeffs: torch.Tensor,
                        shift: torch.Tensor, order: torch.Tensor,
                        taps: int = MAX_ORDER) -> torch.Tensor:
    """Reconstruct subframe samples for a batch, exactly, in int64.

    x: (R, N) integers, warm-up samples at positions < order and residuals
    at positions >= order; qcoeffs: (R, >= taps), zero beyond the order,
    most recent first; shift, order: (R,).  Only the first ``taps``
    coefficients are read, as in the JAX package's ``predict_batch``.
    Returns (R, N) int64.
    """
    R, N = x.shape
    q = qcoeffs[:, :taps].to(torch.int64).flip(1)   # column i: y[n-taps+i]
    sh = shift_amount(shift)
    order = order.to(torch.int64)
    # y[:, taps + n] is sample n; the taps leading zeros are the empty
    # history of the first positions
    y = torch.zeros((R, taps + N), dtype=torch.int64, device=x.device)
    y[:, taps:] = x
    if R == 0 or N == 0:
        return y[:, taps:]
    for n in range(max(int(order.min()), 0), N):
        pred = (y[:, n:n + taps] * q).sum(1) >> sh
        y[:, taps + n] += torch.where(order <= n, pred, 0)
    return y[:, taps:]


def predict_fixed_batch(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Exact inverse of the FIXED predictors (orders 0-4) as k-fold
    cumulative sums: no sequential scan.

    Fixed predictors have shift 0 and integer taps, so the inverse
    recurrence is the k-fold prefix sum of the residual stream seeded by
    the warm-up difference pyramid, which is associative and exact in
    int64 (reference recurrence: src/decode.rs:1738-1752 with
    FIXED_COEFFS stream.rs:1534).

    x: (R, N) integers, warm-ups at positions < order, residuals beyond;
    order: (R,) in [0, 4].  Returns (R, N) int64.
    """
    R, N = x.shape
    x = x.to(torch.int64)
    ordc = order.to(torch.int64)[:, None]                   # (R, 1)
    pos = torch.arange(N, device=x.device)[None, :]

    # warm-up difference pyramid heads: h_L = L-th forward diff at index L
    x0, x1, x2, x3 = (x[:, min(k, N - 1)] for k in range(4))
    H = torch.stack([x0,
                     x1 - x0,
                     x2 - 2 * x1 + x0,
                     x3 - 3 * x2 + 3 * x1 - x0], dim=1)     # (R, 4)

    # v: level-(k-1) stream — h_{k-1} at position k-1, residuals after,
    # zeros before (zeros are cumsum-neutral)
    top = torch.gather(H, 1, (ordc - 1).clamp(min=0))       # (R, 1)
    v = torch.where(pos < ordc - 1, 0,
                    torch.where((pos == ordc - 1) & (ordc >= 1), top, x))
    # integrate down the pyramid; level L applies to rows with order > L
    for L in (3, 2, 1):
        cs = torch.cumsum(v, dim=1)
        seeded = torch.where(pos == L - 1, H[:, L - 1:L], cs)
        v = torch.where(ordc > L, seeded, v)
    return torch.where(ordc >= 1, torch.cumsum(v, dim=1), x)


def fixed_compatible_mask(qcoeffs: np.ndarray, shift: np.ndarray,
                          order: np.ndarray) -> np.ndarray:
    """(R,) bool: rows whose recurrence equals a FIXED predictor (order
    <= 4, shift 0, taps matching FIXED_COEFFS), eligible for the cumsum
    path.  Constant/verbatim subframes (order 0) qualify trivially."""
    q = np.asarray(qcoeffs)
    ok = (np.asarray(shift) == 0) & (np.asarray(order) <= 4)
    rows = FIXED_ROWS[np.minimum(np.asarray(order), 4)]
    ok &= (q[:, :4] == rows).all(axis=1)
    ok &= (q[:, 4:] == 0).all(axis=1)
    return ok
