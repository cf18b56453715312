"""Batched FIXED predictor analysis (orders 0-4).

Counterpart of ``flac_codec_tpu/ops/fixed.py``: the reference's diff
cascade with i32-overflow abort and min-abs-sum-over-common-suffix order
choice (reference: src/encode.rs:3020-3088), vectorized over rows.
Panels are int64 throughout (the card has native int64).
"""

from __future__ import annotations

import torch

from .common import BIG, delay, device_constant

I32_MAX = (1 << 31) - 1
I32_MIN = -(1 << 31)

# order-k successive differences in closed binomial form:
# d_k[n] = sum_i BINOM[k][i] * x[n-i]
_BINOM = ((1, 0, 0, 0, 0),
          (1, -1, 0, 0, 0),
          (1, -2, 1, 0, 0),
          (1, -3, 3, -1, 0),
          (1, -4, 6, -4, 1))


def plan_narrow(x: torch.Tensor):
    """(B, N) int64 panel of samples of at most 27 bits -> (order (B,),
    residuals (B, N)).

    Equal to ``best_order(*diff_cascade(x))`` when every order's diffs
    fit int32 (all orders valid, common suffix from position 4), but
    computes each order's abs-sum straight from ``x`` in binomial form,
    so no (B, 5, N) diff stack is built.
    """
    B, N = x.shape
    assert N >= 5, N
    idx = torch.arange(N, device=x.device)
    lags = [delay(x, i) for i in range(5)]

    def taps(weights):
        acc = None
        for i, c in enumerate(weights):
            if c == 0:
                continue
            t = lags[i] * c
            acc = t if acc is None else acc + t
        return acc

    suffix = torch.stack(
        [torch.where(idx[None, :] >= 4, taps(_BINOM[k][:k + 1]).abs(), 0)
         .sum(dim=1) for k in range(5)], dim=1)
    order = torch.argmin(suffix, dim=1)  # ties -> lowest

    wsel = device_constant(_BINOM, torch.int64, x.device)[order]
    res = None
    for i in range(5):
        t = lags[i] * wsel[:, i:i + 1]
        res = t if res is None else res + t
    res = torch.where(idx[None, :] >= order[:, None], res, 0)
    return order.to(torch.int32), res


def diff_cascade(x: torch.Tensor, narrow: bool = False):
    """(B, N) int64 -> (diffs (B, 5, N), valid (B, 5) bool).

    Order-k diffs occupy positions k..N-1 (positions < k are zero).
    ``valid[b, k]`` is False when order k's diffs overflowed i32 (which
    also invalidates every higher order) or the buffer would be empty.
    ``narrow`` promises samples of at most 27 bits, where no order can
    overflow, and skips the overflow reductions.
    """
    B, N = x.shape
    idx = torch.arange(N, device=x.device)
    diffs = [x]
    valid = [torch.ones(B, dtype=torch.bool, device=x.device)]
    cur = x
    for k in range(1, 5):
        nxt = torch.zeros_like(cur)
        nxt[:, 1:] = cur[:, 1:] - cur[:, :-1]
        # zero the positions below the order (they hold stale lower-order
        # data)
        nxt = torch.where(idx[None, :] >= k, nxt, 0)
        ok = valid[-1] & (N - k >= 1)
        if not narrow:
            ok = ok & (nxt.max(dim=1).values <= I32_MAX) \
                & (nxt.min(dim=1).values >= I32_MIN)
        diffs.append(nxt)
        valid.append(ok)
        cur = nxt
    return torch.stack(diffs, dim=1), torch.stack(valid, dim=1)


def best_order(diffs: torch.Tensor, valid: torch.Tensor):
    """Choose the order minimizing the abs-sum over the common suffix
    (ties -> lowest order).

    Returns (order (B,) int32, residuals (B, N) of the chosen order laid
    out at positions order..N-1).
    """
    B, K, N = diffs.shape
    dev = diffs.device
    idx = torch.arange(N, device=dev)
    order_ids = torch.arange(K, device=dev)
    a = diffs.abs() * (idx[None, None, :] >= order_ids[None, :, None])
    totals = a.sum(dim=2)  # (B, 5)

    # last valid order per row
    last_valid = torch.where(valid, order_ids[None, :], 0).max(dim=1).values

    # firsts[b, k, j] = |diffs| summed over the first j in-order elements
    # of buffer k (positions k..k+j-1); only the first 9 positions count
    head = diffs[:, :, :9].abs()
    hcum = torch.cat([torch.zeros_like(head[:, :, :1]),
                      torch.cumsum(head, dim=2)], dim=2)   # (B, 5, 10)
    firsts = torch.stack([hcum[:, k, k:k + 5] - hcum[:, k, k:k + 1]
                          for k in range(K)], dim=1)        # (B, 5, 5)

    skip = torch.clamp(last_valid[:, None] - order_ids[None, :], 0, 4)
    skipped = torch.gather(firsts, 2, skip[:, :, None])[:, :, 0]
    suffix_sums = torch.where(valid, totals - skipped, BIG)
    order = torch.argmin(suffix_sums, dim=1)  # first minimum -> lowest
    residuals = diffs[torch.arange(B, device=dev), order]
    return order.to(torch.int32), residuals
