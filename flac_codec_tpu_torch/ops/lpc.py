"""Batched LPC analysis stack.

Counterpart of ``flac_codec_tpu/ops/lpc.py``: window -> autocorrelation
-> Levinson-Durbin -> expected-bits best order -> error-feedback
quantization -> integer residuals, vectorized over rows with orders
padded to MAX_ORDER=32.  Float work runs in the window's dtype (float64
for byte parity with the host encoder, float32 for speed); residual math
is exact int64.  The JAX package's ``_residuals_i32`` (an int32 limb
form for the TPU, which emulates int64) has no counterpart.

float64 analysis promises streams byte-identical to the host encoder,
and LPC analysis of tonal audio is ill-conditioned enough that one ulp in
one autocorrelation lag flips quantized coefficients.  So in float64 the
autocorrelation and Levinson recursion run as :func:`autocorr_levinson`:
a CUDA kernel (``csrc/autocorr_levinson.cu``) that reproduces the host's
rounding step by step, whose plain version is the host encoder's own
numpy routines.  float32 analysis (no byte parity) uses
:func:`autocorrelate` and :func:`levinson`, which keep the JAX package's
operation order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from ..graphs import outside_pool
from ..models import lpc as host_lpc
from ..models.lpc import precision_for_block_size, window as host_window
from .common import round_half_away

MAX_ORDER = 32
MAX_SHIFT = 15
MIN_SHIFT = -16


@functools.lru_cache(maxsize=None)
def window_array(kind, n: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """Static window coefficients (host-generated, then moved), built on
    first use and then the same tensor for every call with the same
    arguments (``common.device_constant`` says why, and why outside any
    graph memory pool; callers must not write to it)."""
    return outside_pool(lambda: torch.as_tensor(host_window(kind, n),
                                                dtype=dtype, device=device))


def autocorrelate(windowed: torch.Tensor, max_order: int) -> torch.Tensor:
    """(B, N) -> (B, max_order+1) autocorrelation lags (zero for lags
    >= N, like the host's early exit)."""
    B, N = windowed.shape
    lags = []
    for j in range(max_order + 1):
        if j >= N:
            lags.append(windowed.new_zeros(B))
        else:
            lags.append((windowed[:, :N - j] * windowed[:, j:]).sum(dim=1))
    return torch.stack(lags, dim=1)


def levinson(autoc: torch.Tensor, max_order: int):
    """Batched Levinson-Durbin producing coefficients for ALL orders.

    (B, max_order+1) -> (all_coeffs (B, max_order, MAX_ORDER),
                         all_errors (B, max_order)).
    Column j of the order-o row holds c_j (j < o), zero-padded beyond.
    """
    B = autoc.shape[0]
    M = max_order
    k0 = autoc[:, 1] / autoc[:, 0]
    err = autoc[:, 0] * (1.0 - k0 * k0)
    coeffs = [k0]            # (B,) coefficient columns, len == order
    rows = [coeffs]
    errs = [err]
    for i in range(1, M):
        # q = autoc[:, i+1] - sum_{j<i} autoc[:, i-j] * c_j
        q = autoc[:, i + 1]
        for j in range(i):
            q = q - autoc[:, i - j] * coeffs[j]
        k = q / err
        # c'_j = c_j - k * c_{i-1-j} (j < i); c'_i = k
        coeffs = [coeffs[j] - k * coeffs[i - 1 - j] for j in range(i)] + [k]
        err = err * (1.0 - k * k)
        rows.append(coeffs)
        errs.append(err)

    zero = autoc.new_zeros(B)
    all_coeffs = torch.stack(
        [torch.stack(r + [zero] * (MAX_ORDER - len(r)), dim=1)
         for r in rows], dim=1)
    return all_coeffs, torch.stack(errs, dim=1)


def autocorr_levinson(windowed: torch.Tensor, max_order: int,
                      tile_steps: int | None = None):
    """float64 (B, N) windowed rows -> (autoc (B, max_order+1),
    all_coeffs (B, max_order, MAX_ORDER), all_errs (B, max_order)), in
    the host encoder's exact rounding: each lag as numpy's ``np.dot``
    (OpenBLAS's SkylakeX ddot order), the recursion as
    ``models.lpc.lp_coefficients``.  CUDA tensors launch the kernel; CPU
    tensors take the plain version.  Rows must be longer than
    ``max_order``; the ddot order is OpenBLAS's single-thread one, which
    it uses for rows of up to 10000 samples.  ``tile_steps`` sets the
    kernel's tile (32 * tile_steps samples of a row a stage of its ring;
    None: the kernel's own); the results do not depend on it.
    """
    dev = kernels.check_inputs("autocorr_levinson", dict(windowed=windowed),
                               dict(windowed=torch.float64))
    B, N = windowed.shape
    if not 1 <= max_order <= MAX_ORDER or N <= max_order:
        raise ValueError(f"autocorr_levinson: need 1 <= max_order <= "
                         f"{MAX_ORDER} < N, got max_order={max_order}, N={N}")
    if tile_steps is not None and tile_steps < 1:
        raise ValueError(f"autocorr_levinson: tile_steps must be positive, "
                         f"not {tile_steps}")
    if dev.type == "cpu":
        return autocorr_levinson_plain(windowed, max_order)
    autoc = torch.empty((B, max_order + 1), dtype=torch.float64, device=dev)
    coeffs = torch.empty((B, max_order, MAX_ORDER), dtype=torch.float64,
                         device=dev)
    errs = torch.empty((B, max_order), dtype=torch.float64, device=dev)
    if B:
        lib = kernels.library()
        fn, tiles = ((lib.flac_autocorr_levinson, ()) if tile_steps is None
                     else (lib.flac_autocorr_levinson_tiles, (tile_steps,)))
        kernels.launch("autocorr_levinson", fn, windowed.data_ptr(),
                       autoc.data_ptr(), coeffs.data_ptr(), errs.data_ptr(),
                       B, N, max_order, *tiles, device=dev)
    return autoc, coeffs, errs


def autocorr_levinson_plain(windowed: torch.Tensor, max_order: int):
    """Plain version of :func:`autocorr_levinson`: the host encoder's
    ``autocorrelate`` and ``lp_coefficients`` row by row (on the host's
    numpy, whose rounding the kernel reproduces)."""
    w = windowed.detach().cpu().numpy()
    B = w.shape[0]
    M = max_order
    autoc = np.zeros((B, M + 1))
    coeffs = np.zeros((B, M, MAX_ORDER))
    errs = np.zeros((B, M))
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(B):
            autoc[r] = host_lpc.autocorrelate(w[r], M)
            for o, (c, e) in enumerate(host_lpc.lp_coefficients(autoc[r])):
                coeffs[r, o, :o + 1] = c
                errs[r, o] = e
    return tuple(torch.as_tensor(a, device=windowed.device)
                 for a in (autoc, coeffs, errs))


def best_order(all_errs: torch.Tensor, bits_per_sample: torch.Tensor,
               precision: int, sample_count: int):
    """Expected-bits order choice (reference: src/encode.rs:3655-3702).

    ``bits_per_sample`` is (B,).  Returns (order (B,) int32 1-based,
    valid (B,) bool).  take_while(error > 0): an order is a candidate
    only if every error up to it is > 0.
    """
    B, M = all_errs.shape
    orders = torch.arange(1, M + 1, device=all_errs.device)
    error_scale = 0.5 / float(sample_count)
    ln2x2 = 2.0 * math.log(2.0)

    available = torch.cumprod((all_errs > 0.0).to(torch.int32),
                              dim=1).to(torch.bool)
    header_bits = orders[None, :] * (bits_per_sample[:, None] + precision)
    bits_per_residual = torch.log(all_errs * error_scale) / ln2x2
    bits = (bits_per_residual * (sample_count - orders[None, :])
            .to(all_errs.dtype) + header_bits.to(all_errs.dtype))
    bits = torch.where(available, bits, math.inf)
    order = torch.argmin(bits, dim=1) + 1
    return order.to(torch.int32), available[:, 0]


def quantize(coeffs: torch.Tensor, order: torch.Tensor, precision: int,
             max_taps: int = MAX_ORDER):
    """Batched error-feedback quantization (reference:
    src/encode.rs:3334-3401).

    coeffs: (B, MAX_ORDER) float (zero beyond order); order: (B,) int.
    Returns (shift (B,) int32, qcoeffs (B, MAX_ORDER) int32, valid (B,)).
    """
    B = coeffs.shape[0]
    j_idx = torch.arange(MAX_ORDER, device=coeffs.device)
    in_order = j_idx[None, :] < order[:, None]

    max_coeff = (1 << (precision - 1)) - 1
    min_coeff = -(1 << (precision - 1))

    l = torch.where(in_order, coeffs.abs(), 0.0).max(dim=1).values
    nonzero = l > 0.0
    log2l = torch.floor(torch.log2(torch.where(nonzero, l, 1.0))).to(
        torch.int32)
    shift_raw = torch.clamp((precision - 1) - log2l - 1, max=MAX_SHIFT)
    neg_shift_ok = shift_raw >= MIN_SHIFT
    shift = torch.clamp(shift_raw, min=0)
    # scale = 2^shift for shift >= 0, else 1 / 2^(-shift)
    scale = torch.where(shift_raw >= 0,
                        torch.exp2(shift_raw.to(coeffs.dtype)),
                        1.0 / torch.exp2((-shift_raw).to(coeffs.dtype)))

    err = coeffs.new_zeros(B)
    qcoeffs = torch.zeros((B, MAX_ORDER), dtype=torch.int32,
                          device=coeffs.device)
    for j in range(min(max_taps, MAX_ORDER)):
        active = j < order
        s = coeffs[:, j] * scale + err
        q = torch.clamp(round_half_away(s), min_coeff, max_coeff)
        err = torch.where(active, s - q, err)
        # NaN (a silent channel's 0/0 coefficients) converts to 0, as in
        # XLA; torch's float->int conversion of NaN is undefined
        qcoeffs[:, j] = torch.where(active & ~torch.isnan(q), q, 0.0).to(
            torch.int32)
    return shift.to(torch.int32), qcoeffs, nonzero & neg_shift_ok


def residuals(x: torch.Tensor, qcoeffs: torch.Tensor, order: torch.Tensor,
              shift: torch.Tensor, max_taps: int = MAX_ORDER):
    """Batched integer LPC residuals
    r[n] = x[n] - ((sum_j q_j x[n-1-j]) >> shift), n >= order
    (reference: src/encode.rs:3174-3203).

    x: (B, N) int64; qcoeffs: (B, MAX_ORDER) int32 zero-padded, only the
    first ``max_taps`` taps nonzero.  Returns (res (B, N) int64, zero
    below ``order``; overflow (B,) — a residual outside int32).
    """
    B, N = x.shape
    acc = torch.zeros((B, N), dtype=torch.int64, device=x.device)
    q64 = qcoeffs.to(torch.int64)
    for j in range(min(max_taps, MAX_ORDER, N - 1)):
        acc[:, j + 1:] += q64[:, j:j + 1] * x[:, :N - j - 1]
    res = x - (acc >> shift.to(torch.int64)[:, None])
    idx = torch.arange(N, device=x.device)
    res = torch.where(idx[None, :] >= order[:, None], res, 0)
    overflow = (res.max(dim=1).values > (1 << 31) - 1) | \
               (res.min(dim=1).values < -(1 << 31))
    return res, overflow


def analyze(x: torch.Tensor, win: torch.Tensor, max_order: int,
            bits_per_sample: torch.Tensor, block_size: int):
    """Full LPC parameter selection for a batch of channels.

    Float math runs in ``win.dtype``.  Returns a dict with order,
    precision, shift, qcoeffs, residuals and valid (all batched).
    """
    precision = precision_for_block_size(block_size)
    windowed = x.to(win.dtype) * win[None, :]
    if win.dtype == torch.float64:
        _, all_coeffs, all_errs = autocorr_levinson(windowed, max_order)
    else:
        all_coeffs, all_errs = levinson(autocorrelate(windowed, max_order),
                                        max_order)
    order, order_valid = best_order(all_errs, bits_per_sample, precision,
                                    block_size)
    rows = torch.arange(x.shape[0], device=x.device)
    coeffs = all_coeffs[rows, order.long() - 1]
    shift, qcoeffs, quant_valid = quantize(coeffs, order, precision,
                                           max_taps=max_order)
    res, overflow = residuals(x, qcoeffs, order, shift, max_taps=max_order)
    return {
        "order": order,
        "precision": precision,
        "shift": shift,
        "qcoeffs": qcoeffs,
        "residuals": res,
        "valid": order_valid & quant_valid & ~overflow,
    }
