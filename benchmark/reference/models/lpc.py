# Frozen copy of flac_codec_tpu_torch/models/lpc.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""LPC analysis math (host, f64 numpy).

Behavioral parity with the reference's LPC stack (reference:
src/encode.rs:3274-3745), which is itself verified against libFLAC
(FLAC__lpc_compute_autocorrelation / _lp_coefficients / _best_order /
_quantize_coefficients / FLAC__window_*).  Golden vectors from the reference
tests pin these functions in tests/test_golden_lpc.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..errors import (
    InsufficientLpcSamples,
    LpNegativeShiftError,
    NoBestLpcOrder,
    ZeroLpCoefficients,
)

MAX_LPC_ORDER = 32

MAX_SHIFT = 15   # (1 << 4) - 1
MIN_SHIFT = -16  # -(1 << 4)


def precision_for_block_size(n: int) -> int:
    """QLP precision in bits by block length (reference:
    src/encode.rs:3305-3315)."""
    if n <= 192:
        return 7
    if n <= 384:
        return 8
    if n <= 576:
        return 9
    if n <= 1152:
        return 10
    if n <= 2304:
        return 11
    if n <= 4608:
        return 12
    return 13


# ---------------------------------------------------------------------------
# Window functions (reference: src/encode.rs:1711-1808; verified against
# FLAC__window_hann / FLAC__window_tukey)
# ---------------------------------------------------------------------------

def window(kind, n: int) -> np.ndarray:
    """Generate a window of length ``n``.  ``kind`` is "rectangle", "hann",
    or ("tukey", p)."""
    if kind == "rectangle":
        return np.ones(n, dtype=np.float64)
    if kind == "hann":
        np_ = float(n) - 1.0
        i = np.arange(n, dtype=np.float64)
        return 0.5 - 0.5 * np.cos(2.0 * math.pi * i / np_)
    if isinstance(kind, tuple) and kind[0] == "tukey":
        p = float(kind[1])
        if p <= 0.0:
            return np.ones(n, dtype=np.float64)
        if p >= 1.0:
            return window("hann", n)
        edge = int(p / 2.0 * n)
        if edge == 0:
            return np.ones(n, dtype=np.float64)
        taper = edge - 1
        if 2 * taper > n:
            return np.ones(n, dtype=np.float64)
        w = np.ones(n, dtype=np.float64)
        if taper > 0:
            i = np.arange(taper, dtype=np.float64)
            ramp = 0.5 - 0.5 * np.cos(math.pi * i / float(taper))
            w[:taper] = ramp
            w[n - taper:] = ramp[::-1]
        return w
    raise ValueError(f"unknown window {kind!r}")


_window_cache: dict = {}


def apply_window(kind, samples: np.ndarray) -> np.ndarray:
    """Windowed f64 samples (reference: src/encode.rs:1785-1801 caches the
    window per block length)."""
    key = (kind if not isinstance(kind, tuple) else tuple(kind), len(samples))
    w = _window_cache.get(key)
    if w is None:
        w = window(kind, len(samples))
        _window_cache[key] = w
    return samples.astype(np.float64) * w


# ---------------------------------------------------------------------------
# Autocorrelation + Levinson-Durbin
# ---------------------------------------------------------------------------

def autocorrelate(windowed: np.ndarray, max_lpc_order: int) -> np.ndarray:
    """Autocorrelation lags 0..=max_order, early-stopping when the lagged
    tail is empty (reference: src/encode.rs:3478-3501)."""
    n = len(windowed)
    lags = min(max_lpc_order, n - 1)
    out = np.empty(lags + 1, dtype=np.float64)
    for j in range(lags + 1):
        out[j] = np.dot(windowed[: n - j], windowed[j:])
    return out


def lp_coefficients(autoc: np.ndarray) -> List[Tuple[np.ndarray, float]]:
    """Levinson-Durbin recursion producing (coeffs, error) for every order
    1..len(autoc)-1 (reference: src/encode.rs:3536-3580)."""
    assert len(autoc) >= 2, "must have at least 2 autocorrelation values"
    k = autoc[1] / autoc[0]
    results: List[Tuple[np.ndarray, float]] = [
        (np.array([k]), autoc[0] * (1.0 - k * k))]
    for i in range(1, len(autoc) - 1):
        coeffs, error = results[-1]
        # q = autoc[i+1] - sum_j autoc[i-j] * c_j
        q = autoc[i + 1] - float(np.dot(autoc[i:0:-1], coeffs))
        k = q / error
        new_coeffs = np.concatenate([coeffs - k * coeffs[::-1], [k]])
        results.append((new_coeffs, error * (1.0 - k * k)))
    return results


def subframe_bits_by_order(bits_per_sample: int, precision: int,
                           sample_count: int,
                           coeffs: List[Tuple[np.ndarray, float]]):
    """Expected-bits-per-subframe model per order (reference:
    src/encode.rs:3655-3684; mirrors
    FLAC__lpc_compute_expected_bits_per_residual_sample_with_error_scale).

    Stops at the first order whose error is not > 0 (take_while).
    """
    error_scale = 0.5 / float(sample_count)
    out = []
    for order, (c, error) in enumerate(coeffs, start=1):
        if not error > 0.0:  # also stops on NaN
            break
        header_bits = order * (bits_per_sample + precision)
        bits_per_residual = math.log(error * error_scale) / (2.0 * math.log(2.0))
        subframe_bits = bits_per_residual * (sample_count - order) + header_bits
        out.append((subframe_bits, order, c))
    return out


def compute_best_order(bits_per_sample: int, precision: int,
                       sample_count: int,
                       coeffs: List[Tuple[np.ndarray, float]]
                       ) -> Tuple[int, np.ndarray]:
    """Min-expected-bits order (ties -> lowest order; reference:
    src/encode.rs:3687-3702)."""
    candidates = subframe_bits_by_order(
        bits_per_sample, precision, sample_count, coeffs)
    if not candidates:
        raise NoBestLpcOrder()
    best = min(candidates, key=lambda t: t[0])
    return best[1], best[2]


# ---------------------------------------------------------------------------
# Coefficient quantization
# ---------------------------------------------------------------------------

def _round_half_away(x: float) -> float:
    """Rust f64::round semantics: half-way cases away from zero."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


@dataclass
class LpcParameters:
    order: int
    precision: int
    shift: int
    coefficients: np.ndarray  # int32, len == order


def quantize(coeffs: np.ndarray, precision: int) -> Tuple[int, np.ndarray]:
    """Error-feedback quantization (reference: src/encode.rs:3334-3401;
    verified against FLAC__lpc_quantize_coefficients).

    Returns (shift, int32 coefficients).
    """
    max_coeff = (1 << (precision - 1)) - 1
    min_coeff = -(1 << (precision - 1))

    l = max((abs(float(c)) for c in coeffs), default=0.0)
    if not l > 0.0:
        raise ZeroLpCoefficients()

    shift = min((precision - 1) - int(math.floor(math.log2(l))) - 1, MAX_SHIFT)

    error = 0.0
    out = np.empty(len(coeffs), dtype=np.int64)
    if shift >= 0:
        scale = float(1 << shift)
        for i, c in enumerate(coeffs):
            s = float(c) * scale + error
            q = int(_round_half_away(s))
            q = max(min_coeff, min(max_coeff, q))
            error = s - q
            out[i] = q
        return shift, out.astype(np.int32)
    if shift >= MIN_SHIFT:
        divisor = float(1 << (-shift))
        for i, c in enumerate(coeffs):
            s = float(c) / divisor + error
            q = int(_round_half_away(s))
            q = max(min_coeff, min(max_coeff, q))
            error = s - q
            out[i] = q
        return 0, out.astype(np.int32)
    raise LpNegativeShiftError()


def best_parameters(window_kind, bits_per_sample: int, max_lpc_order: int,
                    channel: np.ndarray) -> LpcParameters:
    """Full LPC parameter selection for one channel (reference:
    src/encode.rs:3292-3332 LpcParameters::best)."""
    if len(channel) <= max_lpc_order:
        raise InsufficientLpcSamples()
    precision = precision_for_block_size(len(channel))
    windowed = apply_window(window_kind, channel)
    autoc = autocorrelate(windowed, max_lpc_order)
    if len(autoc) < 2:
        raise InsufficientLpcSamples()
    order, float_coeffs = compute_best_order(
        bits_per_sample, precision, len(channel), lp_coefficients(autoc))
    shift, qcoeffs = quantize(float_coeffs, precision)
    return LpcParameters(order, precision, shift, qcoeffs)


def lpc_residuals(channel: np.ndarray, params: LpcParameters) -> Optional[np.ndarray]:
    """Residuals r[n] = x[n] - ((sum q_j x[n-1-j]) >> shift), int64
    accumulator, None on i32 overflow (reference: src/encode.rs:3174-3203)."""
    x = np.ascontiguousarray(channel, dtype=np.int64)
    order = params.order
    q = params.coefficients.astype(np.int64)
    n = len(x)
    if n <= order:
        return np.empty(0, dtype=np.int32)
    # vectorized: build lagged matrix (n-order, order)
    lagged = np.stack([x[order - 1 - j:n - 1 - j] for j in range(order)], axis=1)
    acc = lagged @ q
    pred = acc >> params.shift
    res = x[order:] - pred
    if res.max(initial=0) > 2**31 - 1 or res.min(initial=0) < -(2**31):
        return None
    return res.astype(np.int32)
