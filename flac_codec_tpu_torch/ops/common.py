"""Shared type codes and small tensor helpers for the port's planner.

Counterpart of ``flac_codec_tpu/ops/common.py``.  Its ``prefix_sum_i32``
(a triangular-matmul cumsum for the TPU's matrix unit) has no
counterpart: the port uses ``torch.cumsum``.
"""

from __future__ import annotations

import functools

import torch

from ..graphs import outside_pool

# sentinel "invalid candidate" bit cost
BIG = 1 << 62

# subframe type codes shared by the planner and the packers
TYPE_CONSTANT = 0
TYPE_VERBATIM = 1
TYPE_FIXED = 2
TYPE_LPC = 3

MASK32 = 0xFFFFFFFF


def analysis_dtype(analysis: str) -> torch.dtype:
    """Float dtype of the LPC analysis: "f32" -> float32; "f64" and
    "auto" -> float64 ("auto" is f64 because the JAX ``BatchEncoder``
    always runs with x64 enabled)."""
    if analysis == "f32":
        return torch.float32
    if analysis in ("f64", "auto"):
        return torch.float64
    raise ValueError(f"analysis must be 'auto', 'f32' or 'f64', "
                     f"not {analysis!r}")


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, built on first
    use and then the same tensor for every call with the same values,
    dtype and device.  Callers must not write to it.

    The planner's small tables come from here so that a CUDA graph
    capture (which forbids the synchronous host-to-device copy that
    ``torch.tensor`` makes) finds them on the card.  Nothing is evicted:
    a captured graph reads the tensor by its address.  Built outside any
    graph memory pool (``graphs.outside_pool``): it outlives the warm-up
    that first asks for it.
    """
    return outside_pool(
        lambda: torch.tensor(values, dtype=dtype, device=device))


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f64::round semantics (half away from zero)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def delay(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) -> (B, N) with ``out[:, n] = x[:, n - k]`` and zeros for
    n < k (the lagged panels of the FIXED and LPC predictors)."""
    if k == 0:
        return x
    B, N = x.shape
    if k >= N:
        return torch.zeros_like(x)
    return torch.cat([x.new_zeros(B, k), x[:, :N - k]], dim=1)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 words (0 <= x < 2^32) -> int32 with the same
    bits.  ``torch.uint32`` has almost no kernels, so the port keeps
    words in int64 while computing and stores them as int32; the numpy
    boundary reinterprets them as uint32 with ``.view``."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their u32 value."""
    return x.to(torch.int64) & MASK32
