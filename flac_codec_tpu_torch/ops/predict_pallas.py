"""The inverse-LPC recurrence on the card: the ``predict_lpc`` kernel (K3).

Counterpart of ``flac_codec_tpu/ops/predict_pallas.py``, whose Pallas
kernel runs the decoder's recurrence with the history in registers and
splits int32 into 2-4 limbs, behind the host gate ``pallas_predict_ok``,
because Mosaic lowers no int64.  Here the kernel is CUDA C++
(``csrc/predict_lpc.cu``) with an int64 history and accumulator: it
computes what the JAX package's int64 scan computes, on every input, so
neither the gate nor the ``limbs`` argument is ported.

:func:`predict_lpc` checks device, dtype, shape and contiguity, takes the
plain version :func:`..predict.predict_batch_plain` only for CPU tensors,
and for CUDA tensors launches the kernel (counting the launch in
``kernels.LAUNCHES["predict_lpc"]``) or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .predict import MAX_ORDER, predict_batch_plain

# the kernel's template tap counts: a batch takes the smallest one that
# covers its largest order, so low orders do proportionally less work
TAP_BUCKETS = (4, 8, 12, 16, MAX_ORDER)


def tap_bucket(max_order: int) -> int:
    """The smallest tap bucket >= ``max_order``."""
    for t in TAP_BUCKETS:
        if t >= max_order:
            return t
    raise ValueError(f"LPC order {max_order} exceeds {MAX_ORDER}")


def predict_lpc(x: torch.Tensor, qcoeffs: torch.Tensor, shift: torch.Tensor,
                order: torch.Tensor, taps: int) -> torch.Tensor:
    """(R, N) int32 residuals with warm-ups -> (R, N) int64 samples.

    x: warm-up samples at positions < order, residuals beyond; qcoeffs:
    (R, Q) int32 with Q >= taps, most recent first, zero beyond the order
    (only the first ``taps`` are read); shift, order: (R,) int32.  ``taps``
    is one of :data:`TAP_BUCKETS`.  On the card the result is the
    transpose view of an (N, R) buffer.
    """
    dev = kernels.check_inputs(
        "predict_lpc", dict(x=x, qcoeffs=qcoeffs, shift=shift, order=order),
        dict(x=torch.int32, qcoeffs=torch.int32, shift=torch.int32,
             order=torch.int32))
    if x.dim() != 2 or qcoeffs.dim() != 2:
        raise ValueError(f"predict_lpc: x {x.shape} and qcoeffs "
                         f"{qcoeffs.shape} must be 2-D")
    R, N = x.shape
    if (qcoeffs.shape[0] != R or qcoeffs.shape[1] < taps
            or shift.shape != (R,) or order.shape != (R,)):
        raise ValueError(f"predict_lpc: shapes do not match: x {x.shape}, "
                         f"qcoeffs {qcoeffs.shape}, shift {shift.shape}, "
                         f"order {order.shape}, taps {taps}")
    if taps not in TAP_BUCKETS:
        raise ValueError(f"predict_lpc: taps must be one of {TAP_BUCKETS}, "
                         f"not {taps}")
    if dev.type == "cpu":
        return predict_batch_plain(x, qcoeffs, shift, order, taps)
    xt = x.t().contiguous()                          # (N, R): coalesced
    out = torch.empty((N, R), dtype=torch.int64, device=dev)
    if R and N:
        kernels.launch("predict_lpc", kernels.library().flac_predict_lpc,
                       xt.data_ptr(), qcoeffs.data_ptr(), qcoeffs.shape[1],
                       shift.data_ptr(), order.data_ptr(), out.data_ptr(), R,
                       N, taps, device=dev)
    return out.t()
