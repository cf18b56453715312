"""The inverse-LPC recurrence on the card: the ``predict_lpc`` kernel (K3).

Counterpart of ``flac_codec_tpu/ops/predict_pallas.py``, whose Pallas
kernel runs the decoder's recurrence with the history in registers and
splits int32 into 2-4 limbs, behind the host gate ``pallas_predict_ok``,
because Mosaic lowers no int64.  Here the kernel is CUDA C++
(``csrc/predict_lpc.cu``): it runs a row on 32-bit samples, with taps 2
and up in exact FP64 fused multiply-adds, and finishes in int64 the rows
:func:`int64_rows` names (those that leave int32, and those whose taps or
shift fall outside the fast path's exact range), so it computes what the
JAX package's int64 scan computes, on every input, and neither the gate
nor the ``limbs`` argument is ported.  Input and output are (R, N) rows,
read and written in place: no transposes.

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


def int64_rows(out: torch.Tensor, qcoeffs: torch.Tensor, shift: torch.Tensor,
               taps: int) -> torch.Tensor:
    """(R,) bool: the rows the kernel runs in its int64 loop.  ``out`` is
    the (R, N) int64 result.  A row goes there when a sample leaves int32,
    when the sum of |q| over its taps reaches 2^19 (its FP64 partial sums
    could then pass 2^50), or when its shift, read as the kernel reads it
    (outside [0, 63] means 63), is past 51."""
    wide = ((out < -(1 << 31)) | (out > (1 << 31) - 1)).any(1)
    qsum = qcoeffs[:, :taps].to(torch.int64).abs().sum(1)
    s = shift.to(torch.int64)
    s = torch.where((s < 0) | (s > 63), 63, s)
    return wide | (qsum >= 1 << 19) | (s > 51)


def predict_lpc(x: torch.Tensor, qcoeffs: torch.Tensor, shift: torch.Tensor,
                order: torch.Tensor, taps: int,
                slow_rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, N) int32 residuals with warm-ups -> (R, N) int64 samples.

    x: warm-up samples at positions < order, residuals beyond; qcoeffs:
    (R, Q) int32 with Q >= taps, most recent first, zero beyond the order
    (only the first ``taps`` are read); shift, order: (R,) int32.  ``taps``
    is one of :data:`TAP_BUCKETS`.  ``slow_rows``, a (1,) int32 tensor on
    the same device, gets the number of rows that take the kernel's int64
    path (:func:`int64_rows`) added: on the card, counted by the kernel.
    """
    tensors = dict(x=x, qcoeffs=qcoeffs, shift=shift, order=order)
    if slow_rows is not None:
        tensors["slow_rows"] = slow_rows
    dev = kernels.check_inputs(
        "predict_lpc", tensors,
        dict(x=torch.int32, qcoeffs=torch.int32, shift=torch.int32,
             order=torch.int32, slow_rows=torch.int32))
    if x.dim() != 2 or qcoeffs.dim() != 2:
        raise ValueError(f"predict_lpc: x {x.shape} and qcoeffs "
                         f"{qcoeffs.shape} must be 2-D")
    R, N = x.shape
    if (qcoeffs.shape[0] != R or qcoeffs.shape[1] < taps
            or shift.shape != (R,) or order.shape != (R,)
            or (slow_rows is not None and slow_rows.shape != (1,))):
        raise ValueError(f"predict_lpc: shapes do not match: x {x.shape}, "
                         f"qcoeffs {qcoeffs.shape}, shift {shift.shape}, "
                         f"order {order.shape}, taps {taps}")
    if taps not in TAP_BUCKETS:
        raise ValueError(f"predict_lpc: taps must be one of {TAP_BUCKETS}, "
                         f"not {taps}")
    if dev.type == "cpu":
        out = predict_batch_plain(x, qcoeffs, shift, order, taps)
        if slow_rows is not None:
            slow_rows += int64_rows(out, qcoeffs, shift, taps).sum().to(
                torch.int32)
        return out
    out = torch.empty((R, N), dtype=torch.int64, device=dev)
    if R and N:
        kernels.launch("predict_lpc", kernels.library().flac_predict_lpc,
                       x.data_ptr(), qcoeffs.data_ptr(), qcoeffs.shape[1],
                       shift.data_ptr(), order.data_ptr(), out.data_ptr(), R,
                       N, taps,
                       None if slow_rows is None else slow_rows.data_ptr(),
                       device=dev)
    return out
