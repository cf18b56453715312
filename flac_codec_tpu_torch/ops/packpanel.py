"""Bit placement on the card: the symbol pack (K2) and the splice (K1).

Counterpart of ``flac_codec_tpu/ops/packpanel.py``.  The JAX package
places Rice symbols into word panels with one-hot matrix products
(``chunkmerge_panels``) or the Pallas ``merge_panels`` kernel, and
bit-concatenates subframe panels into frame slots with the Pallas
``splice_subframes`` kernel.  Here both are CUDA kernels
(``csrc/pack_symbols.cu``, ``csrc/splice.cu``), each with a plain
PyTorch version beside it:

* :func:`pack_symbols` places (value, width, panel-local end bit)
  symbols MSB-first into one (P,) panel per row.  It also serves as the
  JAX package's ``pack_fields_window``: header fields are symbols too.
* :func:`splice_subframes` funnel-shifts each of a frame's S panels to
  its body bit offset and adds them into the frame's (W,) slot.

Each wrapper checks device, dtype, shape and contiguity, takes the plain
version only for CPU tensors, and for CUDA tensors launches its kernel
(counting the launch in ``kernels.LAUNCHES``) or raises.  Words are
int32 tensors holding u32 bit patterns (``torch.uint32`` has almost no
kernels); the plain versions compute in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

from .. import kernels
from .common import MASK32, i32_to_u32, u32_to_i32

# panel slack past the largest in-budget offset.  The port needs none of
# it (its kernels guard every write), but keeping the JAX package's value
# keeps the panel and slot geometry (P, W) equal in both packages.
MERGE_SLACK = 256


# ---------------------------------------------------------------------------
# K2: symbol pack
# ---------------------------------------------------------------------------

def pack_symbols(values: torch.Tensor, widths: torch.Tensor,
                 ends: torch.Tensor, mask: torch.Tensor, P: int):
    """(rows, M) symbols -> ((rows, P) int32 panels, (rows,) overflow).

    values: int32 holding each symbol's low ``width`` bits as a u32
    pattern (leading unary zeros are implicit); widths: int32 in [0, 32];
    ends: int32 panel-local end bit (bit 0 = word 0 bit 31, MSB-first);
    mask: bool, symbols to place.  Bit fields of live symbols must be
    disjoint, which makes OR and add the same.  A live symbol that would
    land outside the panel, or is wider than 32 bits, is dropped and
    flags its row.  On the card this is one launch, which also writes the
    (rows,) bool overflow flags.
    """
    dev = kernels.check_inputs(
        "pack_symbols",
        dict(values=values, widths=widths, ends=ends, mask=mask),
        dict(values=torch.int32, widths=torch.int32, ends=torch.int32,
             mask=torch.bool))
    if values.dim() != 2 or not (values.shape == widths.shape == ends.shape
                                 == mask.shape):
        raise ValueError(f"pack_symbols: shapes differ or are not 2-D: "
                         f"{values.shape} {widths.shape} {ends.shape} "
                         f"{mask.shape}")
    if P <= 0:
        raise ValueError(f"pack_symbols: P must be positive, not {P}")
    if dev.type == "cpu":
        return pack_symbols_plain(values, widths, ends, mask, P)
    rows, M = values.shape
    out = torch.empty((rows, P), dtype=torch.int32, device=dev)
    ovf = torch.empty(rows, dtype=torch.bool, device=dev)
    if rows:
        kernels.launch("pack_symbols", kernels.library().flac_pack_symbols,
                       values.data_ptr(), widths.data_ptr(), ends.data_ptr(),
                       mask.data_ptr(), out.data_ptr(), ovf.data_ptr(), rows,
                       M, P, device=dev)
    return out, ovf


def pack_symbols_plain(values: torch.Tensor, widths: torch.Tensor,
                       ends: torch.Tensor, mask: torch.Tensor, P: int):
    """Plain PyTorch version of :func:`pack_symbols`: each symbol's hi/lo
    word contributions scatter-added into a flat (rows*P + 2) buffer."""
    rows, M = values.shape
    dev = values.device
    v = i32_to_u32(values)
    w = widths.to(torch.int64)
    end = ends.to(torch.int64)
    start = end - w
    live = mask & (w > 0)
    outside = live & ((start < 0) | (end > P * 32) | (w > 32))
    live = live & ~outside
    word0 = start >> 5
    e = (start & 31) + w          # end bit in the two-word window, 1..63
    hi = torch.where(e <= 32, (v << ((32 - e) & 31)) & MASK32,
                     v >> ((e - 32) & 31))
    lo = torch.where(e <= 32, 0, (v << ((64 - e) & 31)) & MASK32)
    base = torch.arange(rows, device=dev)[:, None] * P
    dump = rows * P               # dead symbols land in the two spare words
    idx0 = torch.where(live, base + word0, dump)
    idx1 = torch.where(live, base + word0 + 1, dump + 1)
    flat = torch.zeros(rows * P + 2, dtype=torch.int64, device=dev)
    flat.scatter_add_(0, idx0.reshape(-1), torch.where(live, hi, 0)
                      .reshape(-1))
    flat.scatter_add_(0, idx1.reshape(-1), torch.where(live, lo, 0)
                      .reshape(-1))
    out = u32_to_i32(flat[:rows * P].reshape(rows, P) & MASK32)
    return out, outside.any(dim=1)


# ---------------------------------------------------------------------------
# K1: splice
# ---------------------------------------------------------------------------

def splice_subframes(panels: torch.Tensor, bit_offs: torch.Tensor,
                     W: int) -> torch.Tensor:
    """(B, S, P) int32 subframe panels + (B, S) int32 body bit offsets ->
    (B, W) int32 frame slots.

    Panel s of frame b is shifted right by ``bit_offs[b, s] % 32`` bits
    and added in at word ``bit_offs[b, s] // 32`` (a wrapping 32-bit sum,
    as the JAX package's Pallas kernel adds: the same as OR while the
    panels' set bits are disjoint, as a frame's are); its last word's
    shifted-out bits spill into the word after.  Words that would land
    outside the slot are dropped (fallback frames may carry offsets past
    it, or negative ones); a frame whose offsets fit (max offset / 32 + P
    + 1 <= W) is spliced whole.  On the card this is one launch.
    """
    dev = kernels.check_inputs(
        "splice_subframes", dict(panels=panels, bit_offs=bit_offs),
        dict(panels=torch.int32, bit_offs=torch.int32))
    if panels.dim() != 3 or bit_offs.shape != panels.shape[:2]:
        raise ValueError(f"splice_subframes: panels {panels.shape} and "
                         f"bit_offs {bit_offs.shape} do not match")
    if W <= 0:
        raise ValueError(f"splice_subframes: W must be positive, not {W}")
    if dev.type == "cpu":
        return splice_subframes_plain(panels, bit_offs, W)
    B, S, P = panels.shape
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    if B:
        kernels.launch("splice_subframes",
                       kernels.library().flac_splice_subframes,
                       panels.data_ptr(), bit_offs.data_ptr(), out.data_ptr(),
                       B, S, P, W, device=dev)
    return out


def splice_subframes_plain(panels: torch.Tensor, bit_offs: torch.Tensor,
                           W: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`splice_subframes`: funnel shift,
    then ``index_add_`` into a flat (B*W + 1) buffer."""
    B, S, P = panels.shape
    dev = panels.device
    p = i32_to_u32(panels)
    off = bit_offs.to(torch.int64)
    wo = off >> 5
    sh = (off & 31)[:, :, None]
    shl = (32 - sh) & 31
    prev = torch.cat([torch.zeros_like(p[:, :, :1]), p[:, :, :-1]], dim=2)
    shifted = torch.where(sh == 0, p, (p >> sh) | ((prev << shl) & MASK32))
    spill = torch.where(sh == 0, 0, (p[:, :, -1:] << shl) & MASK32)
    words = torch.cat([shifted, spill], dim=2)            # (B, S, P+1)
    idx = wo[:, :, None] + torch.arange(P + 1, device=dev)
    keep = (idx >= 0) & (idx < W)
    flat_idx = torch.where(
        keep, torch.arange(B, device=dev)[:, None, None] * W + idx, B * W)
    flat = torch.zeros(B * W + 1, dtype=torch.int64, device=dev)
    flat.index_add_(0, flat_idx.reshape(-1), words.reshape(-1))
    return u32_to_i32(flat[:B * W].reshape(B, W) & MASK32)
