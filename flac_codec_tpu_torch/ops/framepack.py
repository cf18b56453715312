"""Full-frame packing: complete FLAC frame bodies on the device.

Counterpart of ``flac_codec_tpu/ops/framepack.py``.  Everything after the
frame header — subframe headers, wasted-bits unary, warm-up samples, LPC
parameter fields, residual sections — is packed into a fixed-size
per-frame word slot, and a position-weighted GF(2) inner product reduces
each slot's CRC-16 to one 16-bit value.  The CRC-16 (poly 0x18005, init
0) is linear, so CRC(body) = x^(8L+15) * sum_p bit_p * x^(-p) (mod P),
where p is the bit position from the slot start: the x^(-p) weights are
static per slot position, zero padding contributes nothing, and only the
final x^(8L+15) factor depends on the body's byte length L, which the
host assembler applies.

Frames with a verbatim subframe, or whose packed body does not fit, are
flagged for the host encoder.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..graphs import outside_pool
from .bitpack import pack_residual_sections
from .common import TYPE_CONSTANT, TYPE_FIXED, TYPE_LPC, TYPE_VERBATIM
from .packpanel import MERGE_SLACK, splice_subframes

CRC16_POLY = 0x18005  # x^16 + x^15 + x^2 + 1 (RFC 9639 frame footer CRC)


@lru_cache(maxsize=8)
def crc16_neg_pow_table(nbits: int) -> np.ndarray:
    """T[p] = x^(-p) mod P as uint16, p in [0, nbits).

    Multiplying by x^(-1): if the constant term is set, add P first (P has
    a constant term, so the sum is divisible by x), then divide by x.
    (Copied from the JAX package's ``framepack``, which cannot be imported
    here: it imports jax.)
    """
    out = np.empty(nbits, np.uint16)
    s = 1
    for p in range(nbits):
        out[p] = s
        s = ((s ^ CRC16_POLY) >> 1) if (s & 1) else (s >> 1)
    return out


@lru_cache(maxsize=None)
def _crc_planes(W: int, device: str) -> torch.Tensor:
    """(W*32, 16) float32 bit planes of the weight table: row w*32 + j
    weights bit j (MSB-first) of word w.  Never evicted: a captured CUDA
    graph reads the tensor by its address.  Built outside any graph
    memory pool (``graphs.outside_pool``): it outlives the warm-up that
    first asks for it."""
    t = crc16_neg_pow_table(W * 32).astype(np.int64)
    planes = (t[:, None] >> np.arange(16)[None, :]) & 1
    return outside_pool(lambda: torch.as_tensor(planes, dtype=torch.float32,
                                                device=device))


def crc16_inner(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 slot words -> (B,) int32 GF(2) inner product (a
    16-bit value) for the body CRC-16.

    The inner product is the parity of per-CRC-bit match counts,
    count[b, r] = sum_p bit[b, p] * weight_bit[p, r]: one matrix product.
    It runs in float32 because CUDA matmul refuses int8; every count is at
    most W*32 (167,936 at preset -8) < 2^24, so it is exact.
    """
    B, W = words.shape
    shifts = torch.arange(31, -1, -1, device=words.device, dtype=torch.int32)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(B, W * 32)
    counts = bits.to(torch.float32) @ _crc_planes(W, str(words.device))
    parity = counts.to(torch.int32) & 1                   # (B, 16)
    weights = 1 << torch.arange(16, device=words.device, dtype=torch.int32)
    return (parity * weights).sum(dim=1, dtype=torch.int32)


def subframe_panel_words(block_size: int, budget_bits: int) -> int:
    """Words per subframe panel (P): field margin (header 8 + wasted unary
    <= 32 + warm-ups <= 32*32 + LPC params <= 9+32*15 < 1615 bits = 51
    words) + the residual budget + MERGE_SLACK, rounded up to 128."""
    per_sub = (budget_bits * block_size + 31) // 32
    need = per_sub + 52 + MERGE_SLACK
    return (need + 127) // 128 * 128


def frame_slot_words(S: int, block_size: int, budget_bits: int) -> int:
    """Words per frame slot (W): room for S spliced subframe panels."""
    per_sub = (budget_bits * block_size + 31) // 32
    P = subframe_panel_words(block_size, budget_bits)
    return (S - 1) * (per_sub + 64) + P + 192


def pack_frame_bodies(plan: dict, block_size: int, bps_base: int,
                      budget_bits: int):
    """Pack every frame's complete body into per-frame slots.

    plan: the planner's plan tree (per-slot channels with residuals,
    kinds, params, po, rice_bits, warmup, subframe_bits, ...).  Returns a
    new dict with the plan's ``assignment`` and ``channels`` plus:

      frame_words (B*W,) int32 — slot words (bit 31 of word 0 = body bit 0)
      body_bits  (B,) int64    — exact body bit length (pre-alignment)
      inner_crc  (B,) int32    — GF(2) inner product for the body CRC-16
      frame_fallback (B,) bool — the host must re-encode this frame
                                 (verbatim subframe or overflow)

    ``subframe_bits`` from the planner is the exact serialized subframe
    length, which makes every field offset computable before packing.
    """
    channels = plan["channels"]
    S = len(channels)
    assignment = plan["assignment"]
    B = assignment.shape[0]
    dev = assignment.device
    P = subframe_panel_words(block_size, budget_bits)
    W = frame_slot_words(S, block_size, budget_bits)

    # per-slot bits-per-sample (side channels carry one extra bit)
    a = assignment.to(torch.int64)
    if S == 2:
        side = [a == 0b1001, (a == 0b1000) | (a == 0b1010)]
    else:
        side = [torch.zeros(B, dtype=torch.bool, device=dev)] * S

    sub_bits = [ch["subframe_bits"].to(torch.int64) for ch in channels]
    body_bits = sum(sub_bits)
    fallback = torch.zeros(B, dtype=torch.bool, device=dev)
    for ch in channels:
        fallback = fallback | (ch["sub_type"] == TYPE_VERBATIM)
    # a frame whose packed body exceeds its slot cannot be spliced
    fallback = fallback | (body_bits > (W - 2) * 32)
    ok = ~fallback

    j = torch.arange(32, device=dev)
    panels = []
    for s, ch in enumerate(channels):
        bps_s = bps_base + side[s].to(torch.int64)
        typ = ch["sub_type"].to(torch.int64)
        wasted = ch["wasted"].to(torch.int64)
        order = ch["order"].to(torch.int64)
        precision = ch["precision"].to(torch.int64)
        eff = bps_s - wasted
        is_pred = (typ == TYPE_FIXED) | (typ == TYPE_LPC)
        is_lpc = typ == TYPE_LPC
        has_wasted = (typ != TYPE_CONSTANT) & (wasted > 0)

        # field geometry, panel-local (bit 0 of the subframe = panel word 0
        # bit 31); every offset is computable up front
        code6 = torch.where(
            typ == TYPE_CONSTANT, 0,
            torch.where(typ == TYPE_VERBATIM, 1,
                        torch.where(typ == TYPE_FIXED, 0b001000 | order,
                                    0b100000 | torch.clamp(order - 1,
                                                           min=0))))
        hdr_val = (code6 << 1) | has_wasted.to(torch.int64)
        hdr_end = 8 + torch.where(has_wasted, wasted, 0)
        warm = ch["warmup"].to(torch.int64)               # (B, 32)
        warm_end = hdr_end + order * eff
        pre_res = torch.where(is_lpc, warm_end + 9 + order * precision,
                              warm_end)

        # 1. subframe header byte: pad(1) + type code(6) + wasted flag(1)
        # 2. wasted-bits unary: (wasted-1) zeros then a 1
        # 3a. constant value: the UNSHIFTED sample at full slot bps
        cval = (warm[:, 0] << wasted) & ((1 << bps_s) - 1)
        # 3b. warm-up samples (fixed/LPC): order * eff-bit signed fields
        wmask = ok[:, None] & is_pred[:, None] & (j[None, :] < order[:, None])
        wval = warm & ((1 << eff[:, None]) - 1)
        wend = hdr_end[:, None] + (j[None, :] + 1) * eff[:, None]
        # 4. LPC parameter fields: precision-1 (4) + shift (signed 5)
        shift = ch["shift"].to(torch.int64)
        pval = ((precision - 1) << 5) | (shift & 31)
        # 5. quantized coefficients: order * precision-bit signed fields
        q = ch["qcoeffs"].to(torch.int64)                 # (B, 32)
        qmask = ok[:, None] & is_lpc[:, None] & (j[None, :] < order[:, None])
        qval = q & ((1 << precision[:, None]) - 1)
        qend = warm_end[:, None] + 9 + (j[None, :] + 1) * precision[:, None]
        full = torch.full((B,), 1, dtype=torch.int64, device=dev)
        fields = [
            (hdr_val, full * 8, full * 8, ok),
            (full, wasted, hdr_end, ok & has_wasted),
            (cval, bps_s, hdr_end + bps_s, ok & (typ == TYPE_CONSTANT)),
            (wval, eff[:, None].expand(B, 32), wend, wmask),
            (pval, full * 9, warm_end + 9, ok & is_lpc),
            (qval, precision[:, None].expand(B, 32), qend, qmask),
        ]
        panel, bits, pack_ovf = pack_residual_sections(
            ch["residuals"], order, ch["po"], ch["kinds"], ch["params"],
            ch["rice_bits"], block_size, pre_res, budget_bits * block_size,
            P, live=ok & is_pred, fields=fields)
        res_overflow = is_pred & (bits > budget_bits * block_size)
        fallback = fallback | res_overflow | pack_ovf
        panels.append(panel)

    # splice the S panels into per-frame slots at their exact bit offsets
    offs = torch.zeros(B, dtype=torch.int64, device=dev)
    bit_offs = []
    for s in range(S):
        bit_offs.append(offs)
        offs = offs + sub_bits[s]
    slots = splice_subframes(torch.stack(panels, dim=1),
                             torch.stack(bit_offs, dim=1).to(torch.int32), W)

    return {
        "assignment": assignment,
        "channels": channels,
        "frame_words": slots.reshape(-1),
        "body_bits": body_bits,
        "inner_crc": crc16_inner(slots),
        "frame_fallback": fallback,
    }
