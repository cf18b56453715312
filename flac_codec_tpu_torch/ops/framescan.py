"""The frame-body parser on the card: ``parse_frame_bodies`` (K4).

Counterpart of ``flac_codec_tpu/ops/framescan.py``.  The host finds each
frame's boundaries and checks its CRCs (the native ``scan_frames``); this
module parses the frame bodies themselves — subframe headers,
wasted-bits unary, warm-ups, LPC parameters, partition headers,
Rice/escape residuals (reference semantics: src/decode.rs:1635-1856) —
into the raw-subframe arrays that the inverse predictors take.

The JAX package runs a bit-serial state machine per TPU lane over a
(W, 1024) transposed word panel, emits each decoded value at its bit row
and compacts the emissions with a sort, because Mosaic cannot write a
per-lane slot.  None of that is ported (``LANES``, ``build_word_panel``,
the emission panel, the compaction): a CUDA thread writes its own slots.
The caller uploads one contiguous byte span per batch and names each
body by its byte offset and bit length.

* :func:`parse_frame_bodies` checks its inputs, takes the plain version
  for CPU tensors, and for CUDA tensors launches the kernel
  ``csrc/parse_frames.cu`` (counted in ``kernels.LAUNCHES``) or raises.
* :func:`parse_frame_bodies_plain` steps every frame at once by one whole
  field or Rice code per step.
* :func:`parse_gate` reduces a batch's output to the three numbers the
  decoder dispatches on.
* :func:`parse_batch` is the pair on one uploaded buffer, and
  :class:`ParseGraph` (cached by :func:`parse_graph`) its CUDA graph,
  the counterpart of the JAX decoder's jitted parse.

A body is ``ok`` when it parsed to its last channel with none of these:
a nonzero subframe pad bit; a reserved subframe type; effective bits
<= 0 after the wasted bits (the side channel of a stereo decorrelation
has one bit more); a predictor order above the block size; LPC precision
code 15; a negative LPC shift; a residual method above 1; a block size
not divisible by 2^partition_order; a first partition of fewer than one
residual (partition length - order < 1); a unary run of more than
``MAX_Q`` zeros; a Rice code whose quotient exceeds 2^30 >> k; a body
that ends before its last channel.  The outputs of a body that is not
``ok`` are all zero.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..graphs import CapturedGraph
from .common import device_constant
from .predict import FIXED_ROWS

# slot space per channel of the plain version's output panel (as the JAX
# package's): [0, N) samples, then the subframe's metadata
META_SLOTS = 40
OFF_TYPE = 0
OFF_WASTED = 1
OFF_SHIFT = 2
OFF_CONST = 3
OFF_QCOEFF = 8

# unary quotients past this are outside any realistic stream (a conforming
# encoder would have escaped the partition); the body is not ok
MAX_Q = 1 << 20

# parser contexts of the plain version: the field or code read next
(CTX_SUBHDR, CTX_WUNARY, CTX_CONST, CTX_VERB, CTX_WARM, CTX_PREC,
 CTX_SHIFT, CTX_COEFF, CTX_METHOD, CTX_PARTHDR, CTX_ESCW, CTX_ESCS,
 CTX_RICE, CTX_LSB, CTX_DONE) = range(15)

# width of each context's field; a negative entry names a per-frame
# register (-1 eff, -2 prec, -3 rb, -4 k); 0 for unary runs and DONE
_FIELD_WIDTH = (8, 0, -1, -1, -1, 4, 5, -2, 6, -3, 5, -4, 0, -4, 0)

# bits of the window a step reads or scans: 7 bytes less the bit offset
WINDOW = 49

# the plain version's Rice burst: window bits, and codes at most per step
BURST_BITS = 1024
BURST_CODES = 256

# (5, 32) fixed-predictor taps by order, zero-padded
_FIXED_ROWS_32 = tuple(tuple(int(x) for x in row) + (0,) * 28
                       for row in FIXED_ROWS)


def parse_frame_bodies(data: torch.Tensor, body_off: torch.Tensor,
                       nbits: torch.Tensor, assignment: torch.Tensor,
                       block_size: int, channels: int,
                       bits_per_sample: int) -> dict:
    """Parse B frame bodies of one stream's fixed block size.

    data: (L,) uint8, the bytes holding the bodies; body_off: (B,) int64,
    each body's byte offset in ``data``; nbits: (B,) int32, each body's
    bit length (the CRC-16 excluded); assignment: (B,) int32 channel
    assignment codes.  Bytes outside ``data`` read as zero.

    Returns the JAX function's dict: ``buf`` (B, C, N) int32 (warm-ups,
    verbatim samples and residuals; a constant subframe's value fills its
    row), ``order``, ``shift``, ``wasted`` (B, C) int32, ``qcoeffs``
    (B, C, 32) int32 (LPC coefficients most recent first, the fixed rows
    for FIXED subframes) and ``ok`` (B,) bool.
    """
    dev = kernels.check_inputs(
        "parse_frame_bodies",
        dict(data=data, body_off=body_off, nbits=nbits,
             assignment=assignment),
        dict(data=torch.uint8, body_off=torch.int64, nbits=torch.int32,
             assignment=torch.int32))
    B = body_off.shape[0] if body_off.dim() == 1 else -1
    if (data.dim() != 1 or B < 0 or nbits.shape != (B,)
            or assignment.shape != (B,)):
        raise ValueError(f"parse_frame_bodies: data {data.shape} must be "
                         f"1-D and body_off {body_off.shape}, nbits "
                         f"{nbits.shape}, assignment {assignment.shape} "
                         "1-D of one length")
    if block_size < 1 or not 1 <= channels <= 8 \
            or not 1 <= bits_per_sample <= 24:
        raise ValueError(f"parse_frame_bodies: block_size {block_size}, "
                         f"channels {channels} (1-8) or bits_per_sample "
                         f"{bits_per_sample} (1-24) out of range")
    if dev.type == "cpu":
        return parse_frame_bodies_plain(data, body_off, nbits, assignment,
                                        block_size, channels,
                                        bits_per_sample)
    C, N = channels, block_size
    z = torch.zeros
    out = {"buf": z((B, C, N), dtype=torch.int32, device=dev),
           "order": z((B, C), dtype=torch.int32, device=dev),
           "shift": z((B, C), dtype=torch.int32, device=dev),
           "wasted": z((B, C), dtype=torch.int32, device=dev),
           "qcoeffs": z((B, C, 32), dtype=torch.int32, device=dev),
           "ok": z(B, dtype=torch.bool, device=dev)}
    if B:
        kernels.launch("parse_frame_bodies",
                       kernels.library().flac_parse_frames,
                       data.data_ptr(), data.shape[0], body_off.data_ptr(),
                       nbits.data_ptr(), assignment.data_ptr(), B, C, N,
                       bits_per_sample,
                       *(out[k].data_ptr() for k in ("buf", "order", "shift",
                                                     "wasted", "qcoeffs",
                                                     "ok")),
                       device=dev)
    return out


def parse_frame_bodies_plain(data: torch.Tensor, body_off: torch.Tensor,
                             nbits: torch.Tensor, assignment: torch.Tensor,
                             block_size: int, channels: int,
                             bits_per_sample: int) -> dict:
    """Plain PyTorch version of :func:`parse_frame_bodies`.

    Every frame is one lane of a state machine that reads one whole field
    or Rice code per step from a 56-bit window at its bit position, and
    scatters the value into a (B, C, N + META_SLOTS) slot panel (the JAX
    package's slot layout); a step makes at most one value per lane.
    Before each step, lanes inside a Rice partition also decode as many
    of its codes as a :func:`_rice_burst` window holds, and lanes inside
    a run of verbatim or escaped samples read up to BURST_CODES of them
    (:func:`_raw_burst`), short of the last one, whose step ends the
    partition or the subframe.
    """
    dev = data.device
    B, C, N = body_off.shape[0], channels, block_size
    i64 = torch.int64
    L = data.shape[0]
    ext = torch.cat([data.to(i64), torch.zeros(1, dtype=i64, device=dev)])
    lane = torch.arange(B, device=dev)
    base = body_off * 8
    end = nbits.to(i64)
    assign = assignment.to(i64)
    byte_sh = 48 - 8 * torch.arange(7, device=dev)
    widths = torch.tensor(_FIELD_WIDTH, device=dev)
    slots = N + META_SLOTS
    dump = B * C * slots
    panel = torch.zeros(dump + 1, dtype=i64, device=dev)

    def zeros():
        return torch.zeros(B, dtype=i64, device=dev)

    # per-lane registers: bit position, context, channel, sample index,
    # count (coefficients read, then samples left in the partition),
    # unary zeros so far, subframe type, order, effective bits, LPC
    # precision, Rice parameter or escape width, partition-header width,
    # partition length, partitions left
    pos, ctx, chan, idx, cnt, q = (zeros() for _ in range(6))
    typ, order, eff, prec, k, rb, plen, pleft = (zeros() for _ in range(8))
    err = torch.zeros(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    while True:
        live = ~(err | done)
        if not bool(live.any()):
            break
        row = (lane * C + chan) * slots
        run = live & ((ctx == CTX_RICE) | (ctx == CTX_WUNARY))
        if bool(run.any()):
            pos, idx, cnt, q = _rice_burst(ext, L, base, end, pos, k, cnt,
                                           idx, q, run, ctx == CTX_RICE, row,
                                           panel)
        # runs of raw samples, all but the last of each
        left = torch.where(ctx == CTX_VERB, N - idx,
                           torch.where(ctx == CTX_ESCS, cnt, 0)) - 1
        raw = live & (left > 0)
        if bool(raw.any()):
            pos, idx, cnt = _raw_burst(ext, L, base, end, pos, idx, cnt,
                                       torch.where(ctx == CTX_VERB, eff, k),
                                       torch.where(raw, left, 0), row, panel)
        c = torch.where(live, ctx, CTX_DONE)
        # the 56-bit window at each lane's position, MSB-first
        at = base + pos
        win = ((_bytes_at(ext, L, at, 7) << byte_sh).sum(1) << (at & 7)) \
            & ((1 << 56) - 1)

        # a fixed-width field
        fw = widths[c]
        regs = torch.stack([eff, prec, rb, k], 1)
        fw = torch.where(fw >= 0, fw,
                         regs.gather(1, (-1 - fw).clamp(min=0)[:, None])[:, 0])
        fw1 = fw.clamp(1, 32)
        v = (win >> (56 - fw)) & ((1 << fw) - 1)
        sv = v - (((v >> (fw1 - 1)) & 1) << fw1)
        # a unary run: zeros before the first 1 of the window's top bits,
        # and for a Rice code the k bits after that 1
        top = win >> (56 - WINDOW)
        z = torch.where(top > 0,
                        WINDOW - torch.frexp(top.double())[1].to(i64), WINDOW)
        found = z < WINDOW
        e1 = z + 1 + k
        whole = found & (e1 <= WINDOW)           # the whole code is here
        lsb = (win >> (56 - e1).clamp(0, 63)) & ((1 << k) - 1)

        m_sub, m_wun, m_cst, m_vrb, m_wrm, m_prc, m_sft, m_cof, m_mth, \
            m_phd, m_esw, m_esc, m_ric, m_lsb = (c == x for x in range(14))
        unary = m_wun | m_ric
        field = live & ~unary
        m_one = m_ric & whole
        used = torch.where(field, fw,
                           torch.where(m_one, e1,
                                       torch.where(found, z + 1, WINDOW)))
        bad = (live & (pos + used > end)) | (unary & (q + z > MAX_Q))

        # subframe header: pad bit, 6-bit type, wasted-bits flag
        t6 = (v >> 1) & 63
        new_order = torch.where(t6 >= 32, (t6 & 31) + 1,
                                torch.where(t6 >= 8, t6 - 8, 0))
        t_ok = (t6 <= 1) | ((t6 >= 8) & (t6 <= 12)) | (t6 >= 32)
        bad |= m_sub & (((v >> 7) != 0) | ~t_ok)
        typ = torch.where(m_sub, t6, typ)
        order = torch.where(m_sub, new_order, order)
        # dispatch once the wasted bits are known
        wun_end = m_wun & found
        aw = (m_sub & ((v & 1) == 0)) | wun_end
        wasted = q + z + 1
        is_side = (((assign == 8) | (assign == 10)) & (chan == 1)) \
            | ((assign == 9) & (chan == 0))
        new_eff = bits_per_sample + is_side.to(i64) \
            - torch.where(wun_end, wasted, 0)
        bad |= aw & ((new_eff <= 0) | (order > N))
        eff = torch.where(aw, new_eff, eff)
        ctx_aw = torch.where(typ == 0, CTX_CONST, torch.where(
            typ == 1, CTX_VERB, torch.where(order > 0, CTX_WARM,
                                            CTX_METHOD)))
        # LPC parameters
        bad |= m_prc & (v == 15)
        prec = torch.where(m_prc, v + 1, prec)
        bad |= m_sft & (sv < 0)
        # residual method and partition order
        po = v & 15
        new_plen = N >> po
        bad |= m_mth & (((v >> 4) > 1) | ((new_plen << po) != N)
                        | (new_plen - order < 1))
        rb = torch.where(m_mth, 4 + (v >> 4), rb)
        plen = torch.where(m_mth, new_plen, plen)
        pleft = torch.where(m_mth, 1 << po, pleft)
        # partition header, escape width
        esc = m_phd & (v == (1 << rb) - 1)
        esc_zero = m_esw & (v == 0)
        k = torch.where((m_phd & ~esc) | m_esw, v, k)
        # residual samples
        rq = torch.where(m_one, q + z, q)
        u = (rq << k) | torch.where(m_one, lsb, v)
        rice = m_one | m_lsb
        bad |= rice & (rq > ((1 << 30) >> k))
        sample = m_vrb | m_wrm | m_esc | rice
        value = torch.where(rice, (u >> 1) ^ -(u & 1), sv)

        # the one value this step makes, into its slot
        meta = torch.where(m_sub, OFF_TYPE, torch.where(
            m_wun, OFF_WASTED, torch.where(
                m_sft, OFF_SHIFT, torch.where(m_cst, OFF_CONST,
                                              OFF_QCOEFF + cnt))))
        put = sample | m_sub | wun_end | m_sft | m_cst | m_cof
        slot = torch.where(put, row + torch.where(sample, idx, N + meta),
                           dump)
        panel.scatter_(0, slot, torch.where(
            sample, value, torch.where(m_sub, t6, torch.where(
                m_wun, wasted, sv))))

        # counters
        pos = pos + torch.where(live, used, 0)
        q = torch.where(unary, torch.where(
            ~found, q + WINDOW, torch.where(m_ric & ~whole, q + z, 0)), q)
        q = torch.where(m_lsb, 0, q)
        idx = idx + sample.to(i64) + torch.where(esc_zero, cnt, 0)
        cnt = torch.where(m_sft, 0, cnt + m_cof.to(i64))
        cnt = torch.where(m_mth, new_plen - order, cnt)
        cnt = cnt - (m_esc | rice).to(i64)
        cnt = torch.where(esc_zero, 0, cnt)
        part_end = ((m_esc | rice) & (cnt == 0)) | esc_zero
        pleft = pleft - part_end.to(i64)
        new_part = part_end & (pleft > 0)
        chan_end = m_cst | (m_vrb & (idx == N)) | (part_end & (pleft == 0))
        chan = chan + chan_end.to(i64)
        idx = torch.where(chan_end, 0, idx)
        cnt = torch.where(new_part, plen, cnt)

        # next context
        nxt = torch.where(m_sub, torch.where((v & 1) == 1, CTX_WUNARY,
                                             ctx_aw), ctx)
        nxt = torch.where(wun_end, ctx_aw, nxt)
        nxt = torch.where(m_wrm & (idx == order), torch.where(
            typ >= 32, CTX_PREC, CTX_METHOD), nxt)
        nxt = torch.where(m_prc, CTX_SHIFT, nxt)
        nxt = torch.where(m_sft, CTX_COEFF, nxt)
        nxt = torch.where(m_cof & (cnt == order), CTX_METHOD, nxt)
        nxt = torch.where(m_mth, CTX_PARTHDR, nxt)
        nxt = torch.where(m_phd, torch.where(esc, CTX_ESCW, CTX_RICE), nxt)
        nxt = torch.where(m_esw, CTX_ESCS, nxt)
        nxt = torch.where(m_ric & found & ~whole, CTX_LSB, nxt)
        nxt = torch.where(m_lsb, CTX_RICE, nxt)
        nxt = torch.where(new_part, CTX_PARTHDR, nxt)
        nxt = torch.where(chan_end, torch.where(chan == C, CTX_DONE,
                                                CTX_SUBHDR), nxt)
        ctx = torch.where(live, nxt, ctx)
        err = err | bad
        done = done | (chan_end & (chan == C))

    ok = done & ~err
    panel = panel[:dump].view(B, C, slots)
    t6 = panel[:, :, N + OFF_TYPE]
    order = torch.where(t6 >= 32, (t6 & 31) + 1,
                        torch.where(t6 >= 8, t6 - 8, 0))
    is_fixed = (t6 >= 8) & (t6 <= 12)
    fixed = device_constant(_FIXED_ROWS_32, i64, dev)
    qco = torch.where(is_fixed[:, :, None], fixed[order.clamp(0, 4)],
                      panel[:, :, N + OFF_QCOEFF:N + OFF_QCOEFF + 32])
    buf = torch.where((t6 == 0)[:, :, None],
                      panel[:, :, N + OFF_CONST][:, :, None],
                      panel[:, :, :N])
    keep = ok[:, None]
    return {
        "buf": torch.where(keep[:, :, None], buf, 0).to(torch.int32),
        "order": torch.where(keep, order, 0).to(torch.int32),
        "shift": torch.where(keep, panel[:, :, N + OFF_SHIFT], 0)
        .to(torch.int32),
        "wasted": torch.where(keep, panel[:, :, N + OFF_WASTED], 0)
        .to(torch.int32),
        "qcoeffs": torch.where(keep[:, :, None], qco, 0).to(torch.int32),
        "ok": ok,
    }


def _bytes_at(ext, L, at, n):
    """(..., n) int64: the n bytes of ``ext`` from byte ``at >> 3`` on;
    bytes outside [0, L) read as ext[L], which is zero."""
    i = (at >> 3)[..., None] + torch.arange(n, device=at.device)
    return ext[torch.where((i >= 0) & (i < L), i, L)]


def _rice_burst(ext, L, base, end, pos, k, cnt, idx, q, run, rice, row,
                panel):
    """The unary-heavy part of a step, over a BURST_BITS window at each
    ``run`` lane's position (a lane in a unary run or a Rice partition).

    A lane at the start of a Rice code (``rice``, no zeros counted yet)
    decodes up to ``cnt - 1`` codes of its partition by pointer doubling:
    the first 1 at or after each bit gives the end of a code starting
    there, and log2(BURST_CODES) rounds of hops give the start of every
    code.  It stops before a code that leaves the window, passes the
    body's end, or breaks the MAX_Q or quotient limit; the step after the
    burst meets that code and flags it.  A lane whose window holds no 1
    counts all of it as zeros.  Scatters the samples into ``panel`` at
    ``row + idx`` and returns (pos, idx, cnt, q) advanced."""
    dev = pos.device
    B, R, J = pos.shape[0], BURST_BITS, BURST_CODES
    at = base + pos
    by = _bytes_at(ext, L, at, R // 8 + 1)
    bits = ((by[:, :, None] >> torch.arange(7, -1, -1, device=dev)) & 1) \
        .reshape(B, -1)
    t = torch.arange(R, device=dev)
    bits = bits.gather(1, (at & 7)[:, None] + t)             # (B, R)
    # the first 1 at or after each bit (R: none in the window); a code
    # starting at bit t ends at one + 1 + k, or R + 1 past the window
    one = torch.where(bits == 1, t, R).flip(1).cummin(1).values.flip(1)
    one = torch.cat([one, one.new_full((B, 2), R)], 1)       # (B, R + 2)
    stop = one + 1 + k[:, None]
    stop = torch.where(stop <= R, stop, R + 1)
    stop[:, R:] = R + 1
    j = torch.arange(J, device=dev)
    start = torch.zeros((B, J), dtype=torch.int64, device=dev)
    hop = stop
    for i in range(J.bit_length() - 1):
        start = torch.where(((j >> i) & 1) == 1, hop.gather(1, start), start)
        hop = hop.gather(1, hop)
    end_j = stop.gather(1, start)
    one_j = one.gather(1, start)
    zeros = one_j - start
    # the k bits after the 1
    kk = k[:, None]
    lbit = at[:, None] + one_j + 1
    w40 = (_bytes_at(ext, L, lbit, 5)
           << torch.tensor([32, 24, 16, 8, 0], device=dev)).sum(-1)
    u = (zeros << kk) | ((w40 >> (40 - (lbit & 7) - kk)) & ((1 << kk) - 1))
    take = ((run & rice & (q == 0))[:, None] & (end_j <= R)
            & (j < (cnt - 1)[:, None]) & (zeros <= MAX_Q)
            & (zeros <= (1 << 30) >> kk)
            & (pos[:, None] + end_j <= end[:, None]))
    take = take.to(torch.int64).cumprod(1) == 1
    n = take.sum(1)
    dump = panel.shape[0] - 1
    panel.scatter_(0, torch.where(take, (row + idx)[:, None] + j, dump)
                   .reshape(-1), ((u >> 1) ^ -(u & 1)).reshape(-1))
    last = end_j.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0]
    blank = run & (one[:, 0] == R) & (pos + R <= end) & (q + R <= MAX_Q)
    pos = pos + torch.where(n > 0, last, 0) + torch.where(blank, R, 0)
    return pos, idx + n, cnt - n, q + torch.where(blank, R, 0)


def _raw_burst(ext, L, base, end, pos, idx, cnt, width, n, row, panel):
    """Read up to min(``n``, BURST_CODES) samples of ``width`` bits from
    each lane's position (``n`` 0: none), as far as the body holds them;
    scatter them into ``panel`` at ``row + idx``; return (pos, idx, cnt)
    advanced (``cnt`` counts down escaped samples; verbatim lanes ignore
    it)."""
    dev = pos.device
    i = torch.arange(BURST_CODES, device=dev)
    w = width[:, None].clamp(1, 32)
    n = torch.minimum(n, (end - pos) // width.clamp(min=1)).clamp(0,
                                                                  BURST_CODES)
    bit = (base + pos)[:, None] + i * w
    w40 = (_bytes_at(ext, L, bit, 5)
           << torch.tensor([32, 24, 16, 8, 0], device=dev)).sum(-1)
    v = (w40 >> (40 - (bit & 7) - w)) & ((1 << w) - 1)
    v = v - (((v >> (w - 1)) & 1) << w)
    take = i < n[:, None]
    dump = panel.shape[0] - 1
    panel.scatter_(0, torch.where(take, (row + idx)[:, None] + i, dump)
                   .reshape(-1), v.reshape(-1))
    return pos + n * width, idx + n, cnt - n


def parse_gate(parsed: dict, valid: torch.Tensor) -> torch.Tensor:
    """What the decoder dispatches on, as one small int64 tensor on the
    parse's device, downloaded once per batch: [every ``valid`` lane is
    ok, the largest order (for ``tap_bucket``), every valid row is
    FIXED-compatible (for ``predict_fixed_batch``)].

    The JAX gate's ``xmax``, ``lpc_shift_max``, ``qabs_max`` and
    ``shift_min`` only choose the Pallas inverse-LPC kernel's limbs; the
    port's ``predict_lpc`` is exact in int64 on every input, so they are
    not ported.
    """
    order, shift, q = parsed["order"], parsed["shift"], parsed["qcoeffs"]
    fixed = device_constant(_FIXED_ROWS_32, q.dtype, q.device)
    rows_fixed = (shift == 0) & (order <= 4) \
        & (q == fixed[order.clamp(0, 4)]).all(-1)
    v = valid[:, None]
    return torch.stack([(parsed["ok"] | ~valid).all().to(torch.int64),
                        torch.where(v, order, 0).amax().to(torch.int64),
                        (rows_fixed | ~v).all().to(torch.int64)])


def byte_capacity(span: int) -> int:
    """The byte buffer a batch's parse graph reads: the next power of two
    at or above ``max(span, 1 MiB)``, so a stream meets few capacities."""
    return max(1 << 20, 1 << (span - 1).bit_length())


def upload_views(blob: torch.Tensor, frames: int) -> tuple:
    """The parser's inputs inside one uploaded uint8 ``blob`` of
    ``frames`` lanes: body offsets (int64), bit lengths and assignments
    (int32), then the bytes.  Returns (data, body_off, nbits,
    assignment), views of ``blob``."""
    head = 16 * frames
    return (blob[head:], blob[:8 * frames].view(torch.int64),
            blob[8 * frames:12 * frames].view(torch.int32),
            blob[12 * frames:head].view(torch.int32))


def parse_batch(blob: torch.Tensor, frames: int, block_size: int,
                channels: int, bits_per_sample: int) -> tuple:
    """The jitted pair of the JAX decoder, ``parse_frame_bodies`` and
    ``parse_gate``, on an uploaded ``blob`` (:func:`upload_views`).
    Lanes with ``nbits`` 0 are padding: they parse to zeros and the gate
    leaves them out (``valid = nbits > 0``, as in the JAX decoder).
    Returns (parsed, gate); ``parsed`` also holds the ``assignment``
    lanes, the reconstruction's last input."""
    data, off, nbits, assign = upload_views(blob, frames)
    parsed = parse_frame_bodies(data, off, nbits, assign, block_size,
                                channels, bits_per_sample)
    parsed["assignment"] = assign
    return parsed, parse_gate(parsed, nbits > 0)


class ParseGraph(CapturedGraph):
    """:func:`parse_batch` on ``stream`` for ``frames`` lanes over a
    ``capacity``-byte buffer, captured once (``graphs.CapturedGraph``),
    with one static uint8 ``input`` blob: the counterpart of the JAX
    decoder's jitted ``parse_frame_bodies`` and ``parse_gate``."""

    def __init__(self, stream, frames: int, capacity: int, block_size: int,
                 channels: int, bits_per_sample: int):
        super().__init__(
            lambda blob: parse_batch(blob, frames, block_size, channels,
                                     bits_per_sample),
            lambda: torch.zeros(16 * frames + capacity, dtype=torch.uint8,
                                device=stream.device),
            stream, shape=(frames, capacity))


# every parse graph of the process, by parse_graph's key
PARSE_GRAPHS: dict = {}


def parse_graph(stream, frames: int, capacity: int, block_size: int,
                channels: int, bits_per_sample: int) -> ParseGraph:
    """The :class:`ParseGraph` for these arguments, captured on first
    use.  The key is JAX's jit key (the lane and word buckets and the
    static arguments; ``bits_per_sample`` is also a launch argument of
    the kernel) plus the device and stream."""
    key = (stream.device, stream.cuda_stream, frames, capacity, block_size,
           channels, bits_per_sample)
    graph = PARSE_GRAPHS.get(key)
    if graph is None:
        graph = PARSE_GRAPHS[key] = ParseGraph(
            stream, frames, capacity, block_size, channels, bits_per_sample)
    return graph
