"""Time the port's float64 autocorrelation + Levinson kernel and its K1
``splice_subframes`` kernel at preset -8 on one GPU.

    python tools/bench_autocorr_splice.py [--root DIR] [--label NAME]
        [--rows 1,132,528,1088] [--orders 12,32] [--tile-steps 4,8,16]
        [--only autocorr|splice]

Times ``flac_codec_tpu_torch.ops.lpc.autocorr_levinson`` and
``flac_codec_tpu_torch.ops.packpanel.splice_subframes`` from the checkout
at ``--root`` (default: this one), so that two trees can be compared in
one run on one card.  The inputs are ``chip_smoke.py``'s, made by the
helpers of this file's ``chip_smoke.py`` with the checkout's own
decorrelation:

* autocorrelation: the 1024 windowed decorrelation candidates of the
  first 256-frame batch of the seeded 120 s 16-bit clip and 64 near-pure
  sines (1088 rows of N = 4096), at orders 12 (preset -8) and 32;
* K1: 256 frames of 2 panels of 2688 words with random bits at their
  cumulative offsets into 5248-word slots (preset -8 stereo), and 256
  frames of 8 panels of 13696 words into 107520-word slots (8 channels,
  24 bits, block 16384).

Each input is first checked against the checkout's plain version (bit
for bit), then timed: ``kernel_ms`` is the device time alone
(``chip_smoke.device_ms``, inputs rotating among copies that span twice
the L2), ``call_ms`` one call as a caller waits for it
(``chip_smoke.cuda_ms``), ``profiler_ms`` the kernel's own device time by
``torch.profiler`` (null where it records none), beside the bounds
(bytes, operations, and for the autocorrelation the shared memory this
file's kernel design moves, at the SM clock sampled under load).
``--rows`` also times the first rows (frames, for K1) alone: how the time
grows with rows per SM.  ``--orders`` sets the autocorrelation's orders
(order 1 does no Levinson step: its time less order 12's is the
recursion's); ``--tile-steps`` also times the full autocorrelation input
at other tiles of the kernel's ring (``autocorr_levinson(...,
tile_steps=)``, which older trees lack); ``--only`` times one kernel.
Prints one JSON line per timing and exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose flac_codec_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", default="",
                    help="comma-separated row (frame) counts to time alone")
    ap.add_argument("--orders", default="12,32",
                    help="comma-separated autocorrelation orders")
    ap.add_argument("--tile-steps", default="",
                    help="comma-separated tiles (in 32-sample steps)")
    ap.add_argument("--only", choices=("autocorr", "splice"), default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_autocorr_splice.py needs a CUDA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.ops import framepack, lpc, packpanel

    kernels.library()
    dev = torch.device("cuda", 0)
    label = args.label or os.path.basename(os.path.abspath(args.root))
    subsets = [int(r) for r in args.rows.split(",") if r]

    def emit(kernel, name, fn, copies, nbytes_bound, extra):
        print(json.dumps({
            "tree": label, "kernel": kernel, "input": name,
            "copies": copies, "kernel_ms": cs.device_ms(fn, copies),
            "call_ms": cs.cuda_ms(lambda: fn(0)),
            "profiler_ms": cs.profiler_ms(
                fn, "splice_kernel" if kernel == "splice_subframes"
                else kernel, copies),
            **nbytes_bound, **extra, "card": cs.card()}), flush=True)

    # the autocorrelation
    B, N = cs.BATCH_FRAMES, 4096
    pcm = cs.music(cs.SECONDS_16, 44100, 16, seed=16)
    batch = torch.as_tensor(pcm[:B * N * 2].reshape(B, N, 2)
                            .transpose(0, 2, 1).copy(), device=dev)
    windowed = cs.autocorr_rows(dev, batch)
    R, N = windowed.shape
    for M in [int(m) for m in args.orders.split(",")]:
        if args.only == "splice":
            break
        if not cs.bit_equal(lpc.autocorr_levinson(windowed, M),
                            lpc.autocorr_levinson_plain(windowed, M)):
            raise AssertionError(f"autocorr_levinson (M={M}) disagrees with "
                                 "the host's numpy")
        mhz = cs.sm_clock_under_load(
            lambda: lpc.autocorr_levinson(windowed, M), 0.05)
        for rows in [R] + subsets:
            sub = windowed[:rows]
            copies = [sub.clone() for _ in range(cs.rotation(rows * N * 8))]
            b = cs.autocorr_bound(rows, N, M)
            b["smem_ms"] = cs.smem_ms(cs.autocorr_smem_bytes(rows, N, M),
                                      mhz)
            emit("autocorr_levinson", f"rows={rows} N={N} M={M}",
                 lambda i: lpc.autocorr_levinson(copies[i], M), len(copies),
                 b, {"sm_mhz": mhz})
            del copies
        copies = [windowed.clone() for _ in range(cs.rotation(R * N * 8))]
        want = lpc.autocorr_levinson(windowed, M)
        for steps in (int(t) for t in args.tile_steps.split(",") if t):
            if not cs.bit_equal(lpc.autocorr_levinson(windowed, M,
                                                      tile_steps=steps), want):
                raise AssertionError(f"autocorr_levinson (M={M}, tile_steps="
                                     f"{steps}) disagrees with its default")
            b = cs.autocorr_bound(R, N, M)
            b["smem_ms"] = cs.smem_ms(cs.autocorr_smem_bytes(R, N, M), mhz)
            emit("autocorr_levinson",
                 f"rows={R} N={N} M={M} tile_steps={steps}",
                 lambda i: lpc.autocorr_levinson(copies[i], M,
                                                 tile_steps=steps),
                 len(copies), b, {"sm_mhz": mhz})
        del copies

    # K1 at the stereo and the 8-channel slot
    rng = np.random.default_rng(2)
    for S, N1, bps in ((2, 4096, 16), (8, 16384, 24)):
        if args.only == "autocorr":
            break
        P = framepack.subframe_panel_words(N1, bps + 2)
        W = framepack.frame_slot_words(S, N1, bps + 2)
        lens = (rng.integers(1, P * 32, (B, S)) if S == 2
                else rng.integers(P * 8, P * 16, (B, S)))
        panels, offs = cs.k1_frames(dev, lens, P, seed=S)
        if not torch.equal(packpanel.splice_subframes(panels, offs, W),
                           packpanel.splice_subframes_plain(panels, offs, W)):
            raise AssertionError(f"splice_subframes (S={S}) disagrees with "
                                 "its plain version")
        for frames in [B] + [f for f in subsets if f < B]:
            p, o = panels[:frames].contiguous(), offs[:frames].contiguous()
            copies = [(p.clone(), o.clone()) for _ in range(
                cs.rotation(frames * S * (P + 1) * 4))]
            emit("splice_subframes",
                 f"B={frames} S={S} P={P} W={W}",
                 lambda i: packpanel.splice_subframes(*copies[i], W),
                 len(copies), cs.k1_bound(o, P, W), {})
            del copies
    return 0


if __name__ == "__main__":
    sys.exit(main())
