"""Time the port's K2 ``pack_symbols`` kernel at preset -8 on one GPU.

    python tools/bench_pack_symbols.py [--root DIR] [--label NAME]
        [--rows 1,132,256] [--warm]

Times ``flac_codec_tpu_torch.ops.packpanel.pack_symbols`` from the
checkout at ``--root`` (default: this one), so that two trees can be
compared in one run on one card.  The symbol lists are those of
``chip_smoke.k2_lists`` on the first 256-frame batch of ``chip_smoke.py``'s
seeded 120 s 16-bit clip, planned by the checkout's own planner: the lists
the frame packer hands K2 for both channel slots (residual section and
header fields, M = 4229), the planner's residual sections alone (M =
4161), slot 0's lists with their columns permuted, and random disjoint
lists.  Each list is first checked against the checkout's plain version
(panels and overflow flags equal), then timed: ``kernel_ms`` is the
device time alone (``chip_smoke.device_ms``, inputs rotating among copies
that span twice the L2), ``call_ms`` one call as a caller waits for it
(``chip_smoke.cuda_ms``), ``profiler_ms`` the kernel's own device time by
``torch.profiler`` (null where it records none), beside the bytes bound.
``--rows`` also times the first rows of the slot-0 list alone (how the
time grows with rows per SM); ``--warm`` also times each list on one
copy, its inputs left in the L2 by the previous launch (as the frame
packer leaves them for the pack).  Prints one JSON line per timing and
exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose flac_codec_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", default="",
                    help="comma-separated row counts of the slot-0 list")
    ap.add_argument("--warm", action="store_true",
                    help="also time each list on one L2-resident copy")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_pack_symbols.py needs a CUDA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_lists", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.ops import packpanel

    kernels.library()
    dev = torch.device("cuda", 0)
    label = args.label or os.path.basename(os.path.abspath(args.root))
    pcm = cs.music(cs.SECONDS_16, 44100, 16, seed=16)
    _, P, lists = cs.k2_lists(dev, pcm)

    def timing(name, sym, warm):
        b = cs.k2_bound(sym, P)
        copies = cs.k2_copies(sym, 1 if warm else cs.rotation(
            b["bound_ms"] * 1e-3 * cs.HBM_BYTES_PER_S))

        def run(i):
            return packpanel.pack_symbols(*copies[i], P)

        print(json.dumps({
            "tree": label, "list": name, "rows": sym[0].shape[0],
            "M": sym[0].shape[1], "P": P, "copies": len(copies),
            "L2": "warm" if warm else "cold",
            "kernel_ms": cs.device_ms(run, len(copies)),
            "call_ms": cs.cuda_ms(lambda: run(0)),
            "profiler_ms": cs.profiler_ms(run, "pack_symbols", len(copies)),
            **b, "card": cs.card()}), flush=True)

    for name, sym in lists.items():
        got, ovf = packpanel.pack_symbols(*sym, P)
        want, wovf = packpanel.pack_symbols_plain(*sym, P)
        if not (torch.equal(got, want) and torch.equal(ovf, wovf)):
            raise AssertionError(f"pack_symbols ({name}) disagrees with its "
                                 "plain version")
        for warm in (False, True)[:1 + args.warm]:
            timing(name, sym, warm)
    for rows in (int(r) for r in args.rows.split(",") if r):
        sub = tuple(a[:rows].contiguous() for a in lists["framepack slot 0"])
        for warm in (False, True)[:1 + args.warm]:
            timing(f"framepack slot 0, first {rows} rows", sub, warm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
