"""Time the port's K3 ``predict_lpc`` kernel at R = 512, N = 4096 on one GPU.

    python tools/bench_predict_lpc.py [--root DIR] [--label NAME]

Times ``flac_codec_tpu_torch.ops.predict_pallas.predict_lpc`` from the
checkout at ``--root`` (default: this one), so that two trees can be
compared in one run on one card: seeded rows (``chip_smoke.lpc_rows``) in
every tap bucket, and the int32 boundary rows of
``chip_smoke.INT32_EDGE_CASES`` among seeded rows at tap bucket 32.  Each
time is the kernel's device time alone (``chip_smoke.device_ms``: the
median of 5 runs of back-to-back launches queued behind a device spin,
rotating among copies of the inputs that span twice the L2); the SM clock is
sampled by ``nvidia-smi`` while the bucket-12 set runs back to back, and
each time is also given in cycles a step (ms x clock / N).  Prints one
JSON line per set and exits non-zero without a GPU.
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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_predict_lpc.py needs a CUDA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rows", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.ops.predict_pallas import predict_lpc

    kernels.library()
    dev = torch.device("cuda", 0)
    R, N = 512, 4096
    rng = np.random.default_rng(6)
    sets = []
    for t in (4, 8, 12, 16, 32):
        orders = rng.integers(1, t + 1, R)
        orders[:2] = [0, t]
        sets.append((f"random taps={t}", cs.lpc_rows(rng, orders, N), t))
    edge = cs.int32_edge_rows(N)[:4]
    rows = cs.lpc_rows(rng, rng.integers(1, 33, R - len(edge[0])), N)
    sets.append(("int32 edge taps=32",
                 [np.concatenate([a, b]) for a, b in zip(edge, rows)], 32))
    label = args.label or os.path.basename(os.path.abspath(args.root))
    sets = [(name, [torch.as_tensor(v, device=dev) for v in arrays], t)
            for name, arrays, t in sets]
    a12 = sets[2][1]
    mhz = cs.sm_clock_under_load(lambda: predict_lpc(*a12, 12),
                                 cs.cuda_ms(lambda: predict_lpc(*a12, 12)))
    for name, a, t in sets:
        copies = [[x.clone() for x in a]
                  for _ in range(cs.rotation(a[0].numel() * 4))]
        ms = cs.device_ms(lambda i: predict_lpc(*copies[i], t), len(copies))
        del copies
        print(json.dumps({"tree": label, "set": name, "R": R, "N": N,
                          "taps": t, "ms": ms, "sm_mhz": mhz,
                          "cycles_per_step": ms * 1e-3 * mhz * 1e6 / N,
                          "card": cs.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
