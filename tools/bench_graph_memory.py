"""The CUDA graphs' memory across a mixed library, for any checkout.

    python tools/bench_graph_memory.py [--root DIR] [--label NAME]

Runs ``chip_smoke.mixed_library`` (phase 20 of ``chip_smoke.py``) in a
fresh process with ``flac_codec_tpu_torch`` imported from the checkout at
``--root`` (default: this one), so that two trees can be compared in one
run on one card: five formats (mono and stereo 16-bit 44.1 kHz, stereo
24-bit 96 kHz, 6-channel 24-bit 48 kHz, 8-channel 24-bit 96 kHz at block
16384) encoded in f64 and f32 at 256-frame batches and decoded through
both parse paths, then the first format encoded again.  Prints
``memory_reserved`` after each format, its growth over the run and its
peak, and the largest single capture's pool (the 8-channel configuration
captured alone on a fresh stream) with that capture's peak ("not kept"
for a checkout whose graphs do not measure it); the checks of the phase
hold (bytes, PCM), but the growth and the peak are reported, not held
to a limit.  Ends with one JSON line, and exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose flac_codec_tpu_torch is measured")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_graph_memory.py needs a CUDA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_library", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from flac_codec_tpu_torch import kernels, native

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        for b in [ex.submit(kernels.library), ex.submit(native.load)]:
            b.result()
    out = cs.mixed_library(torch.device("cuda", 0), check=False)
    print(json.dumps({"label": args.label or os.path.abspath(args.root),
                      "card": cs.card(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
