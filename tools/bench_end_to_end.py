"""Encode and decode MB/s of PCM for any checkout, in a fresh process.

    python tools/bench_end_to_end.py [--root DIR] [--label NAME] [--runs 5]

Imports ``flac_codec_tpu_torch`` from the checkout at ``--root``
(default: this one) and ``chip_smoke.py`` from this one, so that two
trees can be held against each other on one card in one call, each in
a process of its own, in turns.  On ``chip_smoke.py``'s 120 s of seeded
stereo 16-bit 44.1 kHz PCM (phases 13 and 16): one untimed encode and
decode build every graph, then ``--runs`` timed runs each of the f64
frame-packed encode (``BatchEncoder``, preset -8, 256-frame batches) and
of the decode of its stream with the host parse and with the device
parse (``BatchDecoder``, PCM left on the card), synchronised.  Prints
each run and ends with one JSON line of the medians, in MB/s of PCM,
with the card's name and power limit; exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose flac_codec_tpu_torch is measured")
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_end_to_end.py needs a CUDA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rates", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from flac_codec_tpu_torch import kernels, native

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        for b in [ex.submit(kernels.library), ex.submit(native.load)]:
            b.result()
    dev = torch.device("cuda", 0)
    pcm = cs.music(cs.SECONDS_16, 44100, 16, seed=16)
    mb = len(pcm) * 2 / 1e6
    data, _ = cs.encode_port(pcm, 44100, 16, "f64", dev)
    cases = {
        "encode_f64": lambda: cs.encode_port(pcm, 44100, 16, "f64", dev),
        "decode_host_parse": lambda: cs.decode_port(data, dev),
        "decode_device_parse": lambda: cs.decode_port(data, dev,
                                                      device_parse=True),
    }
    out = {}
    for name, run in cases.items():
        run()
        secs = []
        for _ in range(args.runs):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t)
        out[name] = mb / statistics.median(secs)
        print(f"{name}: {out[name]:.2f} MB/s of PCM (median of "
              f"{args.runs}; runs {', '.join(f'{s:.4f}' for s in secs)} s "
              f"for {mb:.2f} MB)")
    print(json.dumps({"label": args.label or os.path.abspath(args.root),
                      "card": cs.card(), "mb_s": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
