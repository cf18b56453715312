"""Encode and decode MB/s of PCM for any checkout, in a fresh process.

    python tools/bench_end_to_end.py [--root DIR] [--label NAME] [--runs 5]
        [--stages]

Imports ``flac_codec_tpu_torch`` from the checkout at ``--root``
(default: this one) and ``chip_smoke.py`` from this one, so that two
trees can be held against each other on one card in one call, each in
a process of its own, in turns.  On ``chip_smoke.py``'s 120 s of seeded
stereo 16-bit 44.1 kHz PCM (phases 13 and 16): one untimed encode and
decode build every graph, then ``--runs`` timed runs each of the f64
frame-packed encode (``BatchEncoder``, preset -8, 256-frame batches) and
of the decode of its stream with the host parse and with the device
parse (``BatchDecoder``, PCM left on the card), synchronised.  Prints
each run and ends with one JSON line of the medians, in MB/s of PCM, and
the native engine's flavor, with the card's name and power limit; exits
non-zero without a GPU.  ``--stages`` adds the stage times of each
case's median run (``FLAC_TPU_TRACE``, host clock; ``decode.parse`` is
the native engine's share of the host-parse decode); the trace keeps
its spans in memory and writes them as each pipeline ends, which slows
every case a little, so compare traced runs only with traced runs.  ``FLAC_TPU_PORTABLE_SO=1`` loads the
portable native build on an x86-64-v3 host: run it against unset, in
turns, to time the two flavors.
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
    ap.add_argument("--stages", action="store_true",
                    help="trace and print the median run's stage times")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    trace_path = None
    if args.stages:
        # stage timings go to this file (read at the port's first import)
        trace_path = os.path.join(HERE, "flac_codec_tpu_torch", "build",
                                  "bench_end_to_end",
                                  f"trace-{os.getpid()}.jsonl")
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        os.environ["FLAC_TPU_TRACE"] = trace_path
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
    stage_names = {"encode_f64": cs.ENCODE_STAGES,
                   "decode_host_parse": ("decode.parse",
                                         "decode.reconstruct"),
                   "decode_device_parse": ("decode.scan", "decode.upload",
                                           "decode.parse_device",
                                           "decode.reconstruct")}
    out, stages = {}, {}
    for name, run in cases.items():
        run()
        runs = []
        for _ in range(args.runs):
            if trace_path:
                open(trace_path, "w").close()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            runs.append((time.perf_counter() - t,
                         cs.stage_ms(trace_path, stage_names[name])
                         if trace_path else {}))
        secs = [r[0] for r in runs]
        out[name] = mb / statistics.median(secs)
        stages[name] = sorted(runs, key=lambda r: r[0])[len(runs) // 2][1]
        line = (f"{name}: {out[name]:.2f} MB/s of PCM (median of "
                f"{args.runs}; runs {', '.join(f'{s:.4f}' for s in secs)} "
                f"s for {mb:.2f} MB")
        if trace_path:
            line += "; in the median run " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in stages[name].items())
        print(line + ")")
    result = {"label": args.label or os.path.abspath(args.root),
              "card": cs.card(), "mb_s": out,
              "native_flavor": getattr(native, "FLAVOR", None)}
    if trace_path:
        os.remove(trace_path)
        result["stage_ms"] = stages
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
