"""Host time of the native frame scan over one 256-frame batch.

    python3 tools/profile_scan.py [--warm 40] [--cold 12] [--evict-mib 256]

Makes the plain reference's ``flac -8`` stream (``benchmark/reference``,
the configuration of ``benchmark/configs/{hires24,cd16}.json``) of
``chip_smoke.music`` long enough for 256 whole frames and a few more, and
times ``scan_frames`` over its first 256 frames, as ``BatchDecoder``'s
device parse calls it a batch, in both scan paths: the engine's own
(``scan_frames``: one AVX2 and PCLMUL pass a frame where the host has
both) and the portable loop (``scan_frames_portable``).  For each:

* warm: the median of ``--warm`` calls back to back, the batch's bytes
  in the caches;
* cold: the median of ``--cold`` calls, each after writing
  ``--evict-mib`` MiB, as a batch's bytes come from a track larger than
  the last-level cache;
* the cold-read floor: the median time to sum the batch's bytes as
  64-bit words after the same eviction (and warm, to show the sum is
  bound by memory when cold).

Prints one line a measurement and ends with one JSON line: ms and GB/s
of the batch's bytes for each, the native flavor, whether the engine
takes the SIMD pass, and the CPU's model.  Runs on any x86-64 host; no
GPU is used.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

FRAMES = 256


def stream(cfg: dict, workers: int) -> bytes:
    """The reference's stream of ``chip_smoke.music`` in ``cfg``'s
    format: FRAMES + 4 whole frames and a short tail."""
    import chip_smoke
    from benchmark.harness.pool import encode_reference

    n = (FRAMES + 4) * cfg["block_size"] + 1000
    pcm = chip_smoke.music(n / cfg["sample_rate"], cfg["sample_rate"],
                           cfg["bits_per_sample"], seed=7)
    data = encode_reference(pcm, cfg, workers)[0]
    return data if isinstance(data, bytes) else bytes(data)


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def median_ms(fn, reps: int, evict=None) -> float:
    times = []
    for _ in range(reps):
        if evict is not None:
            evict()
        t0 = time.perf_counter_ns()
        fn()
        times.append((time.perf_counter_ns() - t0) / 1e6)
    return statistics.median(times)


def profile(name: str, cfg: dict, args, nat, evict) -> dict:
    from flac_codec_tpu_torch.decode import Decoder

    data = stream(cfg, args.workers)
    dec = Decoder(io.BytesIO(data))
    si = dec.streaminfo
    view, pos = dec.r.np_view(), dec.r.pos
    call = (view, pos, FRAMES, si.sample_rate, si.channels,
            si.bits_per_sample, cfg["block_size"], None)
    first = nat.scan_frames(*call)
    assert first["n"] == FRAMES, first["error"]
    for k in ("body_off", "body_bytes", "assignment", "end_bitpos"):
        assert np.array_equal(first[k], nat.scan_frames_portable(*call)[k])
    a, b = pos // 8, first["end_bitpos"] // 8
    nbytes = b - a
    words = view[a:a + nbytes // 8 * 8].view(np.uint64)
    out = {"bytes": int(nbytes)}

    def read():
        words.sum()

    for label, fn in (("scan", lambda: nat.scan_frames(*call)),
                      ("portable", lambda: nat.scan_frames_portable(*call)),
                      ("read", read)):
        for temp in ("warm", "cold"):
            ms = median_ms(fn, args.warm if temp == "warm" else args.cold,
                           evict if temp == "cold" else None)
            out[f"{label}_{temp}_ms"] = round(ms, 4)
            out[f"{label}_{temp}_gbps"] = round(nbytes / ms / 1e6, 3)
            print(f"{name} {label} {temp}: {ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.3f} GB/s of {nbytes:,} bytes",
                  flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=40)
    ap.add_argument("--cold", type=int, default=12)
    ap.add_argument("--evict-mib", type=int, default=256)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()

    from flac_codec_tpu_torch import native

    nat = native.load()
    sink = np.zeros(args.evict_mib << 20, np.uint8)
    count = [0]

    def evict():
        count[0] += 1
        sink.fill(count[0] & 0xFF)

    result = {"cpu": cpu_model(), "flavor": native.FLAVOR,
              "simd": nat.scan_simd, "frames": FRAMES}
    for name in ("hires24", "cd16"):
        with open(os.path.join(HERE, "benchmark", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        result[name] = profile(name, cfg, args, nat, evict)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
