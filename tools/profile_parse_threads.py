"""Host time of the native raw parse over one 256-frame CD batch, by spans.

    python3 tools/profile_parse_threads.py [--reps 40] [--evict-mib 256]

Makes the plain reference's ``flac -8`` stream (``benchmark/reference``,
the configuration of ``benchmark/configs/cd16.json``) of
``chip_smoke.music`` long enough for 256 whole frames and a few more, and
times ``parse_frames_raw`` over its first 256 frames, as ``BatchDecoder``'s
host parse calls it a batch, with ``nthreads`` 1 (the one-thread pump), 2,
3, 4, 6 and 8 spans and auto (0), each the median of ``--reps`` calls:

* warm: back to back, the batch's bytes in the caches;
* cold: each after writing ``--evict-mib`` MiB, as a batch's bytes come
  from a track larger than the last-level cache;
* by frames: the first 16, 32, 64 and 128 frames on 1, 2, 4 and 8 spans
  (warm), to show how few frames a span pays for its thread;
* the serial candidate search before the spans: a call whose samples
  left hold one frame (the search over 256 frames, then one frame parsed
  and the stop) less a call of one frame (warm);
* the start and join of the spans' threads: the same calls over 256
  frames of a stream of digital silence in 16-sample blocks (the port's
  encoder: constant frames of a few bytes, almost no parse and 32 KiB of
  output; 2,000 frames, so that the buffer holds the 16 KiB the pump
  asks for), spans against the one-thread pump.

Every call's arrays are checked equal to the one-thread pump's.  Prints
one line a measurement and ends with one JSON line: the ms of each, the
native flavor, the CPU's model and the usable CPUs
(``os.sched_getaffinity``).  Runs on any x86-64 host; no GPU is used.
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
SPANS = (1, 2, 3, 4, 6, 8, 0)
KEYS = ("n", "buf", "order", "shift", "wasted", "qcoeffs", "assignment",
        "blocks", "end_bitpos", "error")


def stream(cfg: dict, pcm: np.ndarray, workers: int) -> bytes:
    from benchmark.harness.pool import encode_reference

    data = encode_reference(pcm, cfg, workers)[0]
    return data if isinstance(data, bytes) else bytes(data)


def silent_stream(cfg: dict, frames: int, block: int) -> bytes:
    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options

    n, buf = frames * block, io.BytesIO()
    w = FlacSampleWriter(buf, Options(block_size=block),
                         cfg["sample_rate"], cfg["bits_per_sample"],
                         cfg["channels"], total_samples=n)
    w.write(np.zeros(cfg["channels"] * n, np.int32))
    w.finalize()
    return buf.getvalue()


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


class Batch:
    """One parse call's arguments over the first frames of ``data``."""

    def __init__(self, nat, data: bytes):
        from flac_codec_tpu_torch.decode import Decoder

        dec = Decoder(io.BytesIO(data))
        si = dec.streaminfo
        self.nat = nat
        self.args = (dec.r.np_view(), dec.r.pos, si.sample_rate,
                     si.channels, si.bits_per_sample,
                     si.maximum_block_size, dec.total_samples)

    def parse(self, frames: int, nthreads: int, left=None) -> dict:
        view, pos, *fmt, total = self.args
        return self.nat.parse_frames_raw(view, pos, frames, *fmt,
                                         left or total, nthreads=nthreads)

    def check(self, frames: int, nthreads: int) -> int:
        """The spans of one call, after checking its arrays equal the
        one-thread pump's."""
        want, got = self.parse(frames, 1), self.parse(frames, nthreads)
        assert want["n"] == frames and want["spans"] == 1, want["error"]
        for k in KEYS:
            assert np.array_equal(got[k], want[k]), (frames, nthreads, k)
        return got["spans"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--evict-mib", type=int, default=256)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()

    import chip_smoke
    from flac_codec_tpu_torch import native

    nat = native.load()
    with open(os.path.join(HERE, "benchmark", "configs", "cd16.json")) as f:
        cfg = json.load(f)
    rate, block = cfg["sample_rate"], cfg["block_size"]
    n = (FRAMES + 4) * block + 1000
    music = Batch(nat, stream(cfg, chip_smoke.music(
        n / rate, rate, cfg["bits_per_sample"], seed=7), args.workers))
    silence = Batch(nat, silent_stream(cfg, 2000, 16))
    sink = np.zeros(args.evict_mib << 20, np.uint8)
    count = [0]

    def evict():
        count[0] += 1
        sink.fill(count[0] & 0xFF)

    out = {"cpu": cpu_model(), "usable_cpus": len(os.sched_getaffinity(0)),
           "flavor": native.FLAVOR, "frames": FRAMES}
    for nt in SPANS:
        row = {"spans": music.check(FRAMES, nt)}
        for temp in ("warm", "cold"):
            row[f"{temp}_ms"] = round(median_ms(
                lambda: music.parse(FRAMES, nt), args.reps,
                evict if temp == "cold" else None), 4)
        row["silence_ms"] = round(median_ms(
            lambda: silence.parse(FRAMES, nt), args.reps), 4)
        assert silence.check(FRAMES, nt) == row["spans"]
        out[f"nthreads_{nt}"] = row
        print(f"nthreads {nt}: {row}", flush=True)
    block = music.args[-2]
    search = median_ms(lambda: music.parse(FRAMES, 1, block), args.reps)
    one = median_ms(lambda: music.parse(1, 1), args.reps)
    out["search_ms"] = round(search - one, 4)
    print(f"candidate search: {search:.4f} - {one:.4f} ms", flush=True)
    for frames in (16, 32, 64, 128):
        row = {}
        for nt in (1, 2, 4, 8):
            music.check(frames, nt)
            row[f"spans_{nt}_ms"] = round(median_ms(
                lambda: music.parse(frames, nt), args.reps), 4)
        out[f"frames_{frames}"] = row
        print(f"{frames} frames: {row}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
