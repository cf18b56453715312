#!/usr/bin/env python
"""Randomized differential round-trip fuzzer for the PyTorch/CUDA port.

The port's counterpart of ``tools/fuzz_roundtrip.py``: the same trials,
drawn from the same seed by the same calls in the same order, so a
failing seed replays in both tools.  Every path is checked against
every other:

  host mode (default):
    FlacSampleWriter -> FlacSampleReader + verify() + the structured
    rebuild (format.frame_model.rebuild_stream)

  device mode (--device, needs a CUDA GPU):
    BatchEncoder(analysis="f64")  == byte-identical ==  FlacSampleWriter
    BatchDecoder, host parse and device parse == FlacSampleReader == input

Signal classes are chosen to hit encoder decision boundaries: white
noise (verbatim-ish), sines (LPC), near-silence (constant/low rice),
step functions (FIXED + rare huge residuals -> over-long unary codes and
escapes), and wasted-bits signals.  On the card they drive every kernel
of the port (the autocorrelation, K2 and K1 in the encoder, K4 in the
device parse, K3 in both decodes) through the entry points a user calls.

Usage:
  python tools/fuzz_roundtrip_torch.py [--seconds N] [--seed S]
                                       [--trials T] [--device]

Exit code 0 = no failures.  Failures print the full config for replay.
Without CUDA, --device raises.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from flac_codec_tpu_torch.decode import FlacSampleReader, Verified, verify
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.format.frame_model import rebuild_stream
from flac_codec_tpu_torch.parallel.batch import BatchEncoder
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder


def make_signal(rng, kind: str, bps: int, total: int) -> np.ndarray:
    hi = (1 << (bps - 1)) - 1
    if kind == "noise":
        pcm = rng.integers(-hi - 1, hi + 1, total)
    elif kind == "sine":
        pcm = np.round(0.7 * hi * np.sin(np.arange(total) * 0.01))
    elif kind == "quiet":
        pcm = rng.integers(-5, 6, total)
    elif kind == "steps":
        pcm = np.repeat(rng.integers(-hi - 1, hi + 1, total // 50 + 1),
                        50)[:total]
    else:  # wasted
        pcm = rng.integers(-(hi >> 4) - 1, (hi >> 4) + 1, total) << 4
    return np.asarray(pcm, dtype=np.int64)


def fuzz_host(rng, deadline: float, max_trials: int) -> int:
    fails = trials = 0
    while time.time() < deadline and trials < max_trials:
        trials += 1
        bps = int(rng.choice([8, 12, 16, 20, 24, 32]))
        ch = int(rng.choice([1, 2, 2, 2, 4, 8]))
        block = int(rng.choice([16, 192, 256, 576, 1152, 4096]))
        n = int(rng.integers(1, 4)) * block + int(rng.integers(0, block))
        lpc = int(rng.choice([0, 1, 8, 12, 32]))
        po = int(rng.choice([0, 3, 6]))
        mid = bool(rng.integers(0, 2)) and ch == 2
        exh = bool(rng.integers(0, 2))
        kind = str(rng.choice(["noise", "sine", "quiet", "steps", "wasted"]))
        pcm = make_signal(rng, kind, bps, n * ch)
        cfg = (f"bps={bps} ch={ch} block={block} n={n} lpc={lpc} po={po} "
               f"mid={mid} exh={exh} kind={kind}")
        opts = (Options().with_block_size(block).no_seektable()
                .with_max_lpc_order(lpc if lpc else None)
                .with_max_partition_order(po).with_mid_side(mid)
                .fast_channel_correlation(not exh))
        try:
            buf = io.BytesIO()
            w = FlacSampleWriter(buf, opts, 44100, bps, ch, total_samples=n)
            w.write(pcm)
            w.finalize()
            data = buf.getvalue()
            got = np.asarray(
                FlacSampleReader(io.BytesIO(data)).read_to_end())
            assert np.array_equal(got, pcm), "decode mismatch"
            assert verify(io.BytesIO(data)) == Verified.MD5_MATCH
            assert rebuild_stream(io.BytesIO(data)) == data, \
                "structured rebuild mismatch"
        except Exception as e:
            print(f"FAIL trial {trials}: {cfg}: {e!r}", flush=True)
            fails += 1
    print(f"host fuzz: {trials} trials, {fails} failures")
    return fails


def fuzz_device(rng, deadline: float, max_trials: int,
                device="cuda") -> int:
    """Device-mode trials on ``device``; a CUDA device without CUDA
    raises before the first trial."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fuzz_device(device='cuda'): CUDA is not "
                           "available")
    fails = trials = 0
    # few distinct (block, bps) combos so the captured graphs stay few
    combos = [(256, 16), (256, 24), (1152, 16)]
    while time.time() < deadline and trials < max_trials:
        trials += 1
        block, bps = combos[int(rng.integers(0, len(combos)))]
        n = int(rng.integers(2, 6)) * block + int(rng.integers(0, block))
        kind = str(rng.choice(["noise", "sine", "quiet", "steps", "wasted"]))
        pcm = make_signal(rng, kind, bps, n * 2)
        cfg = f"block={block} bps={bps} n={n} kind={kind}"
        opts = Options.best().with_block_size(block).no_seektable()
        try:
            b1 = io.BytesIO()
            enc = BatchEncoder(b1, opts, 44100, bps, 2, total_samples=n,
                               batch_frames=4, analysis="f64", device=device)
            enc.write(pcm)
            enc.finalize()
            data = b1.getvalue()
            b2 = io.BytesIO()
            w = FlacSampleWriter(b2, opts, 44100, bps, 2, total_samples=n)
            w.write(pcm)
            w.finalize()
            assert data == b2.getvalue(), "f64 device/host stream parity"
            for device_parse in (False, True):
                with BatchDecoder(io.BytesIO(data), batch_frames=4,
                                  device=device,
                                  device_parse=device_parse) as bd:
                    out = bd.read_all_device().cpu().numpy().reshape(-1)
                assert np.array_equal(out[: n * 2], pcm), \
                    f"device decode (device_parse={device_parse})"
            got = np.asarray(
                FlacSampleReader(io.BytesIO(data)).read_to_end())
            assert np.array_equal(got, pcm), "host decode"
        except Exception as e:
            print(f"FAIL trial {trials}: {cfg}: {e!r}", flush=True)
            fails += 1
    print(f"device fuzz: {trials} trials, {fails} failures")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--trials", type=int, default=10 ** 9)
    ap.add_argument("--device", action="store_true",
                    help="fuzz the batch (device) pipelines on the card "
                         "instead")
    args = ap.parse_args(argv)
    seed = args.seed if args.seed is not None else int(time.time())
    print(f"seed={seed}")
    rng = np.random.default_rng(seed)
    deadline = time.time() + args.seconds
    fn = fuzz_device if args.device else fuzz_host
    return 1 if fn(rng, deadline, args.trials) else 0


if __name__ == "__main__":
    sys.exit(main())
