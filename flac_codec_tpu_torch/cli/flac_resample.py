"""flac-resample — FLAC -> FLAC at a new sample rate
(reference: examples/flac-resample.rs, rubato FFT resampler).

Uses a windowed-sinc polyphase resampler implemented with numpy (no
external DSP dependency in this image).
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from ..decode import FlacChannelReader
from ..encode import FlacChannelWriter, Options


def resample_channel(x: np.ndarray, src: int, dst: int,
                     taps: int = 64) -> np.ndarray:
    """Windowed-sinc resampling of one channel (float64 internally)."""
    if src == dst:
        return x.copy()
    g = math.gcd(src, dst)
    up, down = dst // g, src // g
    xf = x.astype(np.float64)
    n_out = int(len(x) * up / down)
    # output sample t maps to input position t * down / up
    pos = np.arange(n_out) * (down / up)
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    half = taps // 2
    cutoff = min(1.0, up / down) * 0.95
    padded = np.pad(xf, (half, half + 1))
    acc = np.zeros(n_out)
    norm = np.zeros(n_out)
    for k in range(-half, half + 1):
        t = k - frac  # sinc argument
        h = cutoff * np.sinc(cutoff * t)
        h *= 0.54 + 0.46 * np.cos(math.pi * t / half)  # Hamming
        acc += h * padded[base + k + half]
        norm += h
    return np.clip(np.round(acc / np.maximum(norm, 1e-12)),
                   np.iinfo(np.int32).min, np.iinfo(np.int32).max
                   ).astype(np.int64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-resample")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("rate", type=int)
    args = p.parse_args(argv)

    r = FlacChannelReader(args.input)
    si = r.streaminfo
    channels = r.read_all()
    hi = (1 << (si.bits_per_sample - 1)) - 1
    lo = -(1 << (si.bits_per_sample - 1))
    resampled = [np.clip(resample_channel(ch, si.sample_rate, args.rate),
                         lo, hi) for ch in channels]
    w = FlacChannelWriter(args.output, Options(), args.rate,
                          si.bits_per_sample, si.channels,
                          total_samples=len(resampled[0]))
    w.write(resampled)
    w.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
