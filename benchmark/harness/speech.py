"""The speech traffic's signal: seeded speech-like mono PCM, made on the
device.

An utterance is a run of segments drawn on the host from one ``numpy``
generator: voiced syllables of 80-300 ms, unvoiced bursts of 30-150 ms
and pauses of 50-500 ms.  A syllable is the harmonics of an f0 drawn in
85-255 Hz that drifts by up to 15% across it, their amplitudes falling
as 1/h and shaped by three formant peaks (F1 300-900, F2 900-2,500, F3
2,500-3,500 Hz), under a raised-cosine envelope; a burst is white noise
differenced once (a fricative's rising spectrum) under the same
envelope.  The segments are scaled so that their peak is 0.5 of full
scale, and a Gaussian noise floor of ``floor_dbfs`` (RMS, dB of full
scale) lies under all of them, the pauses too: the room noise of a read
recording, and no digital silence.  The waves and the noise are
computed on ``device`` in float64, the noise from a ``torch.Generator``
seeded from the same seed.
"""

from __future__ import annotations

import numpy as np

HARMONICS = 48
FORMANTS = ((300, 900, 90.0, 1.0), (900, 2500, 140.0, 0.5),
            (2500, 3500, 250.0, 0.25))   # (low Hz, high Hz, width, gain)
PAUSE, VOICED, UNVOICED = range(3)


def segments(seconds: float, rate: int, seed: int) -> dict:
    """The segments of an utterance of ``seconds``: per segment its kind,
    start, length, amplitude, f0, drift and formant frequencies."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * rate))
    kind, start, length, amp, f0, drift, formants = ([] for _ in range(7))
    pos = 0
    while pos < n:
        k = rng.choice(3, p=(0.25, 0.55, 0.20))
        lo_s, hi_s = {PAUSE: (0.05, 0.5), VOICED: (0.08, 0.3),
                      UNVOICED: (0.03, 0.15)}[k]
        m = min(n - pos, max(1, int(rng.uniform(lo_s, hi_s) * rate)))
        kind.append(k)
        start.append(pos)
        length.append(m)
        amp.append(rng.uniform(0.5, 1.0) if k == VOICED
                   else rng.uniform(0.05, 0.25))
        f0.append(rng.uniform(85, 255))
        drift.append(rng.uniform(-0.15, 0.15))
        formants.append([rng.uniform(lo, hi) for lo, hi, _, _ in FORMANTS])
        pos += m
    return {"n": n, "kind": np.array(kind), "start": np.array(start),
            "len": np.array(length), "amp": np.array(amp),
            "f0": np.array(f0), "drift": np.array(drift),
            "formants": np.array(formants)}


def _harmonic_gains(p: dict, rate: int) -> np.ndarray:
    """(segments, HARMONICS) amplitude of each harmonic: 1/h under the
    sum of the three formant peaks at its mean frequency, zero from 0.95
    of Nyquist up."""
    h = np.arange(1, HARMONICS + 1)
    f = p["f0"][:, None] * (1 + np.abs(p["drift"])[:, None]) * h
    peaks = sum(g / (1 + ((f - p["formants"][:, [i]]) / w) ** 2)
                for i, (_, _, w, g) in enumerate(FORMANTS))
    gains = peaks / h
    gains[f >= 0.95 * rate / 2] = 0
    return gains / np.maximum(gains.sum(1, keepdims=True), 1e-12)


def utterance(seconds: float, rate: int, bps: int, seed: int, device,
              floor_dbfs: float, chunk: int = 1 << 20):
    """A (1, samples) int32 tensor on ``device``: the seeded utterance,
    made ``chunk`` samples at a time so that the temporaries stay
    small."""
    import torch

    p = segments(seconds, rate, seed)
    n = p["n"]
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    seg_of = torch.repeat_interleave(
        torch.arange(len(p["len"]), device=dev),
        torch.as_tensor(p["len"], device=dev))
    kind = torch.as_tensor(p["kind"], device=dev)
    start = torch.as_tensor(p["start"], **f64)
    length = torch.as_tensor(p["len"], **f64)
    amp = torch.as_tensor(p["amp"], **f64)
    f0 = torch.as_tensor(p["f0"], **f64)
    drift = torch.as_tensor(p["drift"], **f64)
    gains = torch.as_tensor(_harmonic_gains(p, rate), **f64)
    phases = torch.rand((len(p["len"]), HARMONICS), generator=gen,
                        **f64) * (2 * np.pi)
    out = torch.zeros(n, **f64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        seg = seg_of[lo:hi]
        t = torch.arange(lo, hi, **f64) - start[seg]
        env = amp[seg] * torch.sin(np.pi * (t + 0.5) / length[seg]) ** 2
        # the phase of a linear glide from f0 to f0 * (1 + drift)
        cycles = f0[seg] * (t + drift[seg] * t * t / (2 * length[seg])) / rate
        voiced = torch.zeros(hi - lo, **f64)
        for h in range(HARMONICS):
            voiced += gains[seg, h] * torch.sin(
                2 * np.pi * (h + 1) * cycles + phases[seg, h])
        noise = torch.randn(hi - lo + 1, generator=gen, **f64)
        hiss = (noise[1:] - noise[:-1]) * 0.5
        k = kind[seg]
        out[lo:hi] = env * torch.where(
            k == VOICED, voiced, torch.where(k == UNVOICED, hiss, 0.0))
    full = (1 << (bps - 1)) - 1
    out *= 0.5 * full / out.abs().max().clamp(min=1e-12)
    out += torch.randn(n, generator=gen, **f64) * (
        full * 10 ** (floor_dbfs / 20))
    pcm = torch.round(out).clamp(-full - 1, full).to(torch.int32)
    return pcm[None]
