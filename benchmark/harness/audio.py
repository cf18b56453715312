"""The traffic's signal: seeded music-like PCM, made on the device.

The synthesis is ``chip_smoke.music`` as of commit be3fb28 (decaying
chords of five harmonic partials, panned, over a low noise floor, scaled
to 0.7 of full scale), frozen here so that a change to the program's
scripts cannot change the yardstick.  The chords' parameters are drawn on
the host with the same ``numpy`` generator calls in the same order as
``chip_smoke.music``; the waves and the noise are computed on ``device``
in float64, the noise from a ``torch.Generator`` seeded from the same
seed.  Three deployment properties are applied on top: digital silence at
the head and tail of a track (``lead_s``, ``tail_s``) and ``wasted_bits``
low bits that are zero in every sample (a 16-bit master delivered in a
24-bit file has 8).
"""

from __future__ import annotations

import numpy as np

PARTIALS = 5
CHORD_NOTES = 3


def chord_params(seconds: float, rate: int, seed: int) -> dict:
    """The chords of ``chip_smoke.music(seconds, rate, _, seed)``: per
    segment its start, length and decay, and per (segment, note,
    partial) its frequency, amplitude, phase and pan, drawn in its
    order."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    starts, lens, decay, freq, amp, phase, pan = [], [], [], [], [], [], []
    pos = 0
    while pos < n:
        m = min(n - pos, int(rng.uniform(0.25, 1.0) * rate))
        starts.append(pos)
        lens.append(m)
        decay.append(rng.uniform(0.5, 6.0))
        f, a, ph, pn = [], [], [], []
        for _ in range(CHORD_NOTES):
            f0 = 55.0 * 2 ** (rng.integers(0, 48) / 12)
            p = rng.uniform(0.15, 0.85)
            for h in range(1, PARTIALS + 1):
                a.append(rng.uniform(0.05, 0.2) / h)
                ph.append(rng.uniform(0, 2 * np.pi))
                f.append(f0 * h)
                pn.append(p)
        freq.append(f)
        amp.append(a)
        phase.append(ph)
        pan.append(pn)
        pos += m
    return {"n": n, "start": np.array(starts), "len": np.array(lens),
            "decay": np.array(decay), "freq": np.array(freq),
            "amp": np.array(amp), "phase": np.array(phase),
            "pan": np.array(pan)}


def music(seconds: float, rate: int, bps: int, seed: int, device,
          lead_s: float = 0.0, tail_s: float = 0.0,
          wasted_bits: int = 0, chunk: int = 1 << 22):
    """A (channels=2, samples) int32 tensor on ``device``: the seeded
    track, made ``chunk`` samples at a time so that the temporaries stay
    small."""
    import torch

    p = chord_params(seconds, rate, seed)
    n = p["n"]
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    seg_of = torch.repeat_interleave(
        torch.arange(len(p["len"]), device=dev),
        torch.as_tensor(p["len"], device=dev))
    start = torch.as_tensor(p["start"], **f64)
    decay = torch.as_tensor(p["decay"], **f64)
    freq = torch.as_tensor(p["freq"], **f64)
    amp = torch.as_tensor(p["amp"], **f64)
    phase = torch.as_tensor(p["phase"], **f64)
    pan = torch.as_tensor(p["pan"], **f64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    out = torch.empty((2, n), **f64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        seg = seg_of[lo:hi]
        tt = (torch.arange(lo, hi, **f64) - start[seg]) / rate
        env = torch.exp(-tt * decay[seg])
        left = torch.zeros(hi - lo, **f64)
        right = torch.zeros(hi - lo, **f64)
        for k in range(freq.shape[1]):
            wave = amp[seg, k] * env * torch.sin(
                2 * np.pi * freq[seg, k] * tt + phase[seg, k])
            left += pan[seg, k] * wave
            right += (1 - pan[seg, k]) * wave
        out[0, lo:hi] = left
        out[1, lo:hi] = right
    out += torch.randn((2, n), generator=gen, **f64) * 0.001
    full = (1 << (bps - 1)) - 1
    out *= 0.7 * full / out.abs().max()
    pcm = torch.round(out).to(torch.int32)
    del out
    if wasted_bits:
        pcm = (pcm >> wasted_bits) << wasted_bits
    pcm[:, :int(lead_s * rate)] = 0
    if tail_s:
        pcm[:, n - int(tail_s * rate):] = 0
    return pcm
