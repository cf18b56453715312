"""The pool of seeded tracks that a cell's requests cycle through."""

from __future__ import annotations

import contextlib
import time

import numpy as np

from . import audio
from .pool import encode_reference


def track_seed(seed: int, index: int) -> int:
    """The seed of pool track ``index`` of a run seeded ``seed``."""
    seq = np.random.SeedSequence([int(seed) % (1 << 64), index])
    return int(seq.generate_state(1, np.uint64)[0])


def make(ctx, index: int):
    """Pool track ``index`` as a (channels, samples) int32 tensor on the
    run's device: the traffic's length and silences, the configuration's
    format and wasted bits (``track_wasted_bits``, cycled)."""
    cfg, traffic = ctx.cfg, ctx.traffic
    if cfg["channels"] != 2:
        raise ValueError("the track signal is stereo")
    wasted = cfg.get("track_wasted_bits", [0])
    pcm = audio.music(traffic["track_seconds"], cfg["sample_rate"],
                      cfg["bits_per_sample"], track_seed(ctx.seed, index),
                      ctx.device, lead_s=traffic["lead_silence_s"],
                      tail_s=traffic["tail_silence_s"],
                      wasted_bits=wasted[index % len(wasted)])
    ctx.log(f"pool track {index}: checksum {checksum(pcm)}")
    return pcm


def checksum(pcm) -> int:
    """An int64 checksum of a (channels, samples) tensor (the same seed
    must give the same samples)."""
    import torch

    x = pcm.to(torch.int64)
    w = torch.arange(x.shape[1], device=x.device) % 65521 + 1
    return int((x * w).sum())


def interleaved(pcm) -> np.ndarray:
    """A (channels, samples) tensor as interleaved int32 on the host."""
    return pcm.T.contiguous().cpu().numpy().reshape(-1)


def reference(ctx, pcm: np.ndarray) -> tuple:
    """The plain reference's stream and layout of the interleaved int32
    track ``pcm`` (``pool.encode_reference`` on the host's cores).  Its
    seconds are added to ``ctx.reference_s``, which the runner takes out
    of the set-up time."""
    t0 = time.perf_counter()
    got = encode_reference(pcm, ctx.cfg, ctx.workers)
    seconds = time.perf_counter() - t0
    ctx.reference_s += seconds
    ctx.log(f"reference stream made in {seconds:.3f} s by "
            f"{ctx.workers} workers")
    return got


def pcm_bytes(cfg: dict, samples: int) -> int:
    """Bytes of ``samples`` a channel of PCM: samples x channels x bytes
    a sample."""
    return samples * cfg["channels"] * ((cfg["bits_per_sample"] + 7) // 8)


def phase(name: str):
    """A profiler range around one phase of a request (a host range of
    the traced stretch; next to nothing when no profiler runs)."""
    try:
        import torch
    except ImportError:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
