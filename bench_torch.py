#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: PCM encode throughput at preset -8
on one NVIDIA GPU, with the port's decodes and host stages.

    python3 bench_torch.py [--device cuda|cpu]

The port's counterpart of ``bench.py``, the JAX package's benchmark
(which stays as it is): the same sections, output keys, defaults and
``FLAC_TPU_BENCH_*`` variables, run through ``flac_codec_tpu_torch`` on
``cuda:0``.  ``--device cpu`` runs every section on the CPU with the
kernels' plain versions (for tests, at small sizes); without a GPU and
without that flag the script exits 1 and prints no result.  The CUDA
kernels (``flac_codec_tpu_torch/csrc``) and the native host engine are
built from the checkout at start, on two threads.

Output contract (``bench.py``'s).  The headline JSON line comes first,
as soon as the encode step is measured::

    {"metric": "pcm_encode_mbps_preset8", "value": MB/s, "unit":
     "MB/s/chip", "vs_baseline": value / 1000, "device_step_ms": ...,
     "batch_frames": 256, "note": ..., "card": ..., "power_limit_w": ...}

Each later section re-emits the growing dict, and one final line, with
the same ``metric`` and ``value``, comes last.  ``card`` and
``power_limit_w`` are ``nvidia-smi --query-gpu=name,power.limit``'s
(None on the CPU).  The final line adds ``errors`` (section: "Type:
message" for each section that raised), ``skipped`` (section: reason,
for each section the deadline left no room for, or whose input a failed
section did not make), ``disabled`` (sections a ``FLAC_TPU_BENCH_*``
switch turned off), ``launches`` (each section's kernel launches,
``kernels.LAUNCHES``), ``captures`` (CUDA graphs each section captured),
``pool_mib`` (``graphs.POOL_BYTES``: the graph memory pools' total) and
``bench_seconds``.  The process exits 1 if any section raised, else 0.
A global deadline, ``FLAC_TPU_BENCH_DEADLINE`` seconds (default 1200)
from process start, skips a section that needs more time than is left;
a section still running 30 s past it is recorded as an error, the final
line is printed and the process exits 1.

Sections, keys and the kernels each launches (K1 ``splice_subframes``,
K2 ``pack_symbols``, K3 ``predict_lpc``, K4 ``parse_frame_bodies``, +
``autocorr_levinson``).  PCM MB count frames x block x channels x bytes
a sample.  Every time is the median of ``FLAC_TPU_BENCH_REPS`` (at least
3) windows; where ``bench.py`` kept the best, ``*_best`` is beside it.

- ``headline``: ``value``, ``device_step_ms``.  The plan step
  ``BatchEncoder`` runs for one batch: the replay of the CUDA graph it
  replays (``ops.encode_batch.plan_graph`` with the encoder's static
  arguments, on its stream; f32, ``pack_budget`` 18, frame-packed,
  ``FLAC_TPU_BENCH_BATCH`` frames).  ``FLAC_TPU_BENCH_CHAIN`` replays
  run back to back between two CUDA events, behind a device spin that
  covers the host's enqueue (``chip_smoke.device_ms``); each copies in
  one of several distinct device-resident batches, enough to span twice
  the L2 cache, and the copy counts in the time.  K1, K2.
- ``dispatch``: ``dispatch_chained_mbps``, ``dispatch_chained_step_ms``.
  The same step, each followed by ``torch.cuda.synchronize()``, half
  the chain (at least 4) a window, on the host clock.  K1, K2.
- ``f64``: ``pcm_encode_mbps_preset8_f64``, ``f64_step_ms``.  The
  headline's step in f64 analysis, half the chain (at least 8).  K1,
  K2, +.
- ``24bit``: ``pcm_encode_mbps_preset8_24bit``, ``24bit_step_ms``.  The
  headline's step on 24-bit samples (the signal shifted left by 8,
  ``pack_budget`` 26).  K1, K2.
- ``stream``: ``compression_ratio_preset8``.  ``FLAC_TPU_BENCH_DEC_SECONDS``
  (24) of ``make_audio(n, seed=3)`` encoded by ``BatchEncoder(analysis=
  "f64")`` (byte-identical to ``bench.py``'s stream, which its host
  encoder made), cached under ``flac_codec_tpu_torch/build/bench_cache/``.
  +, K1, K2.  The decode sections decode this stream.
- ``decode_device_step``: ``decode_device_step_mbps``.  The whole stream
  parsed as one batch by the native ``parse_frames_raw``, then
  reconstruct-graph replays (``parallel.batch_decode.reconstruct_graph``,
  mode and taps as ``BatchDecoder`` picks them), 32 (or the chain, if
  shorter) back to back between two CUDA events, the input rotated over
  copies spanning twice the L2 cache.  K3, or none where every
  subframe is FIXED.
- ``decode_host``: ``decode_host_mbps_per_core`` (8 runs) and
  ``decode_mbps_by_threads`` (6 runs each of 1, 2, 4, 8, 16 threads, up
  to twice the cores): the native ``decode_frames``.
- ``decode_pipeline``: ``decode_pipeline_mbps``.  The whole stream
  through ``BatchDecoder(batch_frames=FLAC_TPU_BENCH_DEC_BATCH)
  .read_batch_device()``, a device-side sum chained across batches, one
  synchronisation at the end; one warm run first.  K3.
- ``decode_pipeline_device_parse``: ``decode_pipeline_device_parse_mbps``.
  The same with ``device_parse=True``.  K4, K3.
- ``end_to_end``: ``end_to_end_mbps``.  ``FLAC_TPU_BENCH_SECONDS`` (15)
  of ``make_audio`` through ``BatchEncoder`` into a ``BytesIO``, after a
  warm-up of two batches.  K1, K2.
- ``assemble``: ``assemble_mbps_by_threads`` (residual-only plans) and
  ``assemble_packed_mbps_by_threads`` (frame-packed): one f32 plan of a
  batch in each mode, on the host, then the native assembler
  (``parallel.batch.assemble_frames``) over the thread sweep, 6 runs
  each.  K2, and K1 for the frame-packed plan.

``FLAC_TPU_BENCH_SCAN=0`` makes the headline the dispatch form (and
drops ``dispatch``); ``FLAC_TPU_BENCH_DISPATCH_FORM=0``,
``FLAC_TPU_BENCH_MODES=0`` (``f64``, ``24bit``), ``FLAC_TPU_BENCH_DECODE=0``
(the stream, the decodes and ``assemble``) and ``FLAC_TPU_BENCH_E2E=0``
turn sections off; ``FLAC_TPU_BENCH_ANALYSIS`` sets the headline's and
``end_to_end``'s analysis.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import io
import itertools
import json
import os
import statistics
import sys
import threading
import time
import traceback

_T0 = time.time()

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

METRIC = "pcm_encode_mbps_preset8"
BASELINE_MBPS = 1000.0  # >= 1 GB/s PCM per chip (BASELINE.json north_star)
CACHE_DIR = os.path.join(ROOT, "flac_codec_tpu_torch", "build",
                         "bench_cache")
THREADS = (1, 2, 4, 8, 16)

# every measured key, each a positive number or a dict of them
KEYS = ("value", "device_step_ms", "dispatch_chained_mbps",
        "dispatch_chained_step_ms", "pcm_encode_mbps_preset8_f64",
        "f64_step_ms", "pcm_encode_mbps_preset8_24bit", "24bit_step_ms",
        "compression_ratio_preset8", "decode_device_step_mbps",
        "decode_host_mbps_per_core", "decode_host_mbps_per_core_best",
        "decode_mbps_by_threads", "decode_mbps_by_threads_best",
        "decode_pipeline_mbps", "decode_pipeline_mbps_best",
        "decode_pipeline_device_parse_mbps",
        "decode_pipeline_device_parse_mbps_best", "end_to_end_mbps",
        "assemble_mbps_by_threads", "assemble_mbps_by_threads_best",
        "assemble_packed_mbps_by_threads",
        "assemble_packed_mbps_by_threads_best")


def emit(out: dict) -> None:
    print(json.dumps(out), flush=True)


@dataclasses.dataclass
class Config:
    """The sizes and switches of one run (``config`` reads them from
    ``bench.py``'s ``FLAC_TPU_BENCH_*`` variables)."""

    batch_frames: int = 256
    analysis: str = "f32"
    reps: int = 3
    chain: int = 48
    scan: bool = True
    dispatch_form: bool = True
    modes: bool = True
    decode: bool = True
    dec_seconds: float = 24.0
    dec_batch: int = 256
    e2e: bool = True
    seconds: float = 15.0
    # where the decode stream is cached; None builds it every run
    cache_dir: str | None = CACHE_DIR

    def __post_init__(self):
        self.reps = max(3, self.reps)  # a median of at least 3 runs


def config(env=os.environ) -> Config:
    def on(name):
        return env.get(f"FLAC_TPU_BENCH_{name}", "1") != "0"

    return Config(
        batch_frames=int(env.get("FLAC_TPU_BENCH_BATCH", "256")),
        analysis=env.get("FLAC_TPU_BENCH_ANALYSIS", "f32"),
        reps=int(env.get("FLAC_TPU_BENCH_REPS", "3")),
        chain=int(env.get("FLAC_TPU_BENCH_CHAIN", "48")),
        scan=on("SCAN"), dispatch_form=on("DISPATCH_FORM"),
        modes=on("MODES"), decode=on("DECODE"),
        dec_seconds=float(env.get("FLAC_TPU_BENCH_DEC_SECONDS", "24")),
        dec_batch=int(env.get("FLAC_TPU_BENCH_DEC_BATCH", "256")),
        e2e=on("E2E"),
        seconds=float(env.get("FLAC_TPU_BENCH_SECONDS", "15")))


def options():
    """Preset -8 (block 4096, LPC order 12, partition order 6)."""
    from flac_codec_tpu_torch.encode import Options

    return Options.best().no_seektable()


def make_audio(n_samples: int, seed: int = 0) -> np.ndarray:
    """Stereo 16-bit music-like signal: sine partials + correlated noise
    (``bench.py``'s, draw for draw)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64)
    base = (6000 * np.sin(t * 0.01) + 3000 * np.sin(t * 0.037)
            + 1500 * np.sin(t * 0.1102))
    noise = rng.normal(0, 300, n_samples)
    left = base + noise
    right = 0.8 * base + rng.normal(0, 300, n_samples)
    pcm = np.stack([left, right]).T.reshape(-1)
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int32)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def copies(dev, nbytes: int) -> int:
    """How many copies of an input a timed run rotates among: on the card
    enough to span twice its L2 cache (``chip_smoke.rotation``), so that
    every step reads its input from device memory; 2 on the CPU."""
    if dev.type != "cuda":
        return 2
    from chip_smoke import rotation

    return rotation(nbytes)


def shard_stream(dev):
    """The stream ``BatchEncoder`` and ``BatchDecoder`` run one device's
    batches on (None on the CPU)."""
    from flac_codec_tpu_torch.parallel.mesh import batch_mesh, shard_streams

    return shard_streams(batch_mesh([dev]))[0]


def encoder_plan(dev, frames: int, analysis: str, bps: int,
                 frame_pack: bool = True, pack_budget=None):
    """The plan ``BatchEncoder`` runs for a batch of ``frames`` whole
    stereo frames at preset -8: ``(kw, graph,
    stream)``, with ``kw`` the encoder's static arguments of
    ``encode_frames_plan`` and, on the card, the CUDA graph it replays
    (``plan_graph`` on its stream; captured here if no encoder has
    captured it yet) and that stream.  On the CPU graph and stream are
    None."""
    import torch

    from flac_codec_tpu_torch.ops.encode_batch import plan_graph
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    enc = BatchEncoder(io.BytesIO(), options(), 44100, bps, 2,
                       batch_frames=frames, analysis=analysis,
                       pack_budget=pack_budget, frame_pack=frame_pack,
                       device=dev)
    kw, stream = enc._plan_kw, shard_stream(dev)
    if stream is None:
        return kw, None, None
    graph = plan_graph((frames, 2, enc._block),
                       torch.int16 if bps <= 16 else torch.int32, stream,
                       **kw)
    return kw, graph, stream


def plan_step(dev, frames: int, analysis: str, bps: int,
              frame_pack: bool = True, pack_budget=None):
    """The plan step ``BatchEncoder`` runs for a batch of ``frames`` whole
    stereo frames (``encoder_plan``): on the card a replay of the CUDA
    graph it replays, on the CPU ``encode_frames_plan``.  Returns
    ``(step, stream)``; ``step(x)`` takes a (frames, 2, block) batch and
    returns the plan."""
    from flac_codec_tpu_torch.ops.encode_batch import encode_frames_plan

    kw, graph, stream = encoder_plan(dev, frames, analysis, bps, frame_pack,
                                     pack_budget)
    if graph is None:
        return (lambda x: encode_frames_plan(x, **kw)), None
    return graph.replay, stream


def window_ms(dev, stream, step, inputs, chain: int, reps: int) -> float:
    """Median milliseconds a step of ``step(x)`` over ``reps`` windows of
    ``chain`` steps, ``x`` rotating through ``inputs``.  On the card
    ``chip_smoke.device_ms`` on ``stream``: a device spin covers the
    host's enqueue, then the steps run back to back between two CUDA
    events.  On the CPU the host clock (``dispatch_ms``)."""
    if dev.type != "cuda":
        return dispatch_ms(dev, step, inputs, chain, reps)
    import torch

    from chip_smoke import device_ms

    with torch.cuda.stream(stream):
        return device_ms(lambda i: step(inputs[i]), len(inputs), n=chain,
                         runs=reps)


def dispatch_ms(dev, step, inputs, steps: int, reps: int) -> float:
    """Median milliseconds a step on the host clock, each step followed by
    a synchronisation, over ``reps`` windows of ``steps``, after one warm
    step."""
    turn = itertools.count()

    def call():
        step(inputs[next(turn) % len(inputs)])
        sync(dev)

    call()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(steps):
            call()
        out.append((time.perf_counter() - t) * 1e3 / steps)
    return statistics.median(out)


def encode_batches(frames: int, block: int, bps: int, n: int) -> list:
    """``n`` distinct (frames, 2, block) batches: batch i is ``bench.py``'s
    batch made with seed i, at 24 bits shifted left by 8."""
    out = []
    for seed in range(n):
        pcm = np.ascontiguousarray(make_audio(block * frames, seed).reshape(
            frames, block, 2).transpose(0, 2, 1))
        out.append(pcm.astype(np.int16) if bps == 16 else pcm << (bps - 16))
    return out


def device_step_mbps(dev, cfg: Config, analysis: str, chain: int,
                     bits_per_sample: int = 16, scan: bool = True,
                     frame_pack: bool = True, pack_budget=None,
                     inputs=None) -> tuple:
    """(MB/s of PCM, ms) of the median step of ``BatchEncoder``'s plan
    step (in the mode ``frame_pack`` and ``pack_budget`` choose, as for
    the encoder) on device-resident batches, ``inputs`` or else
    ``encode_batches``: ``window_ms`` with ``scan``, else
    ``dispatch_ms``."""
    import torch

    B, N = cfg.batch_frames, options().block_size
    step, stream = plan_step(dev, B, analysis, bits_per_sample, frame_pack,
                             pack_budget)
    width = 2 if bits_per_sample == 16 else 4  # the batch's dtype
    if inputs is None:
        inputs = [torch.from_numpy(p).to(dev) for p in encode_batches(
            B, N, bits_per_sample, copies(dev, B * 2 * N * width))]
    sync(dev)
    ms = (window_ms(dev, stream, step, inputs, chain, cfg.reps) if scan
          else dispatch_ms(dev, step, inputs, chain, cfg.reps))
    pcm_mb = B * N * 2 * (bits_per_sample // 8) / 1e6
    return pcm_mb / ms * 1e3, ms


def bench_stream(dev, seconds: float, cache_dir: str | None = None) -> bytes:
    """The preset -8 decode stream of ``bench.py``: ``seconds`` of
    ``make_audio(n, seed=3)`` (whole frames), here encoded by
    ``BatchEncoder(analysis="f64")`` on ``dev``, byte-identical to the
    host encoder that made ``bench.py``'s.  Cached in ``cache_dir``."""
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    path = (None if cache_dir is None else os.path.join(
        cache_dir, "bench_p8_%ds_seed3.flac" % int(seconds)))
    if path is not None and os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    opts = options()
    n = int(44100 * seconds)
    n -= n % opts.block_size
    buf = io.BytesIO()
    enc = BatchEncoder(buf, opts, 44100, 16, 2, total_samples=n,
                       batch_frames=256, analysis="f64", device=dev)
    enc.write(make_audio(n, seed=3))
    enc.finalize()
    data = buf.getvalue()
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return data


def stream_decoder(stream: bytes):
    """The port's host ``Decoder`` on ``stream``, past its metadata, and
    the stream's PCM MB."""
    from flac_codec_tpu_torch.decode import Decoder

    dec = Decoder(io.BytesIO(stream))
    si = dec.streaminfo
    return dec, (dec.total_samples * si.channels
                 * ((si.bits_per_sample + 7) // 8) / 1e6)


def rates(mb: float, secs: list) -> tuple:
    """(MB/s of the median run, MB/s of the best)."""
    return mb / statistics.median(secs), mb / min(secs)


def decode_device_step(dev, cfg: Config, stream: bytes) -> dict:
    """The device decode step (inverse predictors, wasted bits, stereo
    decorrelation) on the whole stream parsed as one batch, in the mode
    ``BatchDecoder`` picks for it."""
    import torch

    from flac_codec_tpu_torch import native
    from flac_codec_tpu_torch.ops.predict import fixed_compatible_mask
    from flac_codec_tpu_torch.ops.predict_pallas import tap_bucket
    from flac_codec_tpu_torch.parallel.batch_decode import (
        RECON_KEYS, _device_reconstruct, recon_len, recon_views,
        reconstruct_graph)

    dec, _ = stream_decoder(stream)
    si = dec.streaminfo
    C, N = si.channels, si.maximum_block_size
    raw = native.load().parse_frames_raw(
        dec.r.np_view(), dec.r.pos, -(-dec.total_samples // N),
        si.sample_rate, C, si.bits_per_sample, N, dec.total_samples)
    B = raw["n"]
    if B == 0 or raw["error"]:
        raise RuntimeError(f"parse_frames_raw: {B} frames, error "
                           f"{raw['error']}")
    # the mode and taps BatchDecoder picks for this batch
    fixed = fixed_compatible_mask(raw["qcoeffs"].reshape(B * C, 32),
                                  raw["shift"].reshape(B * C),
                                  raw["order"].reshape(B * C)).all()
    mode = "fixed" if fixed else "lpc"
    taps = 32 if fixed else tap_bucket(int(raw["order"].max()))
    blob = torch.empty(recon_len(B, C, N), dtype=torch.int32)
    for dst, k in zip(recon_views(blob, B, C, N), RECON_KEYS):
        dst.numpy()[...] = raw[k]
    inputs = [blob.to(dev) for _ in range(copies(dev, 4 * len(blob)))]
    sync(dev)
    stream_ = shard_stream(dev)
    if stream_ is None:
        def step(x):
            return _device_reconstruct(*recon_views(x, B, C, N), mode=mode,
                                       taps=taps)
    else:
        graph = reconstruct_graph(stream_, (B, C, N), mode, taps)

        def step(x):
            with torch.cuda.stream(stream_):
                graph.input.copy_(x, non_blocking=True)
            return graph.replay()

    ms = window_ms(dev, stream_, step, inputs, min(32, cfg.chain), cfg.reps)
    mb = B * C * N * ((si.bits_per_sample + 7) // 8) / 1e6
    return {"decode_device_step_mbps": mb / ms * 1e3,
            "decode_device_step_ms": ms, "decode_device_step_mode":
            f"{mode} taps {taps}, {B} frames"}


def thread_counts() -> list:
    """``bench.py``'s thread sweep: 1, 2, 4, 8, 16 up to twice the cores."""
    return [nt for nt in THREADS if nt <= max(2 * (os.cpu_count() or 1), 2)]


def decode_host(dev, cfg: Config, stream: bytes) -> dict:
    """The native host decode (``decode_frames``) of the whole stream,
    one thread and over the thread sweep."""
    from flac_codec_tpu_torch import native

    nat = native.load()
    dec, mb = stream_decoder(stream)
    si, n = dec.streaminfo, dec.total_samples
    view, start = dec.r.np_view(), dec.r.pos
    out = np.empty(n * si.channels, dtype=np.int32)  # reused across calls
    frames = -(-n // si.maximum_block_size)

    def run(nt: int, reps: int) -> tuple:
        secs = []
        for _ in range(reps):
            t = time.perf_counter()
            _, sizes, _, err = nat.decode_frames(
                view, start, frames, si.sample_rate, si.channels,
                si.bits_per_sample, si.maximum_block_size, n, nthreads=nt,
                out=out)
            secs.append(time.perf_counter() - t)
            if err or int(sizes.sum()) != n:
                raise RuntimeError(f"decode_frames({nt} threads): "
                                   f"{int(sizes.sum())} of {n} samples, "
                                   f"error {err}")
        return rates(mb, secs)

    per_core, per_core_best = run(1, 8)
    sweep = {str(nt): run(nt, 6) for nt in thread_counts()}
    return {"decode_host_mbps_per_core": per_core,
            "decode_host_mbps_per_core_best": per_core_best,
            "decode_mbps_by_threads": {k: v[0] for k, v in sweep.items()},
            "decode_mbps_by_threads_best": {k: v[1]
                                            for k, v in sweep.items()}}


def decode_pipeline(dev, cfg: Config, stream: bytes,
                    device_parse: bool) -> tuple:
    """(median, best) MB/s of the whole stream through ``BatchDecoder``'s
    ``read_batch_device``, PCM left on the device, one warm run first."""
    from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder

    _, mb = stream_decoder(stream)

    def run() -> float:
        with BatchDecoder(io.BytesIO(stream), cfg.dec_batch,
                          device_parse=device_parse, device=dev) as bd:
            acc, samples = None, 0
            t = time.perf_counter()
            while True:
                got = bd.read_batch_device()
                if got is None:
                    break
                s = got[0].sum()  # queued on the device; chained below
                acc = s if acc is None else acc + s
                samples += int(np.asarray(got[1]).sum())
            sync(dev)  # the one fence
            secs = time.perf_counter() - t
            if samples != bd.streaminfo.total_samples:
                raise RuntimeError(f"decoded {samples} of "
                                   f"{bd.streaminfo.total_samples} samples")
        return secs

    run()
    return rates(mb, [run() for _ in range(cfg.reps)])


def end_to_end(dev, cfg: Config) -> float:
    """Median MB/s of PCM of ``FLAC_TPU_BENCH_SECONDS`` of audio through
    ``BatchEncoder`` into a ``BytesIO``, after a warm-up at the same
    batch size."""
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    opts = options()
    n = int(44100 * cfg.seconds)
    n -= n % opts.block_size
    inter = make_audio(n)
    pcm_mb = inter.nbytes / 2 / 1e6

    def encode(x) -> float:
        buf = io.BytesIO()
        enc = BatchEncoder(buf, opts, 44100, 16, 2,
                           total_samples=len(x) // 2,
                           batch_frames=cfg.batch_frames,
                           analysis=cfg.analysis, device=dev)
        t = time.perf_counter()
        enc.write(x)
        enc.finalize()
        sync(dev)
        secs = time.perf_counter() - t
        if not buf.getvalue():
            raise RuntimeError("the encoder wrote nothing")
        return secs

    encode(inter[:opts.block_size * cfg.batch_frames * 2 * 2])
    return pcm_mb / statistics.median(
        [encode(inter) for _ in range(cfg.reps)])


def assemble_sweep(dev, cfg: Config) -> dict:
    """The native assembler over the thread sweep, on one f32 plan of a
    ``FLAC_TPU_BENCH_BATCH``-frame batch in each mode: residual-only
    ("splice", ``frame_pack=False``) and frame-packed."""
    import torch

    from flac_codec_tpu_torch import metadata
    from flac_codec_tpu_torch.convert import plan_to_numpy
    from flac_codec_tpu_torch.parallel.batch import assemble_frames

    opts = options()
    B, N = cfg.batch_frames, opts.block_size
    pcm = np.ascontiguousarray(
        make_audio(N * B).reshape(B, N, 2).transpose(0, 2, 1))
    si = metadata.Streaminfo(minimum_block_size=N, maximum_block_size=N,
                             sample_rate=44100, channels=2,
                             bits_per_sample=16, total_samples=B * N)
    mb = B * N * 4 / 1e6
    x = torch.from_numpy(pcm.astype(np.int16)).to(dev)
    out = {}
    for key, frame_pack in (("assemble_mbps_by_threads", False),
                            ("assemble_packed_mbps_by_threads", True)):
        step, _ = plan_step(dev, B, "f32", 16, frame_pack)
        plan = step(x)
        sync(dev)  # before reading the graph's static output
        plan = plan_to_numpy(plan)
        sweep = {}
        for nt in thread_counts():
            secs = []
            for _ in range(6):
                t = time.perf_counter()
                frames, _ = assemble_frames(plan, pcm, si, 0,
                                            fallback_options=opts,
                                            nthreads=nt)
                secs.append(time.perf_counter() - t)
            if not all(frames):
                raise RuntimeError(f"{key}: an empty frame")
            sweep[str(nt)] = rates(mb, secs)
        out[key] = {k: v[0] for k, v in sweep.items()}
        out[key + "_best"] = {k: v[1] for k, v in sweep.items()}
    return out


def headline(dev, cfg: Config, ctx: dict) -> dict:
    mbps, ms = device_step_mbps(dev, cfg, cfg.analysis, cfg.chain,
                                scan=cfg.scan)
    if dev.type != "cuda":
        how = (f"encode_frames_plan on the CPU ({cfg.analysis}), "
               f"{cfg.chain} calls a window on the host clock")
    elif cfg.scan:
        how = ("the plan-graph replay BatchEncoder runs for a batch "
               f"(planner and frame packer, {cfg.analysis}), {cfg.chain} "
               "back-to-back replays between two CUDA events behind a "
               "device spin")
    else:
        how = ("the plan-graph replay BatchEncoder runs for a batch "
               f"(planner and frame packer, {cfg.analysis}), {cfg.chain} "
               "replays, each followed by a synchronisation, on the host "
               "clock")
    return {"value": mbps, "vs_baseline": mbps / BASELINE_MBPS,
            "device_step_ms": ms,
            "note": (f"device encode step: {how}, each step copying in one "
                     "of several distinct device-resident batches (on the "
                     "card spanning twice its L2 cache); median of "
                     f"{cfg.reps} windows")}


def dispatch(dev, cfg, ctx):
    mbps, ms = device_step_mbps(dev, cfg, cfg.analysis,
                                max(4, cfg.chain // 2), scan=False)
    return {"dispatch_chained_mbps": mbps, "dispatch_chained_step_ms": ms}


def f64(dev, cfg, ctx):
    mbps, ms = device_step_mbps(dev, cfg, "f64", max(8, cfg.chain // 2))
    return {"pcm_encode_mbps_preset8_f64": mbps, "f64_step_ms": ms}


def bits24(dev, cfg, ctx):
    mbps, ms = device_step_mbps(dev, cfg, "f32", max(8, cfg.chain // 2),
                                bits_per_sample=24)
    return {"pcm_encode_mbps_preset8_24bit": mbps, "24bit_step_ms": ms}


def stream_section(dev, cfg, ctx):
    stream = bench_stream(dev, cfg.dec_seconds, cfg.cache_dir)
    _, mb = stream_decoder(stream)
    ctx["stream"] = stream
    return {"compression_ratio_preset8": round(len(stream) / (mb * 1e6), 4)}


def pipeline_host_parse(dev, cfg, ctx):
    med, best = decode_pipeline(dev, cfg, ctx["stream"], False)
    return {"decode_pipeline_mbps": med, "decode_pipeline_mbps_best": best}


def pipeline_device_parse(dev, cfg, ctx):
    med, best = decode_pipeline(dev, cfg, ctx["stream"], True)
    return {"decode_pipeline_device_parse_mbps": med,
            "decode_pipeline_device_parse_mbps_best": best}


def sections(cfg: Config) -> list:
    """(name, seconds it needs left, whether it decodes the stream, run)
    in order, ``bench.py``'s; run is None where a switch turned the
    section off.  Built at each call, from the module's functions."""
    dec = cfg.decode
    table = (
        ("headline", 0, False, headline, True),
        ("dispatch", 120, False, dispatch, cfg.dispatch_form and cfg.scan),
        ("f64", 420, False, f64, cfg.modes),
        ("24bit", 420, False, bits24, cfg.modes),
        ("stream", 90, False, stream_section, dec),
        ("decode_device_step", 120, True,
         lambda d, c, x: decode_device_step(d, c, x["stream"]), dec),
        ("decode_host", 30, True,
         lambda d, c, x: decode_host(d, c, x["stream"]), dec),
        ("decode_pipeline", 120, True, pipeline_host_parse, dec),
        ("decode_pipeline_device_parse", 120, True, pipeline_device_parse,
         dec),
        ("end_to_end", 150, False,
         lambda d, c, x: {"end_to_end_mbps": end_to_end(d, c)}, cfg.e2e),
        ("assemble", 90, False, lambda d, c, x: assemble_sweep(d, c), dec))
    return [(name, need, decodes, run if on else None)
            for name, need, decodes, run, on in table]


def card_keys(dev) -> dict:
    """``card`` and ``power_limit_w`` from ``nvidia-smi`` (None on the
    CPU)."""
    if dev.type != "cuda":
        return {"card": None, "power_limit_w": None}
    from chip_smoke import card

    name, limit = card().rsplit(",", 1)
    limit = limit.strip()
    try:
        limit = float(limit.removesuffix("W").strip())
    except ValueError:
        pass  # "[N/A]" and the like, kept as nvidia-smi gives it
    return {"card": name.strip(), "power_limit_w": limit}


def graph_count() -> int:
    """CUDA graphs captured in this process so far, plan and decode."""
    from flac_codec_tpu_torch.ops.encode_batch import PLAN_GRAPHS
    from flac_codec_tpu_torch.ops.framescan import PARSE_GRAPHS
    from flac_codec_tpu_torch.parallel.batch_decode import RECONSTRUCT_GRAPHS

    return len(PLAN_GRAPHS) + len(PARSE_GRAPHS) + len(RECONSTRUCT_GRAPHS)


def run(dev, cfg: Config, deadline: float, emit=emit, state=None,
        ctx=None) -> tuple:
    """Run every section on ``dev`` in order, emitting the headline line,
    the growing dict after each later section, and the final line.
    Returns (the final dict, exit code).  ``state`` (for a watchdog)
    gets the running section's name, the growing dict and the final
    line's bookkeeping; ``ctx`` the decode stream."""
    from flac_codec_tpu_torch import kernels

    state = {} if state is None else state
    ctx = {} if ctx is None else ctx
    out = {"metric": METRIC, "value": None, "unit": "MB/s/chip",
           "vs_baseline": None, "device_step_ms": None,
           "batch_frames": cfg.batch_frames, "note": None,
           **card_keys(dev)}
    book = {"errors": {}, "skipped": {}, "disabled": [], "launches": {},
            "captures": {}}
    state.update(out=out, book=book)
    for name, need, decodes, fn in sections(cfg):
        if fn is None:
            book["disabled"].append(name)
            continue
        left = deadline - time.time()
        if left < need:
            book["skipped"][name] = (f"deadline: {left:.1f} s left, the "
                                     f"section needs {need} s")
            continue
        if decodes and "stream" not in ctx:
            book["skipped"][name] = "no decode stream (section 'stream' " \
                                    "did not run)"
            continue
        state["section"] = name
        launches, captured = dict(kernels.LAUNCHES), graph_count()
        try:
            keys = fn(dev, cfg, ctx)
        except Exception as e:
            traceback.print_exc()
            book["errors"][name] = f"{type(e).__name__}: {e}"
            if name == "headline":
                break
            continue
        finally:
            book["launches"][name] = {
                k: n - launches[k] for k, n in kernels.LAUNCHES.items()
                if n != launches[k]}
            book["captures"][name] = graph_count() - captured
        out.update(keys)
        emit(out)
    state["section"] = None
    out = finish(out, book)
    emit(out)
    return out, 1 if book["errors"] else 0


def finish(out: dict, book: dict) -> dict:
    """The final line: ``out`` with the run's bookkeeping."""
    from flac_codec_tpu_torch import graphs

    return {**out, **book, "pool_mib": sum(graphs.POOL_BYTES.values())
            / 2**20, "bench_seconds": time.time() - _T0}


def build(dev) -> None:
    """Build the native engine, and on the card the CUDA kernels, from
    the checkout's sources, together."""
    from flac_codec_tpu_torch import kernels, native

    jobs = [native.load] + ([kernels.library] if dev.type == "cuda" else [])
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        for job in [ex.submit(j) for j in jobs]:
            job.result()


def watchdog(state: dict, deadline: float, done: threading.Event) -> None:
    """Print the final line and exit 1 if a section is still running 30 s
    past the deadline."""
    while not done.wait(5.0):
        if time.time() > deadline + 30 and state.get("section"):
            book = state["book"]
            book["errors"][state["section"]] = (
                "TimeoutError: still running 30 s past the deadline")
            emit(finish(state["out"], book))
            os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (cuda:0, the default) or cpu (the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch.py needs a CUDA GPU (--device cpu runs the "
              "port on the CPU)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    deadline = _T0 + float(os.environ.get("FLAC_TPU_BENCH_DEADLINE", "1200"))
    build(dev)
    state, done = {}, threading.Event()
    threading.Thread(target=watchdog, args=(state, deadline, done),
                     daemon=True).start()
    try:
        return run(dev, config(), deadline, state=state)[1]
    finally:
        done.set()


if __name__ == "__main__":
    sys.exit(main())
