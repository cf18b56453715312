"""Smoke run of flac_codec_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU (it exits
non-zero without one, and outside a checkout).  Phases:

1. device and environment: the card's name and power limit, torch and
   CUDA versions, the build of the CUDA kernels (``csrc/``, one ``nvcc``
   per source) and of the native host engine, started together;
2. the encode kernels against their plain versions on the card, at
   preset -8 shapes, bit for bit (K2 also on the symbol lists the frame
   packer hands it, header fields included, and on a column-permuted
   copy of them; the autocorrelation also at order 32; K1 also on
   panels whose set bits overlap and on negative and past-the-slot
   offsets, and timed at the 8-channel 24-bit block-16384 slot), with
   each kernel's device time alone (``device_ms``), the time a caller
   waits for one call (``cuda_ms``) and, as a cross-check, the kernel's
   own device time by ``torch.profiler``, beside its bounds (bytes,
   operations, and for the autocorrelation the shared memory its design
   moves at the SM clock sampled under load);
3. the encode path in f64: 120 s of seeded music-like stereo 16-bit
   44.1 kHz PCM, then 20 s of 24-bit 96 kHz, through the port's
   ``BatchEncoder`` at ``Options.best()``; each stream must be
   byte-identical to the port's host encoder ``FlacSampleWriter``;
4. the encode path in f32: the 120 s clip must decode losslessly (MD5);
5. every encode kernel must have launched during phases 3-4, and every
   batch of whole frames (the short last one padded) must have been a
   replay of a captured CUDA graph;
6. the decode kernel ``predict_lpc`` against its plain version, bit for
   bit: the raw subframes the port's native parser returns for the 120 s
   stream (preset -8 decode shapes), seeded random rows in every tap
   bucket, and rows at the int32 boundary (``INT32_EDGE_CASES``); the
   rows that took its int64 path must be exactly ``int64_rows`` (those
   that leave int32, here), and the boundary set must have some; median times in every set, the
   SM clock under load and the cycles a step;
7. the decode path: the three streams of phases 3-4 through the port's
   ``BatchDecoder(device="cuda")``; the PCM must equal the input exactly,
   ``predict_lpc`` must have launched, and every batch reconstructed on
   the device must have been one replay of a reconstruct graph;
8. every stream of ``tests/data/conformance/`` through
   ``BatchDecoder(device="cuda", batch_frames=4)``; its PCM must hash to
   the manifest's ``pcm_md5``, each device batch one replay, with the
   number of graphs captured and their seconds;
9. the frame-body parser ``parse_frame_bodies`` (K4) against its plain
   version, bit for bit and ``ok`` included: seeded small-block streams
   and conformance streams in every construct (constant, verbatim, FIXED,
   LPC to order 32, wasted bits, escaped and constant partitions, rice2,
   8 channels, 24 bits, left/right/mid-side), damaged copies of them,
   garbage bodies, and hand-built streams whose Rice partitions meet the
   edges of K4's 1024-bit windows (``window_edge_stream``); then against
   the native raw parse on the first 256-frame batch of the 120 s and
   24-bit streams, and on 200 of its lanes padded to 256 (``nbits`` 0)
   in a zero-filled byte buffer, as the decoder pads a batch; times;
10. the device-parse decode path: the three streams through
   ``BatchDecoder(device="cuda", device_parse=True)``; the PCM must equal
   the input, K4 and ``predict_lpc`` must have launched, no batch may
   fall back to the host parse but the one holding the short tail, and
   each device batch must have been one parse-graph and one
   reconstruct-graph replay;
11. the conformance corpus through the device-parse path (``pcm_md5``,
   replays as in phase 8);
12. a slot past one block's shared memory: 1 s of 8-channel 24-bit
   96 kHz at block 16384 (a 420 KB frame slot; its 5 frames padded to a
   256-frame batch) encoded on the card, f64
   byte-identical to ``FlacSampleWriter`` and decoded back losslessly
   through both parse paths (their 5 frames padded to a 64-frame
   bucket; each decode graph's memory printed); and K2 against its
   plain version on 60,000-word panels;
13. encode MB/s of PCM in f64 and f32, and decode MB/s of PCM with the
   host parse and with the device parse, with their stage times (median
   of 3, synchronised);
14. the residual-only (``frame_pack=False``) and plan-tree
   (``pack_budget=0``) encode paths, each counted: both clips in f64,
   byte-identical to the frame-packed streams of phase 3 (so to
   ``FlacSampleWriter``); the residual-only path must launch K2 and the
   autocorrelation and not K1, the plan-tree path the autocorrelation
   and neither K1 nor K2;
15. batch sharding: under ``batch_mesh()`` (every visible card) and
   ``batch_mesh([cuda:0, cuda:0])`` (two shards on two streams of one
   card), the 120 s clip encoded frame-packed and residual-only (bytes
   of phase 3, counted) and the three streams of phases 3-4 decoded with
   the host parse (PCM equal to the input on ``cuda:0``, K3 counted, a
   reconstruct replay per shard holding a real frame);
16. encode MB/s of PCM in each mode (frame-packed, residual-only, plan
   tree), f64, median of 3, with stage times;
17. CUDA graphs against ``graphs=False`` (eager planning) in each mode in
   f64 and frame-packed in f32, in turns: MB/s (median of 3) with stage
   times, the device ms of a batch (CUDA events around back-to-back
   replays, and around one eager call), and, by ``torch.profiler`` over
   one encode, the device's kernel and copy time and the host's CUDA
   API calls a batch;
18. decode with CUDA graphs against ``graphs=False``, both streams of
   phases 3-4 through both parse paths, in turns: MB/s (median of 3)
   with stage times, the device ms of a batch in each graph (CUDA events
   around back-to-back replays, and around one eager call), the
   profiler's kernel and copy time and host CUDA API calls a batch, and
   each graph's ``memory_reserved``;
19. the port's device fuzzer (``tools/fuzz_roundtrip_torch.py``,
   ``fuzz_device``) on the card, seed ``FUZZ_SEED``, ``FUZZ_TRIALS``
   trials: random stream lengths and signal classes through the f64
   ``BatchEncoder`` (bytes == ``FlacSampleWriter``) and ``BatchDecoder``
   with both parse paths; no trial may fail, and every kernel of the
   port must launch during it;
20. memory across a mixed library (``mixed_library``): five formats
   (``LIBRARY``: mono to 8 channels, 16 and 24 bits, blocks 4096 and
   16384), each in f64 (bytes == ``FlacSampleWriter``) and f32 (MD5) at
   256-frame batches and decoded through both parse paths, then the
   first format again (bytes == its first encode); ``memory_reserved``
   after each format, and its growth over the phase, which must stay
   within the largest single capture's pool (the 8-channel
   configuration captured alone on a fresh stream) plus 2 GiB, and its
   peak over the phase, which may pass that growth by at most 1 GiB;
21. a mesh with the device parse asked for: the 120 s 16-bit stream
   through ``BatchDecoder(mesh=[cuda:0, cuda:0], device_parse=True)``,
   which turns the device parse off as the JAX package does; the PCM
   must equal the unsharded device-parse decode's (and the input), K3
   must launch and K4 not, and every device batch must be a reconstruct
   replay per shard holding a real frame;
22. the JAX package's call shapes, each counted: the 120 s clip through
   the positional ``BatchEncoder(..., 256, None, "f64")`` on the default
   ``cuda`` (the bytes of phase 3; K1, K2 and the autocorrelation
   launched) and back through ``BatchDecoder(f, 256, None, True)`` (PCM
   == the input; K4 and K3 launched); ``wav2flac --tpu`` and ``flac2wav
   --tpu -j 4`` in process on a 16-bit and a 24-bit file (the host
   encoder's bytes; the input WAVs back); ``flac_codec_tpu_torch.
   FlacSampleWriter`` resolved; the native flavor that loaded (an
   x86-64-v3 host must load the v3 build unless ``FLAC_TPU_PORTABLE_SO``
   is set) and ``parse_frames_raw`` over the 120 s stream in both
   flavors, interleaved (median of 7, the same arrays);
23. the benchmark ``bench_torch.py`` run in process (``bench_torch.run``)
   at a chain of ``BENCH_CHAIN`` replays: every key finite and positive,
   no section failed, skipped or turned off, the headline line first and
   the last line with its value; the headline and f64 sections captured
   no graph (they replay those the encoders of phases 4 and 3 captured);
   ``kernels.LAUNCHES``, zeroed before the run, counted K1 and K2 in
   every encode section, the autocorrelation in the f64 section and the
   stream, K3 in the decode step and both pipelines and K4 in the
   device-parse pipeline; the 24 s decode stream, made by the f64
   ``BatchEncoder``, is the tracked ``.bench_cache/bench_p8_24s_seed3.
   flac`` byte for byte (so ``compression_ratio_preset8`` is 0.6676);
24. the encode-step profiler ``tools/profile_encode_torch.py`` in
   process (loaded from its file), f32 and f64, at a chain of
   ``PROFILE_CHAIN``: ``insitu`` (``unattributed``, the kernel time the
   profiler links to no launch, is at most ``UNATTRIBUTED_SHARE`` of the
   eager plan's; the plan's own range, which no finer stage range covers,
   holds at most ``PLAN_OWN_SHARE`` of its launches and of its kernel
   time; the eager plan's launches are within ``LAUNCH_SHARE`` of the
   replay's),
   ``stages`` (every stage graph's output equal to its eager output;
   ``kernels.LAUNCHES``, zeroed before, counted K1 and K2, and the
   autocorrelation in f64; the stage graphs' stream pool released) and
   ``ablate`` at 1 and 2 times 256 frames (every time positive); neither
   ``insitu`` nor ``stages`` captured a plan graph (they profile the
   graphs the encoders of phases 3-4 captured), and every attribute the
   stage ranges patch is the original again.

Every encoder and decoder here runs with CUDA graphs on (the default)
but those of phases 17 and 18 that ask for ``graphs=False``; every graph
of a stream warms up and captures inside that stream's one memory pool
(``graphs.stream_pool``); each graph's capture prints the growth of
``torch.cuda.memory_reserved()`` it left, its peak during the warm-up
and capture, and its stream's pool total,
phases 3-4, 12, 14 and 15 check that every encode batch was a replay,
and phases 7, 8, 10, 11, 12, 13, 15 and 21 that every decode batch was.
Every time is printed beside the card's ``nvidia-smi`` name and power
limit.  Any failed check raises.  The last lines are a JSON summary of
the kernels, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import hashlib
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SECONDS_16 = 120
SECONDS_24 = 20
BATCH_FRAMES = 256

# the least time the card could take (NVIDIA H100 SXM data sheet at
# 700 W): HBM bytes per second, and the float32 non-tensor-core rate,
# used for the integer and float64 work here too, which makes each
# bound a lower bound
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# K4 per 256-frame batch of the 120 s 16-bit stream in its earlier design
# (one thread per frame body), as PERF.md records it from another H100
K4_ONE_THREAD_MS = 1.5677


def bound(nbytes: float, ops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "operations_ms": t_ops * 1e3,
            "smem_ms": None}


# the H100's shared memory: 128 bytes a clock on each of its 132 SMs
SM_COUNT = 132
SMEM_BYTES_PER_CLOCK = 128


def smem_ms(nbytes: float, mhz: float) -> float:
    """The least time the card's shared memory takes to serve ``nbytes``
    at the SM clock ``mhz``: a kernel's second bound, set by its design."""
    return nbytes / (SM_COUNT * SMEM_BYTES_PER_CLOCK * mhz * 1e6) * 1e3


def music(seconds: float, rate: int, bps: int, seed: int) -> np.ndarray:
    """Seeded music-like stereo PCM, interleaved int32: decaying chords of
    harmonic partials, panned, over a low noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    out = np.zeros((2, n))
    pos = 0
    while pos < n:
        m = min(n - pos, int(rng.uniform(0.25, 1.0) * rate))
        tt = np.arange(m) / rate
        env = np.exp(-tt * rng.uniform(0.5, 6.0))
        for _ in range(3):
            f0 = 55.0 * 2 ** (rng.integers(0, 48) / 12)
            pan = rng.uniform(0.15, 0.85)
            for h in range(1, 6):
                wave = (rng.uniform(0.05, 0.2) / h) * env * np.sin(
                    2 * np.pi * f0 * h * tt + rng.uniform(0, 2 * np.pi))
                out[0, pos:pos + m] += pan * wave
                out[1, pos:pos + m] += (1 - pan) * wave
        pos += m
    out += rng.normal(0, 0.001, out.shape)
    full = (1 << (bps - 1)) - 1
    out *= 0.7 * full / np.abs(out).max()
    return np.round(out).astype(np.int32).T.reshape(-1)


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of one call of ``fn`` (CUDA events), after one
    warm-up call: what a caller waits for.  The device idles while the
    host runs the call's Python, so for a short kernel this is mostly
    host time; ``device_ms`` takes the host out."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the H100's L2 cache; a timed run's inputs span twice this
L2_BYTES = 50e6


def rotation(nbytes: int) -> int:
    """How many copies of a call's inputs (``nbytes`` read a call) a timed
    run rotates among, so that its working set is twice the L2 cache and
    every launch reads its inputs from device memory."""
    return max(2, -(-int(2 * L2_BYTES) // max(int(nbytes), 1)))


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """SM clock cycles a millisecond of ``torch.cuda._sleep``'s spin."""
    import torch

    cycles = 1 << 24
    torch.cuda._sleep(cycles // 8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, copies: int = 1, n: int = 20, runs: int = 5) -> float:
    """Median device milliseconds of one call of ``fn(i)``, i the input
    copy (0 <= i < copies, in turn, carried on from run to run), with the
    host taken out of the window.

    A device spin, twice as long as the host takes to enqueue the run,
    goes first; the start event, ``n`` calls and the end event queue up
    behind it, so the device runs the calls back to back.  A run whose
    enqueue outlasted its spin is thrown away and the spin doubled.  ``fn``
    must not synchronise, and a run must stay well inside the device's
    launch queue (a few hundred kernels on the H100): a host that waits
    for room in a full queue looks like one that synchronises."""
    import torch

    turn = itertools.count()

    def call():
        fn(next(turn) % copies)

    for _ in range(copies):
        call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        call()
    spin_ms = 2e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    times, late = [], 0
    while len(times) < runs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(n):
            call()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t)
        end.synchronize()
        if host_ms < spin_ms:
            times.append(start.elapsed_time(end) / n)
            continue
        # the host caught up with the spin: its enqueue entered the window
        late += 1
        if late > 3:
            raise AssertionError(
                f"device_ms: enqueueing {n} calls took {host_ms:.1f} ms, "
                f"longer than a {spin_ms:.1f} ms device spin, {late} times "
                "(does the call synchronise?)")
        spin_ms = 2 * host_ms
    return statistics.median(times)


def profiler_ms(fn, kernel: str, copies: int = 1, n: int = 10):
    """The mean device ms of each launch of the kernel whose name holds
    ``kernel``, by ``torch.profiler`` over ``n`` calls of ``fn(i)``; None
    where the profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i % copies)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            t = getattr(e, "device_time_total", None)
            total += t if t is not None else getattr(e, "cuda_time_total", 0)
            count += e.count
    return total / count / 1e3 if count and total > 0 else None


def kernel_times(fn, kernel: str, copies: int, plain, plain_copies=None,
                 plain_reps: int = 5) -> dict:
    """A kernel's ``kernel_ms`` (device alone, ``device_ms``), ``call_ms``
    (one call, ``cuda_ms``), ``profiler_ms`` (its own device time by
    ``torch.profiler``) and its plain version's ``plain_ms``: by
    ``device_ms`` over 5 calls (each launches dozens of small kernels)
    rotating among ``plain_copies`` copies, or, where the plain version
    goes through the host (``plain_copies`` None), by ``cuda_ms``."""
    if plain_copies is None:
        plain_ms = cuda_ms(lambda: plain(0), reps=plain_reps)
    else:
        plain_ms = device_ms(plain, plain_copies, n=5)
    return {"kernel_ms": device_ms(fn, copies),
            "call_ms": cuda_ms(lambda: fn(0)),
            "profiler_ms": profiler_ms(fn, kernel, copies),
            "plain_ms": plain_ms,
            "plain_timer": "cuda_ms" if plain_copies is None else "device_ms"}


def times_line(name: str, t: dict, b: dict) -> str:
    """One kernel's times, bounds and card, for the log."""
    prof = ("not measured" if t["profiler_ms"] is None
            else f"{t['profiler_ms']:.4f} ms")
    smem = ("" if b.get("smem_ms") is None
            else f", shared memory {b['smem_ms']:.4f} ms")
    return (f"{name}: kernel {t['kernel_ms']:.4f} ms (device alone), call "
            f"{t['call_ms']:.4f} ms, profiler {prof}, plain "
            f"{t['plain_ms']:.4f} ms ({t['plain_timer']}), bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
            f"{b['bytes_ms']:.4f} ms, operations {b['operations_ms']:.4f} ms"
            f"{smem}) on {card()}")


def max_abs_err(a, b) -> int:
    from flac_codec_tpu_torch.ops.common import i32_to_u32

    return int((i32_to_u32(a) - i32_to_u32(b)).abs().max())


def k2_lists(dev, pcm16: np.ndarray):
    """K2's inputs at preset -8 from the first 256-frame batch of
    ``pcm16``: the batch (B, 2, N) on ``dev``, the panel words P, and
    {label: (values, widths, ends, mask)}:

    * "framepack slot 0" / "slot 1": the lists the frame packer hands K2
      for each channel slot (residual section and header fields, M =
      4229), caught on their way into ``bitpack.pack_symbols``;
    * "residual-only slot 0": slot 0's list in the residual-only pack
      mode (``encode_batch._pack_plan_channels``: the residual section
      alone from panel bit 0, M = 4161, into panels of the same P);
    * "planner": slot 0's residual section alone, as
      ``bitpack.residual_symbols`` gives it (M = 4161);
    * "permuted": slot 0's framepack lists with their columns in one
      seeded random order;
    * "random": random disjoint symbols of 1-20 bits, 10 % masked off.
    """
    import torch

    from flac_codec_tpu_torch.encode import Options
    from flac_codec_tpu_torch.ops import bitpack, encode_batch, framepack
    from flac_codec_tpu_torch.ops.common import TYPE_FIXED, TYPE_LPC

    opts = Options.best()
    N, B = opts.block_size, BATCH_FRAMES
    budget = 16 + 2
    P = framepack.subframe_panel_words(N, budget)
    batch = torch.as_tensor(pcm16[:B * N * 2].reshape(B, N, 2)
                            .transpose(0, 2, 1).copy(), device=dev)
    plan = encode_batch.encode_frames_plan(
        batch, bits_per_sample=16, block_size=N,
        max_lpc_order=opts.max_lpc_order,
        max_partition_order=opts.max_partition_order, analysis="f64")
    caught = []
    pack = bitpack.pack_symbols

    def catch(*args):
        caught.append(args[:4])
        return pack(*args)

    bitpack.pack_symbols = catch
    try:
        framepack.pack_frame_bodies(plan, N, 16, budget)
        residual = encode_batch._pack_plan_channels(plan, N, budget)
    finally:
        bitpack.pack_symbols = pack
    if int(residual["packed_meta"][1]) != P:
        raise AssertionError("residual-only panels are not P words wide")
    lists = {"framepack slot 0": caught[0], "framepack slot 1": caught[1],
             "residual-only slot 0": caught[2]}
    ch = plan["channels"][0]
    typ = ch["sub_type"].long()
    lists["planner"], _ = bitpack.residual_symbols(
        ch["residuals"], ch["order"], ch["po"], ch["kinds"], ch["params"],
        ch["rice_bits"], N, torch.full((B,), 600, device=dev),
        budget * N, live=(typ == TYPE_FIXED) | (typ == TYPE_LPC))
    slot0 = lists["framepack slot 0"]
    M = slot0[0].shape[1]
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(7))
    lists["permuted"] = tuple(a[:, perm.to(dev)].contiguous() for a in slot0)
    gen = torch.Generator(device=dev).manual_seed(1)
    widths = torch.randint(1, 21, (B, M), device=dev, generator=gen,
                           dtype=torch.int32)
    ends = (torch.cumsum(widths, 1, dtype=torch.int32) + 3).to(torch.int32)
    values = (torch.randint(0, 1 << 20, (B, M), device=dev, generator=gen)
              & ((1 << widths.long()) - 1)).to(torch.int32)
    mask = torch.rand((B, M), device=dev, generator=gen) > 0.1
    lists["random"] = (values, widths, ends, mask)
    return batch, P, lists


def k2_bound(args, P: int) -> dict:
    """K2's bound on one list: values, widths, ends (int32) and mask (bool)
    read once, panels (int32) and overflow flags (bool) written once; ~6
    integer operations per live symbol."""
    rows, M = args[0].shape
    return bound(rows * M * 13 + rows * P * 4 + rows, int(args[3].sum()) * 6)


def k2_copies(args, copies: int):
    """``copies`` copies of one K2 list, each in memory of its own."""
    return [tuple(a.clone() for a in args) for _ in range(copies)]


def bit_equal(got, want) -> bool:
    """Tensors equal bit for bit; NaNs (orders past a zero error) may
    differ in payload."""
    import torch

    return all(torch.equal(g.isnan(), w.isnan())
               and torch.equal(g.nan_to_num().view(torch.int64),
                               w.nan_to_num().view(torch.int64))
               for g, w in zip(got, want))


def autocorr_rows(dev, batch):
    """The autocorrelation's rows at preset -8: the planner's 4 B
    decorrelation candidates of ``batch`` (B, 2, N) and 64 near-pure sines
    (the ill-conditioned case where any other summation order flips bits),
    Tukey-windowed: (4 B + 64, N) float64 on ``dev``."""
    import torch

    from flac_codec_tpu_torch.ops import decorrelate, lpc

    B, _, N = batch.shape
    t = np.arange(N)
    sines = np.stack([(1 << 21) * np.sin(t * f) + rng_noise
                      for f, rng_noise in zip(
                          np.linspace(0.003, 0.09, 64),
                          np.random.default_rng(3).integers(-99, 99, (64, N)))])
    rows = torch.cat([decorrelate.candidates(batch).reshape(4 * B, N)
                      .double(), torch.as_tensor(sines, device=dev)])
    return (rows * lpc.window_array(("tukey", 0.5), N, torch.float64,
                                    dev)).contiguous()


def autocorr_bound(R: int, N: int, M: int) -> dict:
    """The autocorrelation's bound: rows read once; autocorrelation,
    coefficients and errors written once; (M+1) lags of N multiply-adds,
    and ~2 M^2 Levinson flops a row."""
    return bound(R * N * 8 + R * (M + 1 + M * 32 + M) * 8,
                 R * ((M + 1) * N * 2 + 2 * M * M))


def autocorr_smem_bytes(R: int, N: int, M: int) -> int:
    """Shared-memory bytes csrc/autocorr_levinson.cu moves: each row
    written into its ring once, and at each of a row's N / 32 chain steps,
    each of its threads (8 a group of G lags) reads its y window (G + 4
    doubles, rounded up to pairs) and, past one group, its 4 x values."""
    groups, G = ((1, 13) if M + 1 <= 13 else (2, 14) if M + 1 <= 28
                 else (4, 10))
    per_step = ((G + 4) & ~1) + (4 if groups > 1 else 0)
    return R * N * 8 + R * (N // 32) * 8 * groups * per_step * 8


def k1_frames(dev, lens, P: int, seed: int):
    """K1 inputs: (B, S) panels of ``lens[b, s]`` random bits each (the
    rest of the panel zero) at their frame's cumulative bit offsets:
    (panels (B, S, P) int32, offsets (B, S) int32) on ``dev``."""
    import torch

    from flac_codec_tpu_torch.ops.common import u32_to_i32

    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S = lens.shape
    words = torch.randint(0, 1 << 32, (B, S, P), generator=gen, device=dev)
    keep = (torch.as_tensor(lens, device=dev)[:, :, None]
            - 32 * torch.arange(P, device=dev)).clamp(0, 32)
    words &= ((1 << keep) - 1) << (32 - keep)      # the top `keep` bits
    offs = np.concatenate([np.zeros((B, 1), np.int64),
                           np.cumsum(lens, 1)[:, :-1]], 1)
    return (u32_to_i32(words).contiguous(),
            torch.as_tensor(offs, dtype=torch.int32, device=dev))


def k1_junk(dev, B: int, S: int, P: int, W: int, seed: int):
    """K1 inputs the encoder never makes: random full panels (their set
    bits overlap wherever two meet, so the slot word is their wrapping
    sum) at offsets from 40 words before the slot to 5 words past it, a
    few pinned: word-aligned, a spill on the slot's last word, wholly
    before and wholly past the slot."""
    import torch

    from flac_codec_tpu_torch.ops.common import u32_to_i32

    gen = torch.Generator(device=dev).manual_seed(seed)
    words = torch.randint(0, 1 << 32, (B, S, P), generator=gen, device=dev)
    offs = torch.randint(-40 * 32, (W + 5) * 32, (B, S), generator=gen,
                         device=dev, dtype=torch.int32)
    offs[0, 0] = 0
    offs[0, -1] = 32 * 5
    offs[1 % B, 0] = (W - P - 1) * 32 + 17
    offs[2 % B, -1] = -(P + 1) * 32 - 3
    offs[3 % B, 0] = W * 32
    offs[-1, -1] = -70
    return u32_to_i32(words).contiguous(), offs


def k1_bound(offs, P: int, W: int) -> dict:
    """K1's bound on these offsets: the shifted panel words that land in
    the slot (word i of panel s at word off_s // 32 + i, 0 <= i <= P) read
    once, offsets read once, slots written once; two shifts and an add a
    word."""
    wo = offs.long() >> 5
    lo, hi = (-wo).clamp(0, P + 1), (W - wo).clamp(0, P + 1)
    words = int((hi - lo).clamp(min=0).sum())
    B, S = offs.shape
    return bound(words * 4 + B * S * 4 + B * W * 4, words * 3)


def check_kernels(dev, pcm16: np.ndarray):
    """Phase 2: K1, K2 and the autocorrelation against their plain
    versions at preset -8 (the autocorrelation also at order 32; K1 also
    on overlapping bits and junk offsets, and timed at the 8-channel
    24-bit block-16384 slot)."""
    import torch

    from flac_codec_tpu_torch.encode import Options
    from flac_codec_tpu_torch.ops import framepack, lpc, packpanel

    opts = Options.best()
    N, B, S = opts.block_size, BATCH_FRAMES, 2
    budget = 16 + 2
    W = framepack.frame_slot_words(S, N, budget)
    results = []

    # K2 on the frame packer's own lists from real audio, the residual-only
    # lists, a column-permuted copy, the planner's residual sections and
    # random disjoint lists
    batch, P, lists = k2_lists(dev, pcm16)
    err = 0
    for label, args in lists.items():
        got, ovf = packpanel.pack_symbols(*args, P)
        want, wovf = packpanel.pack_symbols_plain(*args, P)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e or ovf.dtype != torch.bool or not torch.equal(ovf, wovf):
            raise AssertionError(f"pack_symbols ({label}) disagrees with "
                                 f"its plain version: max_abs_err={e}")
        if label == "framepack slot 0":
            slot0 = got
        if label == "permuted" and not torch.equal(got, slot0):
            raise AssertionError("pack_symbols: the permuted list packs to "
                                 "other panels than framepack slot 0")
        err = max(err, e)
        rows, M = args[0].shape
        print(f"K2 pack_symbols {label}: rows={rows} M={M} P={P} bit-exact, "
              f"{int(ovf.sum())} overflow rows")
    for label in ("framepack slot 0", "residual-only slot 0", "planner",
                  "permuted"):
        args = lists[label]
        b2 = k2_bound(args, P)
        copies = k2_copies(args, rotation(b2["bound_ms"] * 1e-3
                                          * HBM_BYTES_PER_S))
        t2 = kernel_times(lambda i: packpanel.pack_symbols(*copies[i], P),
                          "pack_symbols", len(copies),
                          lambda i: packpanel.pack_symbols_plain(*copies[i],
                                                                 P),
                          plain_copies=len(copies))
        print(times_line(f"K2 pack_symbols ({label}, M="
                         f"{args[0].shape[1]}, {len(copies)} copies)",
                         t2, b2))
        if label == "framepack slot 0":
            k2 = dict(t2, **b2)
        del copies
    results.append({
        "name": "pack_symbols", "route": "cuda",
        "source": "flac_codec_tpu_torch/csrc/pack_symbols.cu",
        "replaces": "flac_codec_tpu/ops/packpanel.py:377",
        "max_abs_err": err, "ms": k2["kernel_ms"], **k2,
        "library_ms": None})

    # float64 autocorrelation + Levinson in the host's rounding, on the
    # planner's windowed candidate rows and on near-pure sines, at the
    # preset's order and at the largest
    windowed = autocorr_rows(dev, batch)
    R, M = windowed.shape[0], opts.max_lpc_order
    err = 0.0
    for m in (M, lpc.MAX_ORDER):
        got = lpc.autocorr_levinson(windowed, m)
        want = lpc.autocorr_levinson_plain(windowed, m)
        torch.cuda.synchronize()
        e = max(float((g - w).nan_to_num().abs().max())
                for g, w in zip(got, want))
        if not bit_equal(got, want):
            raise AssertionError(f"autocorr_levinson (M={m}) disagrees with "
                                 f"the host's numpy rounding: max_abs_err={e}")
        err = max(err, e)
        print(f"autocorr_levinson: rows={R} N={N} M={m} "
              "bit-exact with the host encoder's numpy")
    copies = [windowed.clone() for _ in range(rotation(R * N * 8))]
    t5 = kernel_times(lambda i: lpc.autocorr_levinson(copies[i], M),
                      "autocorr_levinson", len(copies),
                      lambda i: lpc.autocorr_levinson_plain(windowed, M),
                      plain_reps=3)
    mhz = sm_clock_under_load(lambda: lpc.autocorr_levinson(windowed, M),
                              t5["kernel_ms"])
    b5 = autocorr_bound(R, N, M)
    b5["smem_ms"] = smem_ms(autocorr_smem_bytes(R, N, M), mhz)
    print(times_line(f"autocorr_levinson (M={M}; plain: host numpy)", t5, b5)
          + f"; SM clock under load {mhz:.0f} MHz")
    m = lpc.MAX_ORDER
    t32 = device_ms(lambda i: lpc.autocorr_levinson(copies[i], m),
                    len(copies))
    b32 = autocorr_bound(R, N, m)
    print(f"autocorr_levinson (M={m}): kernel {t32:.4f} ms (device alone), "
          f"bound {b32['bound_ms']:.4f} ms ({b32['bound_by']}), shared "
          f"memory {smem_ms(autocorr_smem_bytes(R, N, m), mhz):.4f} ms at "
          f"{mhz:.0f} MHz on {card()}")
    del copies
    results.append({
        "name": "autocorr_levinson", "route": "cuda",
        "source": "flac_codec_tpu_torch/csrc/autocorr_levinson.cu",
        "replaces": "flac_codec_tpu/ops/lpc.py:35",
        "max_abs_err": err, "ms": t5["kernel_ms"], **t5, **b5,
        "library_ms": None})

    # K1 with random disjoint-bit panels: off % 32 == 0, spill words and
    # offsets near W - P included
    rng = np.random.default_rng(2)
    lens = rng.integers(1, P * 32, (B, S))
    lens[0, 0] = 32 * 100                      # off % 32 == 0
    lens[1, 0] = (W - P - 1) * 32 + 17         # next panel at W - P - 1
    lens[1, 1] = P * 32                        # ... full: spills into W - 1
    lens[2, 0] = (W - P - 1) * 32              # aligned, right at the edge
    lens[2, 1] = P * 32
    panels, offs = k1_frames(dev, lens, P, seed=1)
    got = packpanel.splice_subframes(panels, offs, W)
    want = packpanel.splice_subframes_plain(panels, offs, W)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"splice_subframes disagrees with its plain "
                             f"version: max_abs_err={err}")
    if int(got[1, W - 1]) == 0:
        raise AssertionError("splice_subframes: spill word not exercised")
    print(f"K1 splice_subframes: B={B} S={S} P={P} W={W} bit-exact")
    # overlapping set bits (they add), negative and past-the-slot offsets
    for s_ in (1, 2, 8):
        jp, jo = k1_junk(dev, B, s_, P, W, seed=s_)
        e = max_abs_err(packpanel.splice_subframes(jp, jo, W),
                        packpanel.splice_subframes_plain(jp, jo, W))
        if e:
            raise AssertionError(f"splice_subframes (S={s_}, overlapping "
                                 "bits, junk offsets) disagrees with its "
                                 f"plain version: max_abs_err={e}")
        del jp, jo
    print(f"K1 splice_subframes: overlapping set bits, negative and "
          f"past-the-slot offsets, S = 1, 2, 8 (B={B} P={P} W={W}) bit-exact")
    b1 = k1_bound(offs, P, W)
    copies = [(panels.clone(), offs.clone())
              for _ in range(rotation(B * S * (P + 1) * 4))]
    t1 = kernel_times(
        lambda i: packpanel.splice_subframes(*copies[i], W),
        "splice_kernel", len(copies),
        lambda i: packpanel.splice_subframes_plain(*copies[i], W),
        plain_copies=len(copies))
    del copies
    print(times_line("K1 splice_subframes", t1, b1))
    results.append({
        "name": "splice_subframes", "route": "cuda",
        "source": "flac_codec_tpu_torch/csrc/splice.cu",
        "replaces": "flac_codec_tpu/ops/packpanel.py:454",
        "max_abs_err": err, "ms": t1["kernel_ms"], **t1, **b1,
        "library_ms": None})

    # K1 at the 8-channel 24-bit block-16384 slot (420 KB), a full batch
    S8, N8 = 8, 16384
    P8 = framepack.subframe_panel_words(N8, 24 + 2)
    W8 = framepack.frame_slot_words(S8, N8, 24 + 2)
    lens8 = rng.integers(P8 * 8, P8 * 16, (B, S8))
    panels, offs = k1_frames(dev, lens8, P8, seed=8)
    e = max_abs_err(packpanel.splice_subframes(panels, offs, W8),
                    packpanel.splice_subframes_plain(panels, offs, W8))
    if e:
        raise AssertionError("splice_subframes (8 ch block 16384) disagrees "
                             f"with its plain version: max_abs_err={e}")
    b8 = k1_bound(offs, P8, W8)
    copies = [(panels.clone(), offs.clone())
              for _ in range(rotation(B * S8 * (P8 + 1) * 4))]
    t8 = kernel_times(
        lambda i: packpanel.splice_subframes(*copies[i], W8),
        "splice_kernel", len(copies),
        lambda i: packpanel.splice_subframes_plain(*copies[i], W8),
        plain_copies=len(copies))
    del copies, panels, offs
    print(times_line(f"K1 splice_subframes (8 ch 24-bit block {N8}: B={B} "
                     f"S={S8} P={P8} W={W8}, {W8 * 4} bytes a slot), "
                     "bit-exact", t8, b8))
    return results


def encode_port(inter, rate, bps, analysis, dev, **mode):
    """``inter`` through the port's BatchEncoder on ``dev`` (``mode``:
    ``frame_pack``, ``pack_budget`` or ``mesh``)."""
    import torch

    from flac_codec_tpu_torch.encode import Options
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    buf = io.BytesIO()
    enc = BatchEncoder(buf, Options.best(), rate, bps, 2,
                       total_samples=len(inter) // 2,
                       batch_frames=BATCH_FRAMES, analysis=analysis,
                       device=dev, **mode)
    enc.write(inter)
    enc.finalize()
    torch.cuda.synchronize()
    return buf.getvalue(), enc


def encode_host(inter, rate, bps):
    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options

    buf = io.BytesIO()
    enc = FlacSampleWriter(buf, Options.best(), rate, bps, 2,
                           total_samples=len(inter) // 2)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue(), enc


def check_identical(label, inter, rate, bps, root, dev):
    """Phase 3: port f64 bytes == host encoder bytes."""
    t0 = time.perf_counter()
    port, penc = encode_port(inter, rate, bps, "f64", dev)
    t1 = time.perf_counter()
    host, henc = encode_host(inter, rate, bps)
    t2 = time.perf_counter()
    print(f"{label}: port f64 {len(port)} bytes in {t1 - t0:.2f} s, host "
          f"{len(host)} bytes in {t2 - t1:.2f} s, {penc.device_frames} "
          f"device frames, {penc.fallback_frames} fallback frames")
    if port != host:
        first = next((i for i, (a, b) in enumerate(zip(port, host))
                      if a != b), min(len(port), len(host)))
        meta_len = len(host) - henc.encoder.frame_bytes_written
        frame = sum(1 for p in henc.encoder.seekpoints
                    if meta_len + p.byte_offset <= first) - 1
        out = os.path.join(root, "flac_codec_tpu_torch", "build",
                           "chip_smoke")
        os.makedirs(out, exist_ok=True)
        for name, data in (("port.flac", port), ("host.flac", host)):
            with open(os.path.join(out, f"{label}.{name}"), "wb") as f:
                f.write(data)
        raise AssertionError(f"{label}: port f64 stream differs from the "
                             f"host encoder's at byte {first} (frame "
                             f"~{frame}); streams saved to {out}")
    print(f"{label}: byte-identical to FlacSampleWriter")
    return port, penc


def lpc_rows(rng, orders, N, sample_bits=23):
    """Seeded rows for predict_lpc: bounded samples run through a forward
    predictor with coefficients scaled to a random shift in 0-15, so the
    residuals fit int32.  Returns int32 (x, q (R, 32), shift, order)."""
    R = len(orders)
    y = rng.integers(-(1 << sample_bits), 1 << sample_bits, (R, N))
    shift = rng.integers(0, 16, R)
    lim = np.minimum(2 << shift, (1 << 14) - 1)[:, None]
    q = rng.integers(-lim, lim + 1, (R, 32))
    q[np.arange(32)[None, :] >= np.asarray(orders)[:, None]] = 0
    acc = np.zeros((R, N), np.int64)
    for j in range(min(32, N - 1)):
        acc[:, j + 1:] += q[:, j:j + 1] * y[:, :N - 1 - j]
    x = np.where(np.arange(N)[None, :] >= np.asarray(orders)[:, None],
                 y - (acc >> shift[:, None]), y)
    return (x.astype(np.int32), q.astype(np.int32), shift.astype(np.int32),
            np.asarray(orders, np.int32))


# rows for predict_lpc at the int32 boundary: (name, order, taps most
# recent first, shift, trajectory).  A trajectory is a smooth int64 row
# (a triangle wave with seeded noise of +-3) that the predictor tracks,
# so the residuals fit int32 while the samples cross +-2^31.  "up"/"down"
# rows leave int32 mid-row and come back, more than once; "top"/"bottom"
# rows touch 2^31 - 1 or -2^31 exactly, and plateau there, without
# leaving; "late" leaves in the row's last 8 samples, "early" in its
# first chunk.
INT32_EDGE_CASES = (
    ("up, q=[1], shift 0", 1, [1], 0, "up"),
    ("down, q=[1], shift 0", 1, [1], 0, "down"),
    ("up, q=[2,-1], shift 0", 2, [2, -1], 0, "up"),
    ("down, q=[2,-1], shift 0", 2, [2, -1], 0, "down"),
    ("up, q=[2^14]*2, shift 15", 2, [1 << 14] * 2, 15, "up"),
    ("down, q=[2^10]*32, shift 15", 32, [1 << 10] * 32, 15, "down"),
    ("up, q=[2^12]*8, shift 15", 8, [1 << 12] * 8, 15, "up"),
    ("late, q=[1], shift 0", 1, [1], 0, "late"),
    ("early, q=[1], shift 0", 1, [1], 0, "early"),
    ("top, q=[1], shift 0", 1, [1], 0, "top"),
    ("bottom, q=[1], shift 0", 1, [1], 0, "bottom"),
    ("top, q=[2^12]*8, shift 15", 8, [1 << 12] * 8, 15, "top"),
    ("bottom, q=[2,-1], shift 0", 2, [2, -1], 0, "bottom"),
)


def int32_edge_rows(N: int, seed: int = 31):
    """The rows of INT32_EDGE_CASES at length N (>= 256): int32 (x, q (R,
    32), shift, order) and the int64 samples they decode to."""
    rng = np.random.default_rng(seed)
    top, bottom = (1 << 31) - 1, -(1 << 31)
    n = np.arange(N)
    period = max(N // 5, 96)
    # the wave starts after the warm-ups (orders up to 32), at its foot
    tri = np.abs((np.maximum(n - 40, 0) % period) - period // 2)
    ramp = 3000 * (period // 2 - tri) // (period // 2)  # 0 .. 3000
    xs, qs, shifts, orders, ys = [], [], [], [], []
    for _, order, taps, shift, kind in INT32_EDGE_CASES:
        noise = rng.integers(-3, 4, N)
        if kind in ("up", "down"):
            y = top - 1500 + ramp + noise        # crosses 2^31 and back
        elif kind == "late":
            y = top - 10 + np.maximum(n - (N - 12), 0) * 2
        elif kind == "early":
            y = top - 40 + n * 9
        else:
            y = np.minimum(top - 2000 + 2 * ramp + noise, top)
        if kind in ("down", "bottom"):
            y = (top + bottom) - y               # mirror: -2^31 - 1 + ...
            y = np.maximum(y, bottom) if kind == "bottom" else y
        y = y.astype(np.int64)
        q = np.zeros(32, np.int64)
        q[:order] = taps
        acc = np.zeros(N, np.int64)
        for j in range(order):
            acc[j + 1:] += q[j] * y[:N - 1 - j]
        x = np.where(n >= order, y - (acc >> shift), y)
        if x.min() < -(1 << 31) or x.max() > (1 << 31) - 1:
            raise AssertionError("int32_edge_rows: a residual leaves int32")
        xs.append(x)
        qs.append(q)
        shifts.append(shift)
        orders.append(order)
        ys.append(y)
    return (np.array(xs, np.int32), np.array(qs, np.int32),
            np.array(shifts, np.int32), np.array(orders, np.int32),
            np.array(ys, np.int64))


def sm_clock_under_load(fn, ms: float, seconds: float = 2.0) -> float:
    """The median SM clock (MHz) that nvidia-smi samples every 100 ms while
    ``fn`` (taking about ``ms``) runs back to back for ``seconds``."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            for _ in range(max(int(50 / ms), 1)):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    samples = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    if not samples:
        raise AssertionError("nvidia-smi gave no SM clock samples")
    return statistics.median(samples)


def check_predict(dev, stream16: bytes):
    """Phase 6: predict_lpc against predict_batch_plain, bit for bit, on
    the 120 s stream's parsed subframes and on seeded random rows."""
    import torch

    from flac_codec_tpu_torch import native
    from flac_codec_tpu_torch.decode import Decoder
    from flac_codec_tpu_torch.ops.predict import predict_batch_plain
    from flac_codec_tpu_torch.ops.predict_pallas import (TAP_BUCKETS,
                                                         int64_rows,
                                                         predict_lpc,
                                                         tap_bucket)

    dec = Decoder(io.BytesIO(stream16))
    si = dec.streaminfo
    raw = native.load().parse_frames_raw(
        dec.r.np_view(), dec.r.pos, BATCH_FRAMES, si.sample_rate,
        si.channels, si.bits_per_sample, si.maximum_block_size, None)
    n, C, N = raw["buf"].shape
    if n != BATCH_FRAMES:
        raise AssertionError(f"native parser returned {n} frames, not "
                             f"{BATCH_FRAMES}")
    real = [torch.as_tensor(a, device=dev).reshape(n * C, -1)
            .to(torch.int32).contiguous()
            for a in (raw["buf"], raw["qcoeffs"])]
    real += [torch.as_tensor(raw[k].reshape(-1).astype(np.int32),
                             device=dev) for k in ("shift", "order")]
    taps = tap_bucket(int(raw["order"].max()))
    sets = [("120 s stream", real, taps)]
    rng = np.random.default_rng(6)
    for t in TAP_BUCKETS:
        orders = rng.integers(1, t + 1, 2 * BATCH_FRAMES)
        orders[:2] = [0, t]
        sets.append((f"random taps={t}",
                     [torch.as_tensor(a, device=dev)
                      for a in lpc_rows(rng, orders, N)], t))
    # the int32 boundary: INT32_EDGE_CASES among seeded rows, 512 in all
    edge = int32_edge_rows(N)[:4]
    rows = lpc_rows(rng, rng.integers(1, 33, n * C - len(edge[0])), N)
    sets.append(("int32 edge", [torch.as_tensor(np.concatenate([a, b]),
                                                device=dev)
                                for a, b in zip(edge, rows)], 32))
    err, slow_by_set = 0, {}
    for label, args, t in sets:
        slow = torch.zeros(1, dtype=torch.int32, device=dev)
        got = predict_lpc(*args, t, slow_rows=slow)
        want = predict_batch_plain(*args, t)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        if e or not torch.equal(got, want):
            raise AssertionError(f"predict_lpc ({label}) disagrees with its "
                                 f"plain version: max_abs_err={e}")
        slow_want = int(int64_rows(want, args[1], args[2], t).sum())
        if int(slow) != slow_want:
            raise AssertionError(f"predict_lpc ({label}): {int(slow)} rows "
                                 f"took the int64 path, not {slow_want}")
        slow_by_set[label] = slow_want
        err = max(err, e)
        print(f"K3 predict_lpc {label}: R={args[0].shape[0]} N={N} taps={t} "
              f"bit-exact, {slow_want} rows took the int64 path")
    if slow_by_set["int32 edge"] == 0:
        raise AssertionError("predict_lpc: no row of the int32 edge set took "
                             "the int64 path")
    R = n * C
    order = raw["order"].reshape(-1).astype(np.int64)
    # residuals, taps, shift and order read once, int64 samples written
    # once; one multiply and one add per tap of each predicted sample
    b3 = bound(R * N * 4 + R * 32 * 4 + R * 8 + R * N * 8,
               int((np.maximum(N - order, 0) * order * 2).sum()))
    copies = [[a.clone() for a in real]
              for _ in range(rotation(R * N * 4 + R * 32 * 4 + R * 8))]
    t3 = kernel_times(lambda i: predict_lpc(*copies[i], taps), "predict_lpc",
                      len(copies),
                      lambda i: predict_batch_plain(*real, taps),
                      plain_reps=3)
    del copies
    ms = t3["kernel_ms"]
    mhz = sm_clock_under_load(lambda: predict_lpc(*real, taps), ms)
    print(times_line(f"K3 predict_lpc (R={R} N={N} taps={taps}; plain: "
                     "host loop)", t3, b3)
          + f"; SM clock under load {mhz:.0f} MHz, "
          f"{ms * 1e-3 * mhz * 1e6 / N:.1f} cycles a step")
    for label, args, t in sets[1:]:
        copies = [[a.clone() for a in args]
                  for _ in range(rotation(args[0].numel() * 4))]
        tms = device_ms(lambda i: predict_lpc(*copies[i], t), len(copies))
        del copies
        print(f"K3 predict_lpc {label}: kernel {tms:.4f} ms (device alone), "
              f"{tms * 1e-3 * mhz * 1e6 / N:.1f} cycles a step (R="
              f"{args[0].shape[0]} N={N}) on {card()}")
    return {"name": "predict_lpc", "route": "cuda",
            "source": "flac_codec_tpu_torch/csrc/predict_lpc.cu",
            "replaces": "flac_codec_tpu/ops/predict_pallas.py:99",
            "max_abs_err": err, "ms": ms, **t3, **b3, "library_ms": None}


def parse_inputs(data: bytes, dev, frames=BATCH_FRAMES, whole=True):
    """The native scan of a stream's first ``frames`` frames as the
    arguments of parse_frame_bodies on ``dev``, and the native raw parse
    of the same frames (``whole``: it must parse every frame the scan
    found)."""
    import torch

    from flac_codec_tpu_torch import native
    from flac_codec_tpu_torch.decode import Decoder

    dec = Decoder(io.BytesIO(data))
    si = dec.streaminfo
    view = dec.r.np_view()
    nat = native.load()
    args = (view, dec.r.pos, frames, si.sample_rate, si.channels,
            si.bits_per_sample, si.maximum_block_size, dec.total_samples)
    scan, raw = nat.scan_frames(*args), nat.parse_frames_raw(*args)
    if scan["n"] == 0 or (whole and scan["n"] != raw["n"]):
        raise AssertionError(f"native scan found {scan['n']} frames, the "
                             f"raw parse {raw['n']}")
    t = [torch.as_tensor(view.copy()),
         torch.as_tensor(scan["body_off"].astype(np.int64)),
         torch.as_tensor(scan["body_bytes"].astype(np.int32) * 8),
         torch.as_tensor(scan["assignment"].astype(np.int32))]
    return ([x.to(dev) for x in t] + [si.maximum_block_size, si.channels,
                                      si.bits_per_sample], raw)


def k4_vs_plain(label, args) -> dict:
    """K4 and its plain version on the same inputs: every output equal."""
    import torch

    from flac_codec_tpu_torch.ops.framescan import (
        parse_frame_bodies, parse_frame_bodies_plain)

    got = parse_frame_bodies(*args)
    want = parse_frame_bodies_plain(*args)
    torch.cuda.synchronize()
    for key, w in want.items():
        if got[key].dtype != w.dtype or not torch.equal(got[key], w):
            err = int((got[key].long() - w.long()).abs().max())
            raise AssertionError(f"parse_frame_bodies ({label}) disagrees "
                                 f"with its plain version on {key}: "
                                 f"max_abs_err={err}")
    return got


def small_streams():
    """Seeded small-block streams through the port's host encoder: (label,
    bytes).  Between them: LPC to order 32, FIXED, constant and verbatim
    subframes, the stereo decorrelations, wasted bits, rice2, 8 channels,
    24 bits."""
    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options

    rng = np.random.default_rng(9)
    out = []
    for label, bps, ch, block, opts, shift in (
            ("16-bit stereo, block 256", 16, 2, 256, Options.best(), 0),
            ("24-bit stereo, block 576", 24, 2, 576, Options.best(), 0),
            ("20-bit 8 ch, wasted 2, block 192", 20, 8, 192,
             Options.best(), 2),
            ("16-bit mono FIXED, block 1152", 16, 1, 1152, Options.fast(),
             0),
            ("16-bit stereo, order 32, block 512", 16, 2, 512,
             Options.best().with_max_lpc_order(32), 0)):
        n = block * 12
        t = np.arange(n)
        amp = 1 << (bps - 3 - shift)
        x = np.stack([amp * np.sin(t * (0.01 + 0.004 * c))
                      * (np.arange(n) // block % 4 != 1)   # silent frames
                      + rng.integers(-99, 99, n) * (c % 3 != 2)
                      for c in range(ch)]).T
        full = 1 << (bps - 1 - shift)
        x[(np.arange(n) // block) % 4 == 3] = rng.integers(
            -full, full, (n // 4, ch))                     # verbatim frames
        if ch == 2:
            x[(np.arange(n) // block) % 6 == 5, 1] = x[
                (np.arange(n) // block) % 6 == 5, 0]       # equal channels
        inter = (x.reshape(-1).astype(np.int32) << shift)
        buf = io.BytesIO()
        enc = FlacSampleWriter(buf, opts.with_block_size(block), 48000, bps,
                               ch, total_samples=n)
        enc.write(inter)
        enc.finalize()
        out.append((label, buf.getvalue()))
    return out


# hand-built streams whose Rice partitions meet the edges of K4's 1024-bit
# windows (see window_edge_stream)
WINDOW_EDGE_CASES = ("order-0 partition", "codes ending on window edges",
                     "unary runs past a window", "k = 0", "rice2 k 29 and 30",
                     "rice2 quotient past 2^30 >> k",
                     "escape between Rice partitions",
                     "body ends inside a code")


def window_edge_stream(name: str):
    """One of WINDOW_EDGE_CASES as (bytes, cut, ok): a stream of hand-built
    frames, ``cut`` maps a frame to the body length in bits to give the
    parser in place of the scan's (a body that ends inside a code), ``ok``
    whether each frame's body parses.  The window edges are reckoned from
    byte 0 of the stream: where the parse's data starts when it is handed
    the whole stream, as ``parse_inputs`` does.

    * order-0 partition: block 4096, one partition of 4094 codes a
      channel, ~40 windows;
    * codes ending on window edges: 64 partitions a channel in turn end
      exactly on their first window's edge, have a code straddling it,
      have a code in their middle end on it, or are random;
    * unary runs past a window: codes with 1,000-5,000 zeros, first, in
      the middle and last in their partitions;
    * k = 0: partitions of 128 one-bit codes, 32 to a word, and of short
      codes;
    * rice2 k 29 and 30: quotients up to 2^30 >> k;
    * rice2 quotient past 2^30 >> k: two frames, not ok;
    * escape between Rice partitions: escaped partitions of widths 9, 0 and
      17 between Rice partitions;
    * body ends inside a code: its length cut to the middle of a code
      inside a window; not ok.
    """
    from flac_codec_tpu_torch.bitio import BitWriter
    from flac_codec_tpu_torch.crc import crc16
    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
    from flac_codec_tpu_torch.format.frame import FrameHeader

    rng = np.random.default_rng(100 + WINDOW_EDGE_CASES.index(name))
    window = 1024

    def stream(bodies, block, bps):
        """Frames of two independent channels around the bodies; a body
        writes its subframes into w, ``at()`` is the stream bit w writes
        next, and it may return a stream bit at which to cut the body."""
        n = block * len(bodies)
        buf = io.BytesIO()
        enc = FlacSampleWriter(buf, Options.best().with_block_size(block),
                               48000, bps, 2, total_samples=n)
        enc.write(np.zeros(2 * n, np.int32))
        enc.finalize()
        head = buf.getvalue()
        out = bytearray(head[:len(head) - enc.encoder.frame_bytes_written])
        cut = {}
        for i, body in enumerate(bodies):
            w = BitWriter()
            FrameHeader(False, block, 48000, 1, bps, i).write(w)
            start, header = len(out) * 8, w.bit_count
            mark = body(w, lambda: start + w.bit_count)
            if mark is not None:
                cut[i] = mark - start - header
            w.byte_align()
            frame = w.getvalue()
            out += frame + crc16(frame).to_bytes(2, "big")
        return bytes(out), cut

    def fixed(w, bps, method, po):
        """FIXED order 2, seeded warm-ups, the residual section's head."""
        w.write(10 << 1, 8)
        for _ in range(2):
            w.write_signed(int(rng.integers(-999, 999)), bps)
        w.write(method, 2)
        w.write(po, 4)

    def codes(w, k, qs):
        for q in qs:
            w.write_unary(int(q))
            w.write(int(rng.integers(0, 1 << k)), k)

    def short(m, p=0.35):
        return list(rng.geometric(p, m) - 1)

    def to_edge(at, m, k, back=0):
        """Quotients of m codes from stream bit ``at`` that end ``back``
        bits before the edge of the window holding ``at``."""
        extra = at // 32 * 32 + window - back - at - m * (k + 1)
        return list(rng.multinomial(extra, [1 / m] * m))

    def order0(w, at):
        for _ in range(2):
            fixed(w, 16, 0, 0)
            w.write(7, 4)
            codes(w, 7, short(4094))

    def edges(w, at):
        k = 8
        for _ in range(2):
            fixed(w, 16, 0, 6)
            for p in range(64):
                m = 62 if p == 0 else 64
                w.write(k, 4)
                if p % 4 == 0:        # the last code ends on the edge
                    qs = to_edge(at(), m, k)
                elif p % 4 == 1:      # a code straddles it
                    qs = to_edge(at(), m - 20, k, 3) + [40] + short(19)
                elif p % 4 == 2:      # a code in the middle ends on it
                    qs = to_edge(at(), m - 10, k) + short(10)
                else:
                    qs = short(m)
                codes(w, k, qs)

    def long_unary(w, at):
        # sample index -> quotient: the first code of a partition, codes
        # in the middle of two, and the last code of one
        for runs in ({2: 4000, 300: 1500, 600: 1000}, {1023: 5000}):
            fixed(w, 16, 0, 2)
            for p in range(4):
                w.write(2, 4)
                first = max(256 * p, 2)
                qs = short(256 * (p + 1) - first)
                for j, q in runs.items():
                    if first <= j < 256 * (p + 1):
                        qs[j - first] = q
                codes(w, 2, qs)

    def k0(w, at):
        for c in range(2):
            fixed(w, 16, 0, 3)
            for p in range(8):
                w.write(0, 4)
                m = 126 if p == 0 else 128
                codes(w, 0, [0] * m if (p + c) % 3 == 0
                      else short(m, 0.6))

    def rice2(bad=None):
        """k 29 and 30 in turn, a quotient at 2^30 >> k in each partition,
        and one past it in partition ``bad`` (channel, partition)."""
        def body(w, at):
            for c in range(2):
                fixed(w, 24, 1, 2)
                for p in range(4):
                    k = 29 + (p + c) % 2
                    qmax = (1 << 30) >> k
                    qs = list(rng.integers(0, qmax + 1, 62 if p == 0 else 64))
                    qs[p] = qmax
                    if (c, p) == bad:
                        qs[7] = qmax + 1
                    w.write(k, 5)
                    codes(w, k, qs)
        return body

    def escapes(w, at):
        for _ in range(2):
            fixed(w, 16, 0, 3)
            for p, (kind, x) in enumerate((("r", 6), ("e", 9), ("r", 5),
                                           ("e", 0), ("r", 7), ("e", 17),
                                           ("r", 4), ("r", 9))):
                m = 510 if p == 0 else 512
                if kind == "r":
                    w.write(x, 4)
                    codes(w, x, short(m))
                else:
                    w.write(15, 4)
                    w.write(x, 5)
                    for v in (rng.integers(-(1 << x >> 1), 1 << x >> 1, m)
                              if x else ()):
                        w.write_signed(int(v), x)

    def cut_inside(w, at):
        mark = None
        for c in range(2):
            fixed(w, 16, 0, 2)
            for p in range(4):
                w.write(8, 4)
                for j, q in enumerate(short(254 if p == 0 else 256)):
                    if (c, p, j) == (0, 1, 20):
                        mark = at() + 3
                    codes(w, 8, [q])
        return mark

    # name: block size, bits per sample, each frame's body
    block, bps, bodies = {
        "order-0 partition": (4096, 16, [order0]),
        "codes ending on window edges": (4096, 16, [edges]),
        "unary runs past a window": (1024, 16, [long_unary]),
        "k = 0": (1024, 16, [k0]),
        "rice2 k 29 and 30": (256, 24, [rice2(), rice2()]),
        "rice2 quotient past 2^30 >> k": (256, 24, [rice2((0, 1)),   # k 30
                                                    rice2((1, 1))]),  # k 29
        "escape between Rice partitions": (4096, 16, [escapes]),
        "body ends inside a code": (1024, 16, [cut_inside])}[name]
    data, cut = stream(bodies, block, bps)
    ok = [not (name.startswith("rice2 quotient") or i in cut)
          for i in range(len(bodies))]
    return data, cut, ok


def window_edge_inputs(name: str, dev):
    """window_edge_stream(name) as the arguments of parse_frame_bodies on
    ``dev`` (its cut bodies cut), the native raw parse, and ``ok``."""
    data, cut, ok = window_edge_stream(name)
    args, raw = parse_inputs(data, dev, whole=False)
    for i, n in cut.items():
        args[2][i] = n
    return args, raw, ok


def same_as_native(got: dict, raw: dict, frames: int) -> bool:
    """The first ``frames`` frames of a parse equal the native raw parse,
    array for array."""
    return all(np.array_equal(got[k][:frames].cpu().numpy(),
                              raw[k][:frames].astype(np.int32))
               for k in ("buf", "order", "shift", "wasted", "qcoeffs"))


def parses_as_built(got: dict, raw: dict, ok: list) -> bool:
    """A parse of window_edge_inputs: ``ok`` as built, and the frames
    before the first that is not ok equal to the native raw parse."""
    n = ok.index(False) if False in ok else len(ok)
    return (got["ok"].tolist() == ok and raw["n"] >= n
            and same_as_native(got, raw, n))


def check_parse(dev, root, data16: bytes, data24: bytes) -> dict:
    """Phase 9: K4 against its plain version, then against the native raw
    parse at full width; median times."""
    import torch

    from flac_codec_tpu_torch.ops.framescan import (
        byte_capacity, parse_frame_bodies, parse_frame_bodies_plain)

    t0 = time.perf_counter()
    corpus = os.path.join(root, "tests", "data", "conformance")
    sets = small_streams() + [
        (name, open(os.path.join(corpus, name + ".flac"), "rb").read())
        for name in ("constant-subframes", "partition-escape",
                     "partition-constant", "mixed-subframe-types",
                     "decorrelate-left-side", "decorrelate-side-right",
                     "decorrelate-mid-side", "wasted-side-channel",
                     "eight-channels", "lpc-order-32", "rice2-24bit")]
    rng = np.random.default_rng(10)
    lanes, not_ok = 0, 0
    for label, data in sets:
        args, _ = parse_inputs(data, dev)
        got = k4_vs_plain(label, args)
        if not bool(got["ok"].all()):
            raise AssertionError(f"parse_frame_bodies ({label}): a body of a "
                                 "valid stream is not ok")
        # damaged copies: flipped bits in the bodies, one cut body
        d = args[0].clone()
        flips = torch.as_tensor(rng.integers(0, d.shape[0], 24), device=dev)
        d[flips] ^= torch.as_tensor(1 << rng.integers(0, 8, 24),
                                    dtype=torch.uint8, device=dev)
        nbits = args[2].clone()
        nbits[0] -= 1
        bad = k4_vs_plain(label + " damaged", [d, args[1], nbits, *args[3:]])
        lanes += 2 * got["ok"].shape[0]
        not_ok += int((~bad["ok"]).sum())
    L, B = 20000, 256
    garbage = [torch.as_tensor(rng.integers(0, 256, L), dtype=torch.uint8),
               torch.as_tensor(rng.integers(-8, L, B), dtype=torch.int64),
               torch.as_tensor(rng.integers(-8, 8000, B), dtype=torch.int32),
               torch.as_tensor(rng.integers(0, 11, B), dtype=torch.int32)]
    bad = k4_vs_plain("garbage", [x.to(dev) for x in garbage] + [64, 2, 16])
    not_ok += int((~bad["ok"]).sum())
    # Rice partitions at the edges of K4's windows: bit-exact with the
    # plain version, and with the native raw parse on the bodies that parse
    edge_bodies = 0
    for name in WINDOW_EDGE_CASES:
        args, raw, ok = window_edge_inputs(name, dev)
        got = k4_vs_plain(name, args)
        if not parses_as_built(got, raw, ok):
            raise AssertionError(f"parse_frame_bodies ({name}): ok "
                                 f"{got['ok'].tolist()}, want {ok}, or the "
                                 "bodies that parse differ from the native "
                                 "raw parse")
        edge_bodies += len(ok)
        not_ok += ok.count(False)
    print(f"K4 parse_frame_bodies: {len(sets)} streams, their damaged copies, "
          f"{B} garbage bodies and {len(WINDOW_EDGE_CASES)} window-edge "
          f"streams bit-exact with the plain version, ok included "
          f"({lanes + B + edge_bodies} bodies, {not_ok} not ok) in "
          f"{time.perf_counter() - t0:.1f} s")

    full = {}
    for label, data in (("120 s 16-bit", data16), ("20 s 24-bit", data24)):
        args, raw = full[label] = parse_inputs(data, dev)
        got = parse_frame_bodies(*args)
        if not (bool(got["ok"].all()) and same_as_native(got, raw, raw["n"])):
            raise AssertionError(f"parse_frame_bodies ({label}) disagrees "
                                 "with the native raw parse")
        print(f"K4 parse_frame_bodies {label}: first {raw['n']} frames equal "
              "to the native raw parse, array for array")
    args, raw = full["120 s 16-bit"]
    got = k4_vs_plain("120 s 16-bit", args)
    B, C, N = got["buf"].shape
    # the decoder's padded batch: 200 real lanes in 256 (the padding with
    # nbits 0), the bytes from the first body zero up to the capacity
    n = 200
    data, off, nbits, assign = args[:4]
    lo = int(off[0])
    hi = int(off[n - 1]) + int(nbits[n - 1]) // 8
    padded = [torch.zeros(byte_capacity(hi - lo), dtype=torch.uint8,
                          device=dev)] + [torch.zeros_like(a)
                                          for a in (off, nbits, assign)]
    padded[0][:hi - lo] = data[lo:hi]
    for dst, src in zip(padded[1:], (off - lo, nbits, assign)):
        dst[:n] = src[:n]
    pad = k4_vs_plain("120 s 16-bit, 200 lanes padded to 256",
                      padded + list(args[4:]))
    if not (bool(pad["ok"][:n].all()) and not bool(pad["ok"][n:].any())
            and all(torch.equal(pad[k][:n], got[k][:n]) for k in got)
            and not any(bool(pad[k][n:].any()) for k in got)):
        raise AssertionError("parse_frame_bodies: padded lanes or a zero "
                             "byte tail changed a real lane")
    print(f"K4 parse_frame_bodies: {n} lanes padded to {B} (nbits 0) in a "
          f"{padded[0].shape[0]}-byte zero-filled buffer bit-exact with the "
          "plain version; the real lanes as unpadded, the padding zero")
    # body bytes (and offsets, lengths, assignments) read once; samples,
    # parameters and ok written once; ~10 operations per decoded symbol
    # (each sample, warm-up and LPC coefficient)
    body = int(args[2].sum()) // 8
    b4 = bound(body + B * 16 + B * C * N * 4 + B * C * 35 * 4 + B,
               10 * (B * C * N + int(raw["order"].astype(np.int64).sum())))
    copies = [[args[0].clone(), *args[1:]] for _ in range(rotation(body))]
    t4 = kernel_times(lambda i: parse_frame_bodies(*copies[i]),
                      "parse_frames", len(copies),
                      lambda i: parse_frame_bodies_plain(*args), plain_reps=1)
    del copies
    print(times_line(f"K4 parse_frame_bodies (B={B} C={C} N={N}, {body} body "
                     "bytes; plain: host loop)", t4, b4)
          + f"; the earlier one-thread-per-body design: {K4_ONE_THREAD_MS} "
          "ms (recorded on another machine)")
    return {"name": "parse_frame_bodies", "route": "cuda",
            "source": "flac_codec_tpu_torch/csrc/parse_frames.cu",
            "replaces": "flac_codec_tpu/ops/framescan.py:117",
            "max_abs_err": 0, "ms": t4["kernel_ms"], **t4, **b4,
            "library_ms": None}


def check_slot_repair(dev) -> None:
    """Phase 12: a frame slot past one block's shared memory, end to end, and
    K2 past it against its plain version."""
    import torch

    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
    from flac_codec_tpu_torch.ops import framepack, packpanel
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    rate, bps, ch, block = 96000, 24, 8, 16384
    rng = np.random.default_rng(12)
    t = np.arange(rate)
    inter = np.stack([(1 << 20) * np.sin(t * (0.01 + 0.003 * c))
                      + rng.integers(-999, 1000, rate) for c in range(ch)]
                     ).T.reshape(-1).astype(np.int32)
    opts = Options.best().with_block_size(block)
    W = framepack.frame_slot_words(ch, block, bps + 2)
    streams = []
    before = graph_replays()
    for cls, kw in ((FlacSampleWriter, {}),
                    (BatchEncoder, dict(batch_frames=BATCH_FRAMES,
                                        analysis="f64", device=dev))):
        buf = io.BytesIO()
        enc = cls(buf, opts, rate, bps, ch, total_samples=rate, **kw)
        enc.write(inter)
        enc.finalize()
        streams.append(buf.getvalue())
    if streams[0] != streams[1]:
        raise AssertionError("8-channel 24-bit block-16384 stream differs "
                             "from the host encoder's")
    check_replays("8 ch 24-bit block 16384 encode", before,
                  batch_replays(rate // block))
    for device_parse in (False, True):
        before = set(decode_graphs())
        pcm, dec = decode_port(streams[1], dev, device_parse=device_parse)
        if not np.array_equal(pcm.cpu().numpy().reshape(-1), inter):
            raise AssertionError("8-channel 24-bit block-16384 stream does "
                                 f"not decode losslessly (device_parse="
                                 f"{device_parse})")
        report_captures("8 ch 24-bit block 16384 decode (device_parse="
                        f"{device_parse}, {dec.device_frames} frames)",
                        before)
    print(f"slot past shared memory: 8 ch 24-bit block {block}, K1 slot "
          f"{W} words ({W * 4} bytes), f64 byte-identical to "
          f"FlacSampleWriter ({len(streams[1])} bytes, "
          f"{enc.device_frames} device frames), lossless through both "
          "parse paths")
    gen = torch.Generator(device=dev).manual_seed(12)
    rows, M, P = 4, 380000, 60000
    widths = torch.randint(1, 10, (rows, M), generator=gen, device=dev,
                           dtype=torch.int32)
    ends = (torch.cumsum(widths, 1) + 7).to(torch.int32)
    values = (torch.randint(0, 1 << 9, (rows, M), generator=gen, device=dev)
              & ((1 << widths.long()) - 1)).to(torch.int32)
    mask = torch.rand((rows, M), generator=gen, device=dev) > 0.05
    got, ovf = packpanel.pack_symbols(values, widths, ends, mask, P)
    want, wovf = packpanel.pack_symbols_plain(values, widths, ends, mask, P)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(ovf, wovf)):
        raise AssertionError("pack_symbols past shared memory disagrees "
                             "with its plain version")
    print(f"K2 pack_symbols past shared memory: rows={rows} M={M} P={P} "
          f"({P * 4} bytes) bit-exact, {int(ovf.sum())} overflow rows")


def decode_graphs() -> dict:
    """Every decode graph of the process, by ("parse" or "reconstruct",
    *its key)."""
    from flac_codec_tpu_torch.ops.framescan import PARSE_GRAPHS
    from flac_codec_tpu_torch.parallel.batch_decode import RECONSTRUCT_GRAPHS

    out = {("parse",) + k: g for k, g in PARSE_GRAPHS.items()}
    out.update({("reconstruct",) + k: g
                for k, g in RECONSTRUCT_GRAPHS.items()})
    return out


def decode_replays() -> tuple:
    """(parse, reconstruct) graph replays so far, summed."""
    total = {"parse": 0, "reconstruct": 0}
    for key, g in decode_graphs().items():
        total[key[0]] += g.replays
    return total["parse"], total["reconstruct"]


def decode_graph_name(key) -> str:
    """A decode graph's key, short."""
    if key[0] == "parse":
        _, device, stream, frames, cap, block, ch, bps = key
        return (f"parse {device} stream {stream:#x} {frames} lanes, {cap} "
                f"bytes, block {block}, {ch} ch {bps}-bit")
    _, device, stream, shape, mode, taps = key
    return (f"reconstruct {device} stream {stream:#x} {tuple(shape)} "
            f"{mode} taps {taps}")


def pool_totals(graph=None) -> str:
    """Each stream's memory pool total (``graphs.POOL_BYTES``: the growth
    of ``memory_reserved`` the stream's captures left since its first),
    in MiB, or only ``graph``'s stream's; "not kept" for a checkout whose
    graphs have private pools."""
    from flac_codec_tpu_torch import graphs

    totals = getattr(graphs, "POOL_BYTES", None)
    if totals is None:
        return "not kept"
    if graph is not None:
        key = (graph.stream.device, graph.stream.cuda_stream)
        return f"{totals[key] / 2**20:.1f} MiB"
    return ", ".join(f"{d} stream {s:#x} {b / 2**20:.1f} MiB"
                     for (d, s), b in totals.items()) or "none"


def capture_memory(graph) -> str:
    """A graph's ``reserved_bytes`` (the growth of ``memory_reserved`` its
    warm-up and capture left), its ``peak_bytes`` (their peak above the
    reserve before them; "not kept" for a checkout without it) and its
    stream's pool total, in MiB."""
    peak = getattr(graph, "peak_bytes", None)
    peak = "not kept" if peak is None else f"+{peak / 2**20:.1f} MiB"
    return (f"+{graph.reserved_bytes / 2**20:.1f} MiB (peak {peak}; its "
            f"stream's pool {pool_totals(graph)})")


def report_captures(label: str, before) -> list:
    """Print each decode graph captured since ``before`` (a set of
    ``decode_graphs()`` keys) with the growth of ``memory_reserved`` its
    warm-up and capture left and their peak, and its seconds, then their
    count and totals; returns the new graphs."""
    new = [(k, g) for k, g in decode_graphs().items() if k not in before]
    for key, g in new:
        tally = {k: v for k, v in g.tally.items() if v}
        print(f"  captured {decode_graph_name(key)}: memory_reserved "
              f"{capture_memory(g)}, warm-up and capture "
              f"{g.capture_seconds:.3f} s, launches a replay {tally}")
    print(f"{label}: {len(new)} decode graphs captured, "
          f"{sum(g.capture_seconds for _, g in new):.2f} s of warm-up and "
          f"capture, memory_reserved +"
          f"{sum(g.reserved_bytes for _, g in new) / 2**20:.1f} MiB; pools "
          f"{pool_totals()}")
    return new


def padded_shards(n: int, batch_frames: int, shards: int) -> int:
    """Shards of an n-frame batch, padded to its frame bucket (the JAX
    decoder's rule) and cut into ``shards``, that hold a real frame."""
    bucket = batch_frames
    while bucket // 2 >= n and bucket > 64:
        bucket //= 2
    sizes = [len(c) for c in np.array_split(np.arange(bucket), shards)]
    firsts = np.cumsum([0] + sizes[:-1])
    return sum(1 for f, size in zip(firsts, sizes) if size and f < n)


def decode_port(data: bytes, dev, batch_frames=BATCH_FRAMES,
                device_parse=False, mesh=None, graphs=True, stats=None):
    """Decode ``data`` on the card batch by batch.  With graphs, each
    batch reconstructed on the device must have been one replay of a
    reconstruct graph per shard holding a real frame, and, when the
    device parsed it, one parse-graph replay; a batch the host decoded
    (a tail) none.  ``stats`` gets the device batches and replays
    added."""
    import torch

    from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder

    shards = 1 if mesh is None else len(mesh)
    parts = []
    with BatchDecoder(io.BytesIO(data), batch_frames=batch_frames,
                      device=dev, device_parse=device_parse, mesh=mesh,
                      graphs=graphs) as dec:
        while True:
            frames, fallbacks = dec.device_frames, dec.parse_fallbacks
            parse0, recon0 = decode_replays()
            flat = dec.read_batch_interleaved()
            if flat is None:
                break
            parts.append(flat)
            n = dec.device_frames - frames
            fell_back = dec.parse_fallbacks != fallbacks
            parse, recon = decode_replays()
            parse, recon = parse - parse0, recon - recon0
            want = padded_shards(n, batch_frames, shards) if n else 0
            want_parse = (1 if n and dec._device_parse and not fell_back
                          else parse if fell_back else 0)
            if not graphs:
                want = want_parse = 0
            if (recon, parse) != (want, want_parse) or parse > 1:
                raise AssertionError(
                    f"a batch of {n} device frames (device_parse="
                    f"{device_parse}, fallback {fell_back}) made {recon} "
                    f"reconstruct and {parse} parse replays, want {want} "
                    f"and {want_parse}")
            if stats is not None and n:
                stats["batches"] = stats.get("batches", 0) + 1
                stats["reconstruct"] = stats.get("reconstruct", 0) + recon
                stats["parse"] = stats.get("parse", 0) + parse
        pcm = torch.cat(parts) if parts else torch.zeros(
            (0, dec.streaminfo.channels), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
    return pcm, dec


def check_corpus(root, dev, device_parse=False):
    """Phases 8 and 11: every conformance stream decodes on the card to
    its manifest's pcm_md5, every device batch a graph replay."""
    from flac_codec_tpu_torch import kernels

    corpus = os.path.join(root, "tests", "data", "conformance")
    with open(os.path.join(corpus, "manifest.json")) as f:
        manifest = json.load(f)
    n0 = dict(kernels.LAUNCHES)
    before = set(decode_graphs())
    frames, stats = [0, 0], {}
    for name in sorted(manifest):
        with open(os.path.join(corpus, name), "rb") as f:
            data = f.read()
        pcm, dec = decode_port(data, dev, batch_frames=4,
                               device_parse=device_parse, stats=stats)
        flat = pcm.cpu().numpy().reshape(-1).astype("<i8")
        rec = manifest[name]
        if (pcm.device.type != "cuda" or len(flat) != rec["total_samples"]
                or hashlib.md5(flat.tobytes()).hexdigest()
                != rec["pcm_md5"]):
            raise AssertionError(f"conformance stream {name} decoded on the "
                                 "card does not match its pcm_md5")
        frames[0] += dec.device_frames
        frames[1] += dec.host_frames
    launches = {k: kernels.LAUNCHES[k] - n0[k]
                for k in ("predict_lpc", "parse_frame_bodies")}
    print(f"conformance corpus (device_parse={device_parse}): "
          f"{len(manifest)} streams match pcm_md5 on the card; {frames[0]} "
          f"device frames, {frames[1]} host frames, launches {launches}; "
          f"{stats.get('batches', 0)} device batches, each one replay: "
          f"{stats.get('reconstruct', 0)} reconstruct and "
          f"{stats.get('parse', 0)} parse replays")
    report_captures(f"conformance corpus (device_parse={device_parse})",
                    before)


# the encode modes beside the default frame-packed one: BatchEncoder
# arguments, the kernels each path must launch and those it must not
ENCODE_MODES = {
    "residual-only": (dict(frame_pack=False),
                      ("pack_symbols", "autocorr_levinson"),
                      ("splice_subframes",)),
    "plan tree": (dict(pack_budget=0), ("autocorr_levinson",),
                  ("pack_symbols", "splice_subframes")),
}


def check_launches(label: str, launches: dict, want=(), never=()) -> None:
    """Raise unless every kernel in ``want`` launched and none in
    ``never`` did."""
    for name in want:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    for name in never:
        if launches[name] != 0:
            raise AssertionError(f"{label}: kernel {name} was launched "
                                 f"{launches[name]} times")


def check_encode_modes(dev, clips) -> None:
    """Phase 14: the residual-only and plan-tree encode paths, each
    counted, byte-identical to the frame-packed streams."""
    from flac_codec_tpu_torch import kernels

    for mode, (kw, want, never) in ENCODE_MODES.items():
        kernels.reset_launches()
        fallback = 0
        before = graph_replays()
        for label, inter, rate, bps, data in clips:
            got, enc = encode_port(inter, rate, bps, "f64", dev, **kw)
            if got != data:
                raise AssertionError(f"{label} ({mode}): bytes differ from "
                                     "the frame-packed stream")
            fallback += enc.fallback_frames
            print(f"{label} ({mode}): byte-identical to FlacSampleWriter, "
                  f"{enc.device_frames} device frames, "
                  f"{enc.fallback_frames} fallback frames")
        launches = dict(kernels.LAUNCHES)
        print(f"{mode} encode-path launches: {launches}; fallback frames: "
              f"{fallback}")
        check_launches(f"{mode} encode path", launches, want, never)
        check_replays(f"{mode} encode path", before, sum(
            batch_replays(len(c[1]) // 2 // 4096) for c in clips))


def check_mesh(dev, pcm16, data16, streams) -> None:
    """Phase 15: the 120 s clip encoded and the three streams decoded
    under a mesh of every visible card and under cuda:0 listed twice."""
    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.parallel.mesh import batch_mesh

    for mesh in (batch_mesh(), batch_mesh([dev, dev])):
        name = "[" + ", ".join(str(d) for d in mesh) + "]"
        for mode, kw, want, never in (
                ("frame-packed", {}, ("pack_symbols", "splice_subframes",
                                      "autocorr_levinson"), ()),
                ("residual-only",) + ENCODE_MODES["residual-only"]):
            kernels.reset_launches()
            before = graph_replays()
            got, enc = encode_port(pcm16, 44100, 16, "f64", dev, mesh=mesh,
                                   **kw)
            launches = dict(kernels.LAUNCHES)
            if got != data16:
                raise AssertionError(f"mesh {name} ({mode}): bytes differ "
                                     "from the unsharded stream")
            check_launches(f"mesh {name} {mode} encode path", launches,
                           want, never)
            check_replays(f"mesh {name} {mode} encode path", before,
                          batch_replays(len(pcm16) // 2 // 4096,
                                        len(mesh)))
            print(f"mesh {name}: 16-bit 120 s ({mode}) byte-identical, "
                  f"{enc.device_frames} device frames, {enc.fallback_frames}"
                  f" fallback frames; launches {launches}")
        kernels.reset_launches()
        before, stats = set(decode_graphs()), {}
        for label, data, inter in streams:
            pcm, dec = decode_port(data, dev, mesh=mesh, stats=stats)
            if pcm.device != mesh[0] or not np.array_equal(
                    pcm.cpu().numpy().reshape(-1), inter):
                raise AssertionError(f"mesh {name}: {label} decoded PCM "
                                     "differs from the input")
        launches = dict(kernels.LAUNCHES)
        check_launches(f"mesh {name} decode path", launches,
                       ("predict_lpc",))
        print(f"mesh {name}: the three streams decode losslessly onto "
              f"{mesh[0]}; launches {launches}; {stats['batches']} device "
              f"batches, {stats['reconstruct']} reconstruct replays (one "
              "per shard holding a real frame)")
        report_captures(f"mesh {name} decode", before)


def check_mesh_device_parse(dev, data16, pcm16) -> None:
    """Phase 21: the 120 s 16-bit stream through ``BatchDecoder(mesh=
    [cuda:0, cuda:0], device_parse=True)``, which decodes through the
    host parse as the JAX package does: the PCM of the unsharded
    device-parse decode (and the input), K3 launched and K4 not, every
    device batch a reconstruct replay per shard holding a real frame."""
    import torch

    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.parallel.mesh import batch_mesh

    want, _ = decode_port(data16, dev, device_parse=True)
    mesh = batch_mesh([dev, dev])
    kernels.reset_launches()
    before, stats = set(decode_graphs()), {}
    got, dec = decode_port(data16, dev, device_parse=True, mesh=mesh,
                           stats=stats)
    launches = dict(kernels.LAUNCHES)
    if dec._device_parse:
        raise AssertionError("mesh with device_parse=True: the device "
                             "parse stayed on")
    if not (torch.equal(got, want) and np.array_equal(
            got.cpu().numpy().reshape(-1), pcm16)):
        raise AssertionError("mesh with device_parse=True: PCM differs "
                             "from the unsharded device-parse decode")
    check_launches("mesh with device_parse=True", launches,
                   ("predict_lpc",), ("parse_frame_bodies",))
    print(f"mesh [{dev}, {dev}] with device_parse=True: the device parse "
          f"is off under the mesh (the host parse filled each batch), PCM "
          f"== the unsharded device-parse decode's and the input; "
          f"{dec.device_frames} device frames, {dec.host_frames} host "
          f"frames, {stats['batches']} device batches, "
          f"{stats['reconstruct']} reconstruct replays (one per shard "
          f"holding a real frame), {stats.get('parse', 0)} parse replays; "
          f"launches {launches}")
    report_captures("mesh with device_parse=True", before)


def check_jax_call_shapes(dev, root, pcm16, pcm24, data16) -> None:
    """Phase 22: the JAX package's call shapes on the card, each run
    counted: the positional ``BatchEncoder(..., 256, None, "f64")`` (the
    bytes of phase 3; K1, K2 and the autocorrelation launched, every batch
    a replay), the positional ``BatchDecoder(f, 256, None, True)`` (PCM ==
    the input; K4 and K3 launched, only the tail batch handed to the host
    parse), ``wav2flac --tpu`` and ``flac2wav --tpu -j 4`` in process on
    two files (the host encoder's bytes, and the input WAVs back), and
    ``flac_codec_tpu_torch.FlacSampleWriter`` resolved."""
    import shutil

    import torch

    import flac_codec_tpu_torch
    from flac_codec_tpu_torch import cli, kernels
    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder
    from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder
    from flac_codec_tpu_torch import metadata as meta
    from flac_codec_tpu_torch.utils.wav import (pcm_to_wave_bytes,
                                                read_wave_header, write_wave)

    if flac_codec_tpu_torch.FlacSampleWriter is not FlacSampleWriter:
        raise AssertionError("flac_codec_tpu_torch.FlacSampleWriter is not "
                             "the port's FlacSampleWriter")
    n = len(pcm16) // 2
    kernels.reset_launches()
    before = graph_replays()
    buf = io.BytesIO()
    enc = BatchEncoder(buf, Options.best(), 44100, 16, 2, n, BATCH_FRAMES,
                       None, "f64")
    enc.write(pcm16)
    enc.finalize()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if (enc.device.type, enc.mesh, enc.analysis) != ("cuda", None, "f64"):
        raise AssertionError("positional BatchEncoder bound its arguments "
                             f"to device {enc.device}, mesh {enc.mesh}, "
                             f"analysis {enc.analysis}")
    if buf.getvalue() != data16:
        raise AssertionError("positional BatchEncoder(..., 256, None, "
                             "'f64'): bytes differ from phase 3's")
    check_launches("positional BatchEncoder", launches,
                   ("splice_subframes", "pack_symbols", "autocorr_levinson"))
    check_replays("positional BatchEncoder", before,
                  batch_replays(n // 4096))
    print("BatchEncoder(buf, Options.best(), 44100, 16, 2, n, 256, None, "
          f"'f64') on {enc.device}: the bytes of phase 3; launches "
          f"{launches}")

    kernels.reset_launches()
    parts = []
    with BatchDecoder(io.BytesIO(data16), BATCH_FRAMES, None, True) as dec:
        while (flat := dec.read_batch_interleaved()) is not None:
            parts.append(flat)
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    pcm = torch.cat(parts)
    if not (dec._device_parse and dec.device.type == "cuda"):
        raise AssertionError("positional BatchDecoder(f, 256, None, True) "
                             "did not parse on the card")
    if pcm.device.type != "cuda" or not np.array_equal(
            pcm.cpu().numpy().reshape(-1), pcm16):
        raise AssertionError("positional BatchDecoder: PCM differs from "
                             "the input")
    if dec.parse_fallbacks != 1:
        raise AssertionError(f"positional BatchDecoder: "
                             f"{dec.parse_fallbacks} batches fell back to "
                             "the host parse (want the tail's only)")
    check_launches("positional BatchDecoder", launches,
                   ("parse_frame_bodies", "predict_lpc"))
    print(f"BatchDecoder(f, 256, None, True) on {dec.device}: lossless, "
          f"{dec.device_frames} device frames, {dec.parse_fallbacks} "
          f"fallback batch (the tail); launches {launches}")

    work = os.path.join(root, "flac_codec_tpu_torch", "build", "chip_smoke",
                        "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "out"))
    clips = {"a": (pcm16[:2 * 10 * 44100], 44100, 16),
             "b": (pcm24[:2 * 5 * 96000], 96000, 24)}
    for name, (inter, rate, bps) in clips.items():
        with open(os.path.join(work, f"{name}.wav"), "wb") as f:
            write_wave(f, rate, 2, bps, len(inter) // 2)
            f.write(pcm_to_wave_bytes(inter, bps))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        kernels.reset_launches()
        for name in clips:
            if cli.main(["wav2flac", "--tpu", f"{name}.wav",
                         f"{name}.flac"]) != 0:
                raise AssertionError(f"wav2flac --tpu {name}.wav failed")
        torch.cuda.synchronize()
        enc_launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        if cli.main(["flac2wav", "--tpu", "-j", "4", "a.flac", "b.flac",
                     "-o", "out"]) != 0:
            raise AssertionError("flac2wav --tpu -j 4 failed")
        torch.cuda.synchronize()
        dec_launches = dict(kernels.LAUNCHES)
        for name, (inter, rate, bps) in clips.items():
            # the host encoder with wav2flac's options (its channel mask
            # tag for an EXTENSIBLE header), as the JAX tool runs it
            # without --tpu
            opts = Options()
            with open(f"{name}.wav", "rb") as f:
                mask = read_wave_header(f).channel_mask
            if mask is not None:
                opts = opts.tag(meta.fields.WAVEFORMATEXTENSIBLE_CHANNEL_MASK,
                                f"0x{mask:04x}")
            host = io.BytesIO()
            w = FlacSampleWriter(host, opts, rate, bps, 2,
                                 total_samples=len(inter) // 2)
            w.write(inter)
            w.finalize()
            with open(f"{name}.flac", "rb") as f:
                if f.read() != host.getvalue():
                    raise AssertionError(f"wav2flac --tpu {name}.wav: bytes "
                                         "differ from FlacSampleWriter's")
            with open(f"{name}.wav", "rb") as f, \
                    open(os.path.join("out", f"{name}.wav"), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"flac2wav --tpu -j 4 {name}.flac: "
                                         "the WAV differs from the input")
    finally:
        os.chdir(cwd)
    check_launches("wav2flac --tpu", enc_launches,
                   ("splice_subframes", "pack_symbols", "autocorr_levinson"))
    check_launches("flac2wav --tpu -j 4", dec_launches, ("predict_lpc",))
    print("wav2flac --tpu (16-bit 10 s, 24-bit 5 s): FlacSampleWriter's "
          f"bytes, launches {enc_launches}; flac2wav --tpu -j 4: the input "
          f"WAVs back, launches {dec_launches}")


def native_flavors(data16: bytes, runs: int = 7) -> None:
    """Phase 22: the native flavor that loaded (the v3 build must load on
    an x86-64-v3 host unless ``FLAC_TPU_PORTABLE_SO`` is set), and
    ``parse_frames_raw`` over the 120 s stream's whole frames in each flavor,
    interleaved, the same arrays from both, median of ``runs`` each."""
    from flac_codec_tpu_torch import native
    from flac_codec_tpu_torch.decode import Decoder

    v3_host = native._cpu_is_v3()
    forced = bool(os.environ.get("FLAC_TPU_PORTABLE_SO"))
    print(f"native flavor loaded: {native.FLAVOR} (x86-64-v3 host: "
          f"{v3_host}, FLAC_TPU_PORTABLE_SO set: {forced})")
    if native.V3_ERROR:
        print("  v3 build error: " + native.V3_ERROR.splitlines()[0])
    if v3_host and not forced and native.FLAVOR != "v3":
        raise AssertionError("an x86-64-v3 host loaded the "
                             f"{native.FLAVOR} native engine")
    flavors = ("portable", "v3") if v3_host else ("portable",)
    libs = {f: native.open_flavor(f) for f in flavors}
    dec = Decoder(io.BytesIO(data16))
    si = dec.streaminfo
    frames = dec.total_samples // si.maximum_block_size   # whole frames
    args = (dec.r.np_view(), dec.r.pos, frames, si.sample_rate, si.channels,
            si.bits_per_sample, si.maximum_block_size, dec.total_samples)
    secs, first = {f: [] for f in flavors}, {}
    for _ in range(runs):
        for f in flavors:
            t = time.perf_counter()
            raw = libs[f].parse_frames_raw(*args)
            secs[f].append((time.perf_counter() - t) * 1e3)
            first.setdefault(f, raw)
    if first["portable"]["n"] != frames:
        raise AssertionError(f"parse_frames_raw parsed "
                             f"{first['portable']['n']} of {frames} frames")
    for f in flavors[1:]:
        for k, v in first["portable"].items():
            if not np.array_equal(first[f][k], v):
                raise AssertionError(f"parse_frames_raw: the {f} flavor's "
                                     f"{k} differs from the portable one's")
    print(f"parse_frames_raw, 120 s 16-bit stream ({frames} whole frames), "
          f"interleaved, median of {runs}: " + "; ".join(
              f"{f} {statistics.median(t):.3f} ms (runs "
              f"{', '.join(f'{x:.3f}' for x in t)})"
              for f, t in secs.items())
          + (", the same arrays" if len(flavors) > 1 else
             "; v3 not measured (the host is not x86-64-v3)")
          + f"; host CPU on the card's machine, {card()}")


def graph_replays() -> dict:
    """Each captured plan graph's replays so far, by key."""
    from flac_codec_tpu_torch.ops.encode_batch import PLAN_GRAPHS

    return {k: g.replays for k, g in PLAN_GRAPHS.items()}


def graph_name(key) -> str:
    """A plan graph's key, short: device, stream, input and mode."""
    device, stream, shape, dtype, kw = key
    kw = dict(kw)
    return (f"{device} stream {stream:#x} {tuple(shape)} "
            f"{str(dtype).split('.')[-1]} {kw['bits_per_sample']}-bit "
            f"{kw['analysis']} pack_budget={kw['pack_budget']} "
            f"frame_pack={kw['frame_pack']}")


def batch_replays(frames: int, shards: int = 1) -> int:
    """How many graph replays ``frames`` whole frames take in 256-frame
    batches over ``shards`` shards: a replay per shard holding a real
    frame (the short batch is padded; a shard of padding only is not
    planned)."""
    sizes = [len(c) for c in np.array_split(np.arange(BATCH_FRAMES),
                                             shards)]
    firsts = np.cumsum([0] + sizes[:-1])
    total = 0
    for lo in range(0, frames, BATCH_FRAMES):
        real = min(BATCH_FRAMES, frames - lo)
        total += sum(1 for f, n in zip(firsts, sizes) if n and f < real)
    return total


def check_replays(label: str, before: dict, want: int) -> None:
    """Raise unless the plan graphs replayed ``want`` times since
    ``before`` (``graph_replays()``); print each graph captured since,
    with the growth of ``memory_reserved`` its capture left."""
    from flac_codec_tpu_torch.ops.encode_batch import PLAN_GRAPHS

    for key, g in PLAN_GRAPHS.items():
        if key not in before:
            tally = {k: v for k, v in g.tally.items() if v}
            print(f"  captured {graph_name(key)}: memory_reserved "
                  f"{capture_memory(g)}, warm-up and capture "
                  f"{g.capture_seconds:.2f} s, launches a replay {tally}")
    got = sum(n - before.get(k, 0) for k, n in graph_replays().items())
    if got != want:
        raise AssertionError(f"{label}: {got} graph replays, want {want} "
                             "(one per shard of every whole-frame batch)")
    print(f"{label}: {got} graph replays, one per shard of every "
          "whole-frame batch")


def replay_ms(graph, n: int = 10) -> float:
    """Device ms of one replay of ``graph``: CUDA events around ``n``
    back-to-back replays on its stream (the host enqueues a replay in
    microseconds, so the device runs them without a gap).  These replays
    are measurements and are not counted in ``kernels.LAUNCHES``."""
    import torch

    with torch.cuda.stream(graph.stream):
        graph.graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_batches(fn, batches: int) -> tuple:
    """``torch.profiler`` over ``fn()``: (device ms a batch, the kernels'
    and copies' own device time, or None where the profiler saw none;
    host CUDA API calls a batch, every ``cuda*`` call counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_us, api = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            device_us += t if t is not None else e.self_cuda_time_total
        elif e.key.startswith("cuda"):
            api += e.count
    return (device_us / 1e3 / batches if device_us > 0 else None,
            api / batches)


# phase 17's configurations: mode, analysis, BatchEncoder arguments
GRAPH_CONFIGS = (("frame-packed", "f64", {}),
                 ("residual-only", "f64", {"frame_pack": False}),
                 ("plan tree", "f64", {"pack_budget": 0}),
                 ("frame-packed", "f32", {}))

ENCODE_STAGES = ("encode.dispatch", "encode.download", "encode.md5",
                 "encode.assemble")


def compare_graphs(dev, pcm16, trace_path: str) -> None:
    """Phase 17: the 120 s clip encoded with CUDA graphs and with
    ``graphs=False`` in each configuration, in turns."""
    import torch

    from flac_codec_tpu_torch.ops.encode_batch import (PLAN_GRAPHS,
                                                       encode_frames_plan)

    mb = len(pcm16) * 2 / 1e6
    batches = batch_replays(len(pcm16) // 2 // 4096)
    for mode, analysis, kw in GRAPH_CONFIGS:
        runs = {True: [], False: []}
        before = graph_replays()
        for i in range(3):
            for graphs in ((True, False) if i % 2 == 0 else (False, True)):
                open(trace_path, "w").close()
                t = time.perf_counter()
                _, enc = encode_port(pcm16, 44100, 16, analysis, dev,
                                     graphs=graphs, **kw)
                runs[graphs].append((time.perf_counter() - t,
                                     stage_ms(trace_path, ENCODE_STAGES)))
        (key, _), = ((k, n) for k, n in graph_replays().items()
                     if n != before.get(k, 0))
        graph = PLAN_GRAPHS[key]
        x = graph.input.clone()
        timers = {
            True: replay_ms(graph),
            False: cuda_ms(lambda: encode_frames_plan(x, **dict(key[4])),
                           reps=3)}
        for graphs in (True, False):
            secs, stages = sorted(runs[graphs], key=lambda r: r[0])[1]
            dev_ms, api = profile_batches(
                lambda: encode_port(pcm16, 44100, 16, analysis, dev,
                                    graphs=graphs, **kw), batches)
            name = "graphs" if graphs else "graphs=False"
            timer = ("events around back-to-back replays" if graphs
                     else "events around one eager call")
            prof = "not measured" if dev_ms is None else f"{dev_ms:.2f} ms"
            print(f"encode {analysis} {mode} ({name}): {mb / secs:.2f} MB/s "
                  f"of PCM (median of 3: {secs:.3f} s; runs "
                  f"{', '.join(f'{r[0]:.3f}' for r in runs[graphs])}); in "
                  "the median run " + ", ".join(
                      f"{k} {v:.1f} ms ({v / batches:.2f} a batch)"
                      for k, v in stages.items())
                  + f"; a batch: device {timers[graphs]:.2f} ms ({timer}), "
                  f"profiler kernel and copy time {prof}, {api:.0f} host "
                  f"CUDA API calls; on {card()}")
        print(f"  its graph {graph_name(key)}: memory_reserved "
              f"{capture_memory(graph)}, warm-up and capture "
              f"{graph.capture_seconds:.2f} s")


# the decode stages of each parse path (device_parse False / True)
DECODE_STAGES = {False: ("decode.parse", "decode.reconstruct"),
                 True: ("decode.scan", "decode.upload",
                        "decode.parse_device", "decode.reconstruct")}


def compare_decode_graphs(dev, clips, trace_path: str) -> None:
    """Phase 18: the 16-bit and 24-bit streams decoded with CUDA graphs
    and with ``graphs=False`` through both parse paths, in turns."""
    from flac_codec_tpu_torch.ops.framescan import parse_batch
    from flac_codec_tpu_torch.parallel.batch_decode import (
        _device_reconstruct, recon_views)

    for label, data, inter, width in clips:
        mb = len(inter) * width / 1e6
        for device_parse in (False, True):
            parse = "device" if device_parse else "host"
            before = {k: g.replays for k, g in decode_graphs().items()}
            runs, stats = {True: [], False: []}, {}
            for i in range(3):
                for graphs in ((True, False) if i % 2 == 0
                               else (False, True)):
                    open(trace_path, "w").close()
                    stats.clear()
                    t = time.perf_counter()
                    decode_port(data, dev, device_parse=device_parse,
                                graphs=graphs, stats=stats)
                    runs[graphs].append((
                        time.perf_counter() - t,
                        stage_ms(trace_path, DECODE_STAGES[device_parse])))
            batches = stats["batches"]
            # the graphs of the full batch: those replayed most
            used = {}
            for key, g in decode_graphs().items():
                n = g.replays - before.get(key, 0)
                if n and n > used.get(key[0], (None, None, 0))[2]:
                    used[key[0]] = (key, g, n)
            # device ms a batch, by graph: events around back-to-back
            # replays, and around one eager call on the same inputs
            timers = {True: {}, False: {}}
            for kind, (key, g, _) in sorted(used.items()):
                x = g.input.clone()
                if kind == "parse":
                    frames, _, block, ch, bps = key[3:]
                    fn = functools.partial(parse_batch, x, frames, block, ch,
                                           bps)
                else:
                    shape, mode, taps = key[3:]
                    fn = functools.partial(
                        lambda x, s, m, t: _device_reconstruct(
                            *recon_views(x, *s), mode=m, taps=t),
                        x, shape, mode, taps)
                timers[True][kind] = replay_ms(g)
                timers[False][kind] = cuda_ms(fn, reps=3)
            for graphs in (True, False):
                secs, stages = sorted(runs[graphs], key=lambda r: r[0])[1]
                dev_ms, api = profile_batches(
                    lambda: decode_port(data, dev, device_parse=device_parse,
                                        graphs=graphs), batches)
                name = "graphs" if graphs else "graphs=False"
                timer = ("events around back-to-back replays" if graphs
                         else "events around one eager call")
                prof = ("not measured" if dev_ms is None
                        else f"{dev_ms:.3f} ms")
                print(f"decode {label} ({parse} parse, {name}): "
                      f"{mb / secs:.2f} MB/s of PCM (median of 3: "
                      f"{secs:.3f} s; runs "
                      f"{', '.join(f'{r[0]:.3f}' for r in runs[graphs])}); "
                      "in the median run " + ", ".join(
                          f"{k} {v:.2f} ms ({v / batches:.3f} a batch)"
                          for k, v in stages.items())
                      + "; a batch: device " + " + ".join(
                          f"{k} {v:.3f} ms" for k, v in
                          sorted(timers[graphs].items()))
                      + f" ({timer}), profiler kernel and copy time {prof}, "
                      f"{api:.0f} host CUDA API calls ({batches} device "
                      f"batches); on {card()}")
            for key, g, n in used.values():
                print(f"  its graph {decode_graph_name(key)}: "
                      f"memory_reserved {capture_memory(g)}, warm-up and "
                      f"capture {g.capture_seconds:.3f} s")


# phase 19: the device fuzzer's seed and trials
FUZZ_SEED = 14
FUZZ_TRIALS = 480


def check_fuzz(root: str, dev) -> None:
    """Phase 19: the port's device fuzzer (``tools/fuzz_roundtrip_torch.py``
    of the checkout at ``root``) on the card, counted: no trial may fail,
    and every kernel of the port must launch during it."""
    import importlib.util

    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.ops.encode_batch import PLAN_GRAPHS

    spec = importlib.util.spec_from_file_location(
        "fuzz_roundtrip_torch",
        os.path.join(root, "tools", "fuzz_roundtrip_torch.py"))
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    before = set(PLAN_GRAPHS) | set(decode_graphs())
    kernels.reset_launches()
    t = time.perf_counter()
    fails = fuzz.fuzz_device(np.random.default_rng(FUZZ_SEED),
                             time.time() + 3600, FUZZ_TRIALS, device=dev)
    secs = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    captured = (set(PLAN_GRAPHS) | set(decode_graphs())) - before
    print(f"device fuzz, seed {FUZZ_SEED}: {FUZZ_TRIALS} trials, {fails} "
          f"failures, {secs:.2f} s, {len(captured)} graphs captured; "
          f"launches {launches}; pools {pool_totals()}; on {card()}")
    if fails:
        raise AssertionError(f"device fuzz: {fails} of {FUZZ_TRIALS} trials "
                             "failed")
    check_launches("device fuzz", launches, tuple(launches))


# phase 20's mixed library: bits, channels, sample rate, block size; each
# format encoded in f64 and f32 from a clip of LIBRARY_FRAMES frames,
# padded to one 256-frame batch
LIBRARY = ((16, 1, 44100, 4096), (16, 2, 44100, 4096), (24, 2, 96000, 4096),
           (24, 6, 48000, 4096), (24, 8, 96000, 16384))
LIBRARY_FRAMES = 5
# phase 20 fails if memory_reserved grows past the largest single
# capture's pool by more than this
LIBRARY_SLACK = 2 << 30
# and if its peak passes that growth by more than this: a warm-up takes
# its temporaries from its stream's pool, so only buffers outside the
# graphs (a batch's PCM, staging) come and go
PEAK_SLACK = 1 << 30


def library_clip(bps: int, ch: int, block: int, seed: int) -> np.ndarray:
    """LIBRARY_FRAMES frames of seeded ``ch``-channel PCM, interleaved
    int32: a sine a channel at half scale over noise."""
    rng = np.random.default_rng(seed)
    n = LIBRARY_FRAMES * block
    t = np.arange(n)
    half = 1 << (bps - 2)
    return np.stack([half * np.sin(t * (0.01 + 0.003 * c))
                     + rng.integers(-999, 1000, n) for c in range(ch)]
                    ).T.reshape(-1).astype(np.int32)


def mixed_library(dev, check: bool = True) -> dict:
    """Phase 20: the formats of ``LIBRARY`` encoded one after another in
    one process, each in f64 (bytes == ``FlacSampleWriter``'s) and f32
    (MD5 verified), each stream decoded through both parse paths (PCM ==
    input), then the first format encoded again (bytes == its first
    encode).  Prints ``memory_reserved`` after each format and the
    growth over the phase, and the largest single capture's pool: the
    growth of capturing the largest configuration (8 channels, block
    16384, f64 and f32) alone on a fresh stream, with the peak of each
    such capture.  The phase's peak is ``max_memory_reserved`` across
    the resets each capture makes (``graphs.max_memory_reserved``; a
    checkout without it resets nothing).  With ``check``, raises if the
    growth passes that pool plus ``LIBRARY_SLACK``, or the peak passes
    the growth by more than ``PEAK_SLACK``.  Returns the numbers."""
    import torch

    from flac_codec_tpu_torch import graphs
    from flac_codec_tpu_torch.decode import Verified, verify
    from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
    from flac_codec_tpu_torch.ops.encode_batch import PlanGraph
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    def encode(cls, inter, ch, rate, bps, block, **kw):
        buf = io.BytesIO()
        enc = cls(buf, Options.best().with_block_size(block), rate, bps, ch,
                  total_samples=len(inter) // ch, **kw)
        enc.write(inter)
        enc.finalize()
        return buf.getvalue(), enc

    mib = 2 ** 20
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    getattr(graphs, "reset_peak_memory_stats",
            torch.cuda.reset_peak_memory_stats)(dev)
    start = torch.cuda.memory_reserved(dev)
    print(f"mixed library: memory_reserved {start / mib:.1f} MiB at the "
          f"start; on {card()}")
    first, largest = None, {}
    t0 = time.perf_counter()
    for i, (bps, ch, rate, block) in enumerate(LIBRARY):
        inter = library_clip(bps, ch, block, seed=20 + i)
        label = f"{ch} ch {bps}-bit {rate} Hz block {block}"
        host, _ = encode(FlacSampleWriter, inter, ch, rate, bps, block)
        for analysis in ("f64", "f32"):
            before = graph_replays()
            data, enc = encode(BatchEncoder, inter, ch, rate, bps, block,
                               batch_frames=BATCH_FRAMES, analysis=analysis,
                               device=dev)
            check_replays(f"{label} {analysis} encode", before,
                          batch_replays(LIBRARY_FRAMES))
            if analysis == "f64" and data != host:
                raise AssertionError(f"{label}: f64 stream differs from "
                                     "FlacSampleWriter's")
            if analysis == "f32" and verify(io.BytesIO(data)) \
                    != Verified.MD5_MATCH:
                raise AssertionError(f"{label}: f32 stream failed MD5 "
                                     "verification")
            if first is None:
                first = (inter, ch, rate, bps, block, data)
            if ch == 8:
                largest[analysis] = ((BATCH_FRAMES, ch, block),
                                     torch.int32, enc._plan_kw)
            for device_parse in (False, True):
                pcm, _ = decode_port(data, dev, device_parse=device_parse)
                if not np.array_equal(pcm.cpu().numpy().reshape(-1), inter):
                    raise AssertionError(f"{label} {analysis}: decode "
                                         f"(device_parse={device_parse}) "
                                         "differs from the input")
                del pcm
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        print(f"mixed library, after {label} (f64 bytes == "
              "FlacSampleWriter's, f32 MD5 verified, both parse paths "
              "lossless): memory_reserved "
              f"{torch.cuda.memory_reserved(dev) / mib:.1f} MiB; pools "
              f"{pool_totals()}")
    inter, ch, rate, bps, block, data = first
    again, _ = encode(BatchEncoder, inter, ch, rate, bps, block,
                      batch_frames=BATCH_FRAMES, analysis="f64", device=dev)
    if again != data:
        raise AssertionError("mixed library: the first format's second "
                             "encode differs from its first")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    growth = torch.cuda.memory_reserved(dev) - start
    peak = getattr(graphs, "max_memory_reserved",
                   torch.cuda.max_memory_reserved)(dev) - start
    secs = time.perf_counter() - t0
    alone, alone_peak = {}, {}
    for analysis, (shape, dtype, kw) in largest.items():
        g = PlanGraph(shape, dtype, fresh_stream(dev), **kw)
        alone[analysis] = g.reserved_bytes
        alone_peak[analysis] = getattr(g, "peak_bytes", None)
        del g
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    pool = max(alone.values())
    print(f"mixed library: {len(LIBRARY)} formats x (f64, f32), both parse "
          f"paths, in {secs:.2f} s; the first format re-encoded "
          f"byte-identical; memory_reserved growth {growth / mib:.1f} MiB "
          f"(peak {peak / mib:.1f} MiB); the largest single capture's pool "
          f"{pool / mib:.1f} MiB (8 ch block 16384, each alone on a "
          "fresh stream: " + ", ".join(
              f"{a} {b / mib:.1f} MiB (peak "
              + ("not kept" if alone_peak[a] is None
                 else f"{alone_peak[a] / mib:.1f} MiB") + ")"
              for a, b in alone.items())
          + f"); limit {(pool + LIBRARY_SLACK) / mib:.1f} MiB at rest, "
          f"{(growth + PEAK_SLACK) / mib:.1f} MiB at the peak; on {card()}")
    if check and growth > pool + LIBRARY_SLACK:
        raise AssertionError(f"mixed library: memory_reserved grew "
                             f"{growth / mib:.1f} MiB, past the largest "
                             f"pool {pool / mib:.1f} MiB + 2 GiB")
    if check and peak - growth > PEAK_SLACK:
        raise AssertionError(f"mixed library: memory_reserved peaked at "
                             f"+{peak / mib:.1f} MiB, more than 1 GiB above "
                             f"its growth at rest {growth / mib:.1f} MiB")
    return {"growth_mib": growth / mib, "peak_mib": peak / mib,
            "largest_pool_mib": pool / mib,
            "largest_peak_mib": {a: None if b is None else b / mib
                                 for a, b in alone_peak.items()},
            "seconds": secs}


def fresh_stream(dev):
    """A stream of ``dev`` on which no graph of this process was
    captured, cached or not (PyTorch hands streams out from a pool, so a
    new ``torch.cuda.Stream`` may be one that is in use)."""
    import torch

    from flac_codec_tpu_torch import graphs
    from flac_codec_tpu_torch.ops.encode_batch import PLAN_GRAPHS

    used = {(g.stream.device, g.stream.cuda_stream)
            for g in [*PLAN_GRAPHS.values(), *decode_graphs().values()]}
    used |= set(getattr(graphs, "POOL_BYTES", {}))
    for _ in range(128):
        s = torch.cuda.Stream(device=dev)
        if (s.device, s.cuda_stream) not in used:
            return s
    raise RuntimeError("no stream without graphs")


# phase 23: the benchmark's chain of back-to-back replays (its default is
# 48), and the kernels each of its sections must launch
BENCH_CHAIN = 8
ENCODE_KERNELS = ("splice_subframes", "pack_symbols")
BENCH_LAUNCHES = {
    "headline": ENCODE_KERNELS, "dispatch": ENCODE_KERNELS,
    "f64": ENCODE_KERNELS + ("autocorr_levinson",),
    "24bit": ENCODE_KERNELS,
    "stream": ENCODE_KERNELS + ("autocorr_levinson",),
    "decode_device_step": ("predict_lpc",),
    "decode_pipeline": ("predict_lpc",),
    "decode_pipeline_device_parse": ("parse_frame_bodies", "predict_lpc"),
    "end_to_end": ENCODE_KERNELS, "assemble": ENCODE_KERNELS}


def check_bench(dev, root) -> None:
    """Phase 23: ``bench_torch.py``'s sections on the card, in process
    (module docstring)."""
    import math

    import bench_torch
    from flac_codec_tpu_torch import kernels

    def positive(v) -> bool:
        if isinstance(v, dict):
            return bool(v) and all(positive(x) for x in v.values())
        return isinstance(v, (int, float)) and math.isfinite(v) and v > 0

    cfg = bench_torch.Config(chain=BENCH_CHAIN, cache_dir=None)
    lines, ctx = [], {}
    kernels.reset_launches()
    t = time.perf_counter()
    out, rc = bench_torch.run(dev, cfg, time.time() + 900,
                              emit=lambda o: lines.append(dict(o)), ctx=ctx)
    launches = dict(kernels.LAUNCHES)
    secs = time.perf_counter() - t
    print(f"bench_torch.run, chain {BENCH_CHAIN}: {secs:.1f} s, final "
          f"line {json.dumps(out)}")
    if rc or out["errors"] or out["skipped"] or out["disabled"]:
        raise AssertionError(f"bench_torch: exit code {rc}, errors "
                             f"{out['errors']}, skipped {out['skipped']}, "
                             f"disabled {out['disabled']}")
    if lines[0].get("metric") != bench_torch.METRIC or "errors" in lines[0] \
            or lines[-1]["value"] != lines[0]["value"]:
        raise AssertionError("bench_torch: the first line is not the "
                             "headline, or the last has another value")
    bad = [k for k in bench_torch.KEYS if not positive(out.get(k))]
    if bad:
        raise AssertionError(f"bench_torch: keys not finite and positive: "
                             f"{bad}")
    if out["captures"]["headline"] or out["captures"]["f64"]:
        raise AssertionError(f"bench_torch captured graphs in its encode "
                             f"steps ({out['captures']}): it times another "
                             "graph than the encoders of phases 3-4")
    want = dict(BENCH_LAUNCHES)
    if not out["decode_device_step_mode"].startswith("lpc"):
        want["decode_device_step"] = ()  # the FIXED cumsum, no kernel
    missing = [(s, k) for s, names in want.items() for k in names
               if out["launches"][s].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"bench_torch: kernels not launched: {missing}")
    counted = {k: sum(n.get(k, 0) for n in out["launches"].values())
               for k in launches}
    if counted != launches:
        raise AssertionError(f"bench_torch: sections counted {counted}, "
                             f"kernels.LAUNCHES {launches}")
    with open(os.path.join(root, ".bench_cache",
                           "bench_p8_24s_seed3.flac"), "rb") as f:
        tracked = f.read()
    if ctx["stream"] != tracked or out["compression_ratio_preset8"] != 0.6676:
        raise AssertionError(
            f"bench_torch: the {len(ctx['stream'])}-byte decode stream is "
            f"not the tracked {len(tracked)}-byte one (ratio "
            f"{out['compression_ratio_preset8']})")
    print(f"bench_torch: {len(lines)} lines, every key positive, launches "
          f"{launches}, captures {out['captures']}, decode stream == "
          f".bench_cache/bench_p8_24s_seed3.flac, ratio "
          f"{out['compression_ratio_preset8']}, pools {out['pool_mib']:.1f} "
          f"MiB, on {card()}")


# phase 24: the profiler's chain of back-to-back replays; the most of the
# eager plan's kernel time the profiler may leave unlinked to a launch;
# the most of its launches and kernel time the plan's own range may hold
# beside its stage ranges (the assignment choice); how far, as a share,
# the eager plan's launches may be from the replay's (which copies its
# input in, and whose first-use constants an eager run late in a process
# may find built)
PROFILE_CHAIN = 8
UNATTRIBUTED_SHARE = 0.05
PLAN_OWN_SHARE = 0.01
LAUNCH_SHARE = 0.01


def load_tool(root, name: str):
    """The module ``tools/<name>.py``, loaded from its file, so that the
    JAX package's tools beside it never come onto ``sys.path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # its dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def check_profile(dev, root) -> None:
    """Phase 24: ``tools/profile_encode_torch.py``'s three modes on the
    card, in process (module docstring)."""
    from flac_codec_tpu_torch import kernels
    from flac_codec_tpu_torch.ops.encode_batch import PLAN_GRAPHS

    pe = load_tool(root, "profile_encode_torch")
    attrs = pe.patched_attributes()
    planned = set(PLAN_GRAPHS)
    for analysis in ("f32", "f64"):
        cfg = pe.Config(analysis=analysis, chain=PROFILE_CHAIN)
        t = time.perf_counter()
        ins = pe.insitu(dev, cfg)
        share, diff = ins["unattributed_share"], ins["launch_difference"]
        own = max(ins["plan_own_share"],
                  ins["plan_own_launches"] / ins["eager_launches"])
        if not (share <= UNATTRIBUTED_SHARE and own <= PLAN_OWN_SHARE
                and abs(diff) <= LAUNCH_SHARE * ins["replay_launches"]):
            raise AssertionError(
                f"profile {analysis} insitu: unattributed share {share} "
                f"(at most {UNATTRIBUTED_SHARE}), the plan's own range "
                f"{own} (at most {PLAN_OWN_SHARE}), eager less replay "
                f"launches {diff} (at most {LAUNCH_SHARE} of the replay's "
                f"{ins['replay_launches']})")
        kernels.reset_launches()
        st = pe.stages(dev, cfg)
        launches = dict(kernels.LAUNCHES)
        want = ENCODE_KERNELS + (("autocorr_levinson",)
                                 if analysis == "f64" else ())
        missing = [k for k in want if launches[k] <= 0]
        if missing or not all(r["equal"] for r in st["rows"]) \
                or not st["stage_pool_released"]:
            raise AssertionError(
                f"profile {analysis} stages: kernels not launched "
                f"{missing}, stage pool released "
                f"{st['stage_pool_released']}")
        secs = time.perf_counter() - t
        print(f"profile {analysis}: insitu and stages {secs:.1f} s, "
              f"unattributed {share:.2%}, the plan's own range {own:.2%}, "
              f"eager less replay launches {diff:+.0f}, stage launches "
              f"{launches}, {len(st['rows'])} stages equal to eager, full "
              f"replay moved while timing after {st['moved_while_timing']}, on {card()}")
    if set(PLAN_GRAPHS) != planned:
        raise AssertionError(f"profile: insitu and stages captured "
                             f"{len(set(PLAN_GRAPHS) - planned)} plan "
                             "graphs, not the encoders' own")
    after = pe.patched_attributes()
    if any(after[k] is not v for k, v in attrs.items()):
        raise AssertionError("profile: a patched stage attribute was not "
                             "restored")
    ab = pe.ablate(dev, pe.Config(chain=PROFILE_CHAIN), multiples=(1, 2))
    if not all(r["ms"] > 0 and r["mbps"] > 0 for r in ab["rows"]):
        raise AssertionError(f"profile ablate: {ab['rows']}")


def stage_ms(path: str, names) -> dict:
    """Sum of each named stage's ms in a FLAC_TPU_TRACE JSONL file."""
    out = dict.fromkeys(names, 0.0)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["stage"] in out:
                out[rec["stage"]] += rec["ms"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    trace_path = os.path.join(root, "flac_codec_tpu_torch", "build",
                              "chip_smoke", "trace.jsonl")
    # stage timings go to this file (read at the port's first import)
    os.environ["FLAC_TPU_TRACE"] = trace_path

    from flac_codec_tpu_torch import kernels, native
    from flac_codec_tpu_torch.decode import Verified, verify

    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    open(trace_path, "w").close()

    # ---- 1. device and environment ----
    dev = torch.device("cuda", 0)
    print(f"card: {card()}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(kernels.library), ex.submit(native.load)]
        for b in builds:
            b.result()
    print(f"kernel and native builds: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.BUILD_INFO.get('seconds', 0.0):.2f} s, "
          f"cached={kernels.BUILD_INFO.get('cached')})")
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip().split("ptxas info    : ")[-1])

    pcm16 = music(SECONDS_16, 44100, 16, seed=16)
    pcm24 = music(SECONDS_24, 96000, 24, seed=24)

    # ---- 2. encode kernels against their plain versions ----
    results = check_kernels(dev, pcm16)

    # ---- 3./4. the encode path, counted ----
    kernels.reset_launches()
    before = graph_replays()
    data16, penc = check_identical("16-bit 44.1 kHz 120 s", pcm16, 44100, 16,
                                   root, dev)
    fallback = penc.fallback_frames
    data24, penc = check_identical("24-bit 96 kHz 20 s", pcm24, 96000, 24,
                                   root, dev)
    fallback += penc.fallback_frames
    data32, penc = encode_port(pcm16, 44100, 16, "f32", dev)
    fallback += penc.fallback_frames
    if verify(io.BytesIO(data32)) != Verified.MD5_MATCH:
        raise AssertionError("f32 stream failed MD5 verification")
    ratio = len(data32) / (len(pcm16) * 2)
    print(f"f32 16-bit 120 s: {len(data32)} bytes, MD5 verified, "
          f"compression ratio {ratio:.4f}")
    launches = dict(kernels.LAUNCHES)

    # ---- 5. the encode path went through its kernels and graphs ----
    frames16, frames24 = len(pcm16) // 2 // 4096, len(pcm24) // 2 // 4096
    check_replays("encode path (phases 3-4)", before,
                  2 * batch_replays(frames16) + batch_replays(frames24))
    print(f"encode-path launches: {launches}; fallback frames: {fallback}")
    for r in results:
        if launches[r["name"]] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched on "
                                 "the encode path")
        r["launches"] = launches[r["name"]]

    # ---- 6. the decode kernel against its plain version ----
    k3 = check_predict(dev, data16)
    results.append(k3)

    # ---- 7. the decode path, counted ----
    streams = (("16-bit 44.1 kHz 120 s f64", data16, pcm16),
               ("24-bit 96 kHz 20 s f64", data24, pcm24),
               ("16-bit 44.1 kHz 120 s f32", data32, pcm16))
    kernels.reset_launches()
    before, stats = set(decode_graphs()), {}
    for label, data, inter in streams:
        pcm, dec = decode_port(data, dev, stats=stats)
        if pcm.device.type != "cuda" or not np.array_equal(
                pcm.cpu().numpy().reshape(-1), inter):
            raise AssertionError(f"{label}: decoded PCM differs from the "
                                 "input")
        print(f"decode {label}: lossless on the card, {dec.device_frames} "
              f"device frames, {dec.host_frames} host frames")
    launches = dict(kernels.LAUNCHES)
    print(f"decode-path launches: {launches}; {stats['batches']} device "
          f"batches, each one reconstruct replay ({stats['reconstruct']})")
    report_captures("decode path (phase 7)", before)
    if launches["predict_lpc"] <= 0:
        raise AssertionError("kernel predict_lpc was not launched on the "
                             "decode path")
    k3["launches"] = launches["predict_lpc"]

    # ---- 8. the conformance corpus on the card ----
    check_corpus(root, dev)

    # ---- 9. the frame-body parser against its plain version ----
    k4 = check_parse(dev, root, data16, data24)
    results.append(k4)

    # ---- 10. the device-parse decode path, counted ----
    kernels.reset_launches()
    before, stats = set(decode_graphs()), {}
    for label, data, inter in streams:
        pcm, dec = decode_port(data, dev, device_parse=True, stats=stats)
        if pcm.device.type != "cuda" or not np.array_equal(
                pcm.cpu().numpy().reshape(-1), inter):
            raise AssertionError(f"{label}: device-parse decode differs from "
                                 "the input")
        if dec.parse_fallbacks != 1 or dec.host_frames != 1:
            raise AssertionError(f"{label}: {dec.parse_fallbacks} batches "
                                 "fell back to the host parse, "
                                 f"{dec.host_frames} host frames (want the "
                                 "short tail's only)")
        print(f"decode {label} (device parse): lossless on the card, "
              f"{dec.device_frames} device frames, {dec.host_frames} host "
              f"frame, {dec.parse_fallbacks} fallback batch (the tail)")
    launches = dict(kernels.LAUNCHES)
    print(f"device-parse decode-path launches: {launches}; "
          f"{stats['batches']} device batches, each one parse and one "
          f"reconstruct replay ({stats['parse']}, {stats['reconstruct']})")
    report_captures("device-parse decode path (phase 10)", before)
    for name in ("parse_frame_bodies", "predict_lpc"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "device-parse decode path")
    k4["launches"] = launches["parse_frame_bodies"]

    # ---- 11. the conformance corpus through the device parse ----
    check_corpus(root, dev, device_parse=True)

    # ---- 12. a slot past one block's shared memory ----
    check_slot_repair(dev)

    # ---- 13. encode and decode rate ----
    mb = len(pcm16) * 2 / 1e6
    for analysis in ("f64", "f32"):
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            encode_port(pcm16, 44100, 16, analysis, dev)
            secs.append(time.perf_counter() - t)
        med = statistics.median(secs)
        print(f"encode {analysis}: {mb / med:.2f} MB/s of PCM "
              f"(median of 3: {med:.3f} s for {mb:.2f} MB; runs "
              f"{', '.join(f'{s:.3f}' for s in secs)}) on {card()}")
    stage_names = {False: ("decode.parse", "decode.reconstruct"),
                   True: ("decode.scan", "decode.upload",
                          "decode.parse_device", "decode.reconstruct")}
    for label, data, inter, width in (
            ("16-bit 120 s", data16, pcm16, 2),
            ("24-bit 20 s", data24, pcm24, 3)):
        mb = len(inter) * width / 1e6
        for device_parse in (False, True):
            runs = []
            for _ in range(3):
                open(trace_path, "w").close()
                t = time.perf_counter()
                decode_port(data, dev, device_parse=device_parse)
                secs = time.perf_counter() - t
                runs.append((secs, stage_ms(trace_path,
                                            stage_names[device_parse])))
            secs, stages = sorted(runs, key=lambda r: r[0])[1]
            parse = "device" if device_parse else "host"
            print(f"decode {label} ({parse} parse): {mb / secs:.2f} MB/s of "
                  f"PCM (median of 3: {secs:.3f} s for {mb:.2f} MB; runs "
                  f"{', '.join(f'{r[0]:.3f}' for r in runs)}; in the median "
                  "run " + ", ".join(f"{k} {v:.1f} ms"
                                     for k, v in stages.items())
                  + f") on {card()}")

    # ---- 14. the residual-only and plan-tree encode paths, counted ----
    check_encode_modes(dev, (
        ("16-bit 44.1 kHz 120 s", pcm16, 44100, 16, data16),
        ("24-bit 96 kHz 20 s", pcm24, 96000, 24, data24)))

    # ---- 15. batch sharding over a device list ----
    check_mesh(dev, pcm16, data16, streams)

    # ---- 16. encode rate in each mode ----
    mb = len(pcm16) * 2 / 1e6
    for mode, kw in (("frame-packed", {}),
                     *((m, v[0]) for m, v in ENCODE_MODES.items())):
        runs = []
        for _ in range(3):
            open(trace_path, "w").close()
            t = time.perf_counter()
            encode_port(pcm16, 44100, 16, "f64", dev, **kw)
            runs.append((time.perf_counter() - t,
                         stage_ms(trace_path, ENCODE_STAGES)))
        secs, stages = sorted(runs, key=lambda r: r[0])[1]
        print(f"encode f64 {mode}: {mb / secs:.2f} MB/s of PCM (median of "
              f"3: {secs:.3f} s for {mb:.2f} MB; runs "
              f"{', '.join(f'{r[0]:.3f}' for r in runs)}; in the median run "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
              + f") on {card()}")

    # ---- 17. CUDA graphs against eager planning ----
    compare_graphs(dev, pcm16, trace_path)

    # ---- 18. decode graphs against eager decode ----
    compare_decode_graphs(dev, (("16-bit 120 s", data16, pcm16, 2),
                                ("24-bit 20 s", data24, pcm24, 3)),
                          trace_path)

    # ---- 19. the device fuzzer on the card, counted ----
    check_fuzz(root, dev)

    # ---- 20. memory across a mixed library ----
    mixed_library(dev)

    # ---- 21. a mesh with the device parse asked for ----
    check_mesh_device_parse(dev, data16, pcm16)

    # ---- 22. the JAX call shapes on the card, and the native flavors ----
    check_jax_call_shapes(dev, root, pcm16, pcm24, data16)
    native_flavors(data16)

    # ---- 23. the benchmark's sections on the card, counted ----
    check_bench(dev, root)

    # ---- 24. the encode-step profiler's three modes ----
    check_profile(dev, root)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "kernel_ms", "call_ms", "profiler_ms", "plain_ms",
            "plain_timer", "bound_ms", "bound_by", "bytes_ms",
            "operations_ms", "smem_ms", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
