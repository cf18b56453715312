"""CUDA graph capture: the port's counterpart of a ``jax.jit`` executable.

The JAX package jits its device functions, so each configuration
(shapes and static arguments) is traced and compiled once, and every
later call runs the compiled executable.  On CUDA the port captures the
same function once as a ``torch.cuda.CUDAGraph`` over static input and
output tensors, and each later call copies its inputs into the static
input and replays the graph: one host call in place of the function's
hundreds of kernel launches.

:class:`CapturedGraph` is the capture procedure every graph of the port
shares (the encoder's ``ops.encode_batch.PlanGraph``, the decoder's
``ops.framescan.ParseGraph`` and ``parallel.batch_decode.
ReconstructGraph``).

Memory.  An XLA executable takes its temporaries from one allocator at
each call and gives them back when the call ends, so a JAX process
holds about its largest configuration's memory, however many it has
met.  Every graph captured on one (device, stream) therefore captures
into that stream's one memory pool (:func:`stream_pool`, a
``torch.cuda.MemPool``): graphs on one stream never run at once, so
their temporaries can share memory, and the pool holds about the
largest graph's temporaries plus every graph's static outputs, not the
sum of private pools.  A pool is released only when every graph of its
stream has been dropped; the stream's next capture makes a new one.

The eager warm-up before each capture runs inside the same pool
(``torch.cuda.use_mem_pool``), so its temporaries come from the free
blocks that earlier captures left, go back to them, and serve the
capture that follows: a process peaks near its largest configuration,
as a JAX process does, and not at a warm-up's worth above its pool.

Two invariants make the sharing safe.

1. Another graph's replay on the same stream may reuse a graph's
   temporaries, and so may overwrite its static output.  Every read of a
   static output is therefore queued on the graph's stream before that
   stream's next replay of any graph.  The readers, each queued on the
   graph's stream right after its replay:

   - ``parallel.batch.BatchEncoder._dispatch_batch``: the copies of
     every plan leaf into the batch's pinned host buffers, then an event;
   - ``parallel.batch_decode._device_parse_batch``, the device-parse
     batch of both decoders: the parse graph's ``gate.tolist()``
     (synchronous), then the copies of ``parsed`` into the reconstruct
     graph's static input (``_replay_reconstruct``), before the
     reconstruct replay, then the caller's ``take`` of the real rows:
   - ``BatchDecoder._take``: the reconstruct output's ``clone()`` (or
     ``.to(home)``), which the consumer's stream waits for
     (``wait_stream``) and keeps (``record_stream``), for the device
     parse and for each shard of the host parse;
   - ``MultiStreamDecoder._batch``'s ``place``: the index copy of the
     reconstruct output's real rows into the call's padded output, which
     the consumer's stream waits for at the call's end;
   - ``chip_smoke.replay_ms`` and ``profile_batches`` replay one graph
     back to back and read no output.

2. Nothing allocated under the pool outlives the call that allocated it,
   except a graph's static output.  A pool's free blocks are the
   scratch of the graphs captured before, and each of their replays
   writes there, so a tensor that a warm-up left in the pool would be
   overwritten, silently.  So:

   - static inputs are made by ``make_input()`` before the warm-up
     enters the pool;
   - the device caches a call builds on first use and keeps
     (``ops.common.device_constant``, ``ops.lpc.window_array``,
     ``ops.framepack._crc_planes``) build their tensor through
     :func:`outside_pool`, which runs the build on a thread of its own:
     ``use_mem_pool`` routes only its own thread's allocations;
   - cuBLAS keeps a workspace per (handle, stream) from its first call
     there, so :func:`_warm_libraries` makes one small product on the
     stream before the warm-up enters the pool.

   The helper was chosen over a pre-pass that builds every constant of
   a configuration before its warm-up, because only running the
   function finds which constants it needs, and because on the card a
   tensor built on another thread inside ``use_mem_pool`` lands outside
   the pool.  ``tests/test_torch_cuda.py`` checks after each capture
   that every block still allocated in the pool is a static output.

A capture starts after ``torch.cuda.synchronize``, so neither its
warm-up nor the capture races a replay in flight.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import time
import weakref

import torch

from . import kernels
from .utils import trace

# each (device, stream)'s graph memory pool, a weak reference to its
# torch.cuda.MemPool: the stream's graphs hold the pool, so it lives as
# long as one of them, and a stream whose graphs have all been dropped
# gets a new pool
_POOLS: dict = {}

# each live pool's total, by (device, stream): the growth of
# memory_reserved its captures left (the pool, the graphs' static inputs
# and any constant they built)
POOL_BYTES: dict = {}

# the pool the current thread's allocations go to during a warm-up
_ROUTED = threading.local()

# each device's highest memory_reserved before a capture reset the peak
# (max_memory_reserved() folds it back in)
_PEAKS: dict = {}


def stream_pool(stream):
    """The ``torch.cuda.MemPool`` every graph captured on ``stream``
    shares, and every warm-up there allocates from."""
    key = (stream.device, stream.cuda_stream)
    pool = _POOLS[key]() if key in _POOLS else None
    if pool is None:
        pool = torch.cuda.MemPool()
        _POOLS[key] = weakref.ref(pool)
        POOL_BYTES[key] = 0
        weakref.finalize(pool, POOL_BYTES.pop, key, None)
    return pool


def outside_pool(build):
    """``build()``, with whatever it allocates taken from the ordinary
    caching allocator even during a warm-up, which routes its thread's
    allocations to a pool: there the build runs on a thread of its own.
    For a tensor that outlives the call that builds it (invariant 2 of
    the module docstring)."""
    if getattr(_ROUTED, "pool", None) is None:
        return build()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        return ex.submit(build).result()


@contextlib.contextmanager
def _in_pool(pool, device):
    """Route this thread's allocations on ``device`` to ``pool``."""
    with torch.cuda.use_mem_pool(pool, device):
        _ROUTED.pool = pool
        try:
            yield
        finally:
            _ROUTED.pool = None


def _warm_libraries(device) -> None:
    """One small matrix product on the current stream, outside any pool,
    so that cuBLAS's workspace for this thread's handle and the stream
    exists before a warm-up: made inside a pool, it would stay there."""
    x = torch.ones((2, 2), dtype=torch.float32, device=device)
    torch.mm(x, x)


def _card(device):
    """``device`` as a torch.device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def max_memory_reserved(device) -> int:
    """``torch.cuda.max_memory_reserved(device)`` since the caller's last
    :func:`reset_peak_memory_stats`, across the resets each capture
    makes to take its ``peak_bytes``."""
    return max(_PEAKS.get(_card(device), 0),
               torch.cuda.max_memory_reserved(device))


def reset_peak_memory_stats(device) -> None:
    """``torch.cuda.reset_peak_memory_stats(device)``, for
    :func:`max_memory_reserved`."""
    _PEAKS.pop(_card(device), None)
    torch.cuda.reset_peak_memory_stats(device)


class CapturedGraph:
    """``fn(input)`` captured once on ``stream`` as a CUDA graph, into the
    stream's shared memory pool (``pool``, :func:`stream_pool`), which it
    holds.

    ``make_input()`` builds the static input tensor on the stream's
    device, outside the pool.  One eager call on ``stream`` goes first,
    inside the pool (it builds the kernel library and warms every
    cached constant on that stream; its temporaries go back to the pool
    for the capture), then the capture, which runs nothing: the
    launches it would make are tallied (``kernels.launches_apart``) and
    counted at each replay.  A failed warm-up, capture or replay raises;
    nothing falls back to eager or to memory outside the pool.

    ``input`` and ``output`` are the static tensors; ``replays``,
    ``tally``, ``reserved_bytes`` (the growth of ``memory_reserved`` the
    warm-up and the capture left: what the shared pool grew by, the
    graph's input and any constant it built), ``peak_bytes``
    (``max_memory_reserved`` during them, less ``memory_reserved``
    before) and ``capture_seconds`` (warm-up and capture) describe it.
    The warm-up and capture are one ``graph.capture`` span (``kind``:
    the class's name; ``meta``, such as the shape, as the span's meta).
    """

    def __init__(self, fn, make_input, stream, **meta):
        dev = stream.device
        self.stream = stream
        self.replays = 0
        self.pool = stream_pool(stream)
        key = (dev, stream.cuda_stream)
        t0 = time.perf_counter()
        with (trace.stage("graph.capture", kind=type(self).__name__,
                          **meta),
              torch.cuda.device(dev), torch.cuda.stream(stream)):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            _PEAKS[_card(dev)] = max_memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reserved = torch.cuda.memory_reserved(dev)
            self.input = make_input()
            _warm_libraries(dev)
            with _in_pool(self.pool, dev):
                fn(self.input)
            self.graph = torch.cuda.CUDAGraph()
            with kernels.launches_apart() as self.tally:
                with torch.cuda.graph(self.graph, stream=stream,
                                      pool=self.pool.id):
                    self.output = fn(self.input)
            torch.cuda.synchronize(dev)
            self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.peak_bytes = torch.cuda.max_memory_reserved(dev) - reserved
        POOL_BYTES[key] += self.reserved_bytes
        self.capture_seconds = time.perf_counter() - t0

    def replay(self):
        """Run the graph on its stream, after whatever the caller queued
        there (the copies into ``input``), and return the static
        ``output``, which the next replay of any graph on the stream may
        overwrite: read it with work queued on the same stream before
        that."""
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        kernels.add_launches(self.tally)
        self.replays += 1
        return self.output
