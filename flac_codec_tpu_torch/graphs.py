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
into that stream's one memory pool (:func:`stream_pool`): graphs on one
stream never run at once, so their temporaries can share memory, and
the pool holds about the largest graph's temporaries plus every graph's
static outputs, not the sum of private pools.  A pool is released only
when every graph of its stream has been dropped.

The invariant this rests on: another graph's replay on the same stream
may reuse a graph's temporaries, and so may overwrite its static
output.  Every read of a static output is therefore queued on the
graph's stream before that stream's next replay of any graph.  The
readers, each queued on the graph's stream right after its replay:

- ``parallel.batch.BatchEncoder._dispatch_batch``: the copies of every
  plan leaf into the batch's pinned host buffers, then an event;
- ``parallel.batch_decode.BatchDecoder._read_batch_device_parse``: the
  parse graph's ``gate.tolist()`` (synchronous), then, in
  ``_reconstruct``, the copies of ``parsed`` into the reconstruct
  graph's static input, before the reconstruct replay;
- ``BatchDecoder._reconstruct``: the reconstruct output's ``clone()``
  (or ``.to(home)``), which the consumer's stream waits for
  (``wait_stream``) and keeps (``record_stream``);
- ``chip_smoke.replay_ms`` and ``profile_batches`` replay one graph back
  to back and read no output.

Static inputs stay out of the pools: ``make_input()`` runs outside the
capture, so each is an ordinary allocation.  A capture starts after
``torch.cuda.synchronize``, so it never races a replay in flight.
"""

from __future__ import annotations

import time
import weakref

import torch

from . import kernels

# each (device, stream)'s graph memory pool: [pool handle, its graphs
# (weak references)]; a stream whose graphs have all been dropped gets a
# new handle, since the old pool is released once its blocks are free
_POOLS: dict = {}

# each (device, stream)'s pool total: the growth of memory_reserved its
# captures left since the pool's first capture (the pool, the graphs'
# static inputs and any constant they built)
POOL_BYTES: dict = {}


def stream_pool(stream):
    """The memory pool handle every graph captured on ``stream``
    shares."""
    key = (stream.device, stream.cuda_stream)
    entry = _POOLS.get(key)
    if entry is None or not len(entry[1]):
        entry = _POOLS[key] = [torch.cuda.graph_pool_handle(),
                               weakref.WeakSet()]
        POOL_BYTES[key] = 0
    return entry[0]


class CapturedGraph:
    """``fn(input)`` captured once on ``stream`` as a CUDA graph, into the
    stream's shared memory pool (``pool``, :func:`stream_pool`).

    ``make_input()`` builds the static input tensor on the stream's
    device.  One eager call on ``stream`` goes first (it builds the
    kernel library and warms every library handle and cached constant on
    that stream), then the capture, which runs nothing: the
    launches it would make are tallied (``kernels.launches_apart``) and
    counted at each replay.  A failed capture or replay raises; nothing
    falls back to eager.

    ``input`` and ``output`` are the static tensors; ``replays``,
    ``tally``, ``reserved_bytes`` (the growth of ``memory_reserved`` the
    capture left: what the shared pool grew by, the graph's input and
    any constant it built) and ``capture_seconds`` (warm-up and capture)
    describe it.
    """

    def __init__(self, fn, make_input, stream):
        dev = stream.device
        self.stream = stream
        self.replays = 0
        self.pool = stream_pool(stream)
        key = (dev, stream.cuda_stream)
        t0 = time.perf_counter()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            self.input = make_input()
            fn(self.input)
            self.graph = torch.cuda.CUDAGraph()
            with kernels.launches_apart() as self.tally:
                with torch.cuda.graph(self.graph, stream=stream,
                                      pool=self.pool):
                    self.output = fn(self.input)
            torch.cuda.synchronize(dev)
            # the warm-up's blocks were returned by the capture's
            # empty_cache, so what is left is the graph's
            self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        _POOLS[key][1].add(self)
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
