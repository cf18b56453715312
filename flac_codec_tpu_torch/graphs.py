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
"""

from __future__ import annotations

import time

import torch

from . import kernels


class CapturedGraph:
    """``fn(input)`` captured once on ``stream`` as a CUDA graph.

    ``make_input()`` builds the static input tensor on the stream's
    device.  One eager call on ``stream`` goes first (it builds the
    kernel library and warms every library handle and cached constant on
    that stream), then the capture, which runs nothing: the
    launches it would make are tallied (``kernels.launches_apart``) and
    counted at each replay.  A failed capture or replay raises; nothing
    falls back to eager.

    ``input`` and ``output`` are the static tensors; ``replays``,
    ``tally``, ``reserved_bytes`` (the growth of ``memory_reserved`` the
    capture left: the graph's private pool, its input and any constant
    it built) and ``capture_seconds`` (warm-up and capture) describe it.
    """

    def __init__(self, fn, make_input, stream):
        dev = stream.device
        self.stream = stream
        self.replays = 0
        t0 = time.perf_counter()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            self.input = make_input()
            fn(self.input)
            self.graph = torch.cuda.CUDAGraph()
            with kernels.launches_apart() as self.tally:
                with torch.cuda.graph(self.graph, stream=stream):
                    self.output = fn(self.input)
            torch.cuda.synchronize(dev)
            # the warm-up's blocks were returned by the capture's
            # empty_cache, so what is left is the graph's
            self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_seconds = time.perf_counter() - t0

    def replay(self):
        """Run the graph on its stream, after whatever the caller queued
        there (the copies into ``input``), and return the static
        ``output``, which the next replay overwrites: read it with work
        queued on the same stream."""
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        kernels.add_launches(self.tally)
        self.replays += 1
        return self.output
