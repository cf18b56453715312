"""Device lists for frame-batch sharding.

Counterpart of ``flac_codec_tpu/parallel/mesh.py``.  The JAX package
shards the frame-batch axis over a 1-D ``jax.sharding.Mesh``; here a
mesh is a tuple of ``torch.device`` and a batch is dealt out as one
contiguous chunk of frames per entry.  Per-frame work is independent, so
no collective crosses devices: each shard runs on its own device and
stream, and the host gathers the finished shards in order.

A device may be listed more than once: one card listed twice runs two
shards on two streams of that card, which is how a single card (and the
CPU, with ``["cpu"] * k``) exercises the split.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch


def batch_mesh(devices: Optional[Sequence] = None) -> tuple:
    """A tuple of ``torch.device``: every visible CUDA device by default,
    or the given devices (names or ``torch.device``, repeats allowed).
    A CUDA device without CUDA raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("batch_mesh(): CUDA is not available")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"batch_mesh(): {d} needs CUDA, which "
                                   "is not available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        elif d.type != "cpu":
            raise ValueError(f"batch_mesh(): unsupported device {d}")
        mesh.append(d)
    if not mesh:
        raise ValueError("batch_mesh(): no devices")
    return tuple(mesh)


# the process's shard streams, by (device, how many times the device was
# listed before): made at first use, then reused by every encoder and
# decoder, so a configuration's CUDA graphs (keyed by stream) are too
_STREAMS: dict = {}


def shard_streams(mesh: Sequence[torch.device]) -> list:
    """A stream per CUDA entry of ``mesh`` (None for the CPU): the k-th
    entry naming a device gets the process's k-th shard stream of that
    device, so entries never share a stream, and a device listed once
    always gets the same stream."""
    out = []
    for i, d in enumerate(mesh):
        if d.type != "cuda":
            out.append(None)
            continue
        key = (d, mesh[:i].count(d))
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device=d)
        out.append(_STREAMS[key])
    return out


@contextlib.contextmanager
def on_stream(stream):
    """Make ``stream`` (and its device) current; None does nothing."""
    if stream is None:
        yield
        return
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def shard_batch(mesh: Sequence[torch.device], x: torch.Tensor,
                streams=None) -> list:
    """The leading axis of ``x`` cut into one contiguous chunk per mesh
    entry (``torch.tensor_split``, so the length need not divide), each
    chunk copied to its device — on its entry of ``streams`` when given.
    Copies from pinned host memory do not block the host."""
    streams = streams or [None] * len(mesh)
    out = []
    for d, s, chunk in zip(mesh, streams, torch.tensor_split(x, len(mesh))):
        with on_stream(s):
            out.append(chunk.to(d, non_blocking=True))
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
