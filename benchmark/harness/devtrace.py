"""What the traced run reads from ``torch.profiler``.

A stretch of whole requests runs under the profiler with two kinds of
host ranges (``torch.profiler.record_function``) set by the benchmark:

* graph ranges: each per-layer metric file may name, in ``RANGES``, a
  ``"module:Class.method"`` of the program whose calls are one layer's
  device work (a CUDA graph's replay); every call is wrapped in a range
  of the metric's label for the stretch, and put back afterwards;
* host ranges: the program's stage spans (``utils.trace.stage``) and the
  benchmark's own request phases, so that an idle gap of the device can
  be named by what the host was doing.

A device event (kernel, copy, set) is attributed to the innermost graph
range around the CUDA runtime call that launched it: the host event whose
id is the device event's correlation id (the pattern of
``tools/profile_encode_torch.attribute`` at commit be3fb28).  Only device
events count towards the busy time; the device-side spans the profiler
draws for ranges carry their labels' names and are skipped.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib

# the program's stage-span API, wrapped so that its spans are also
# profiler ranges
SPAN_API = ("flac_codec_tpu_torch.utils.trace", "stage")
STRETCH = "bench.stretch"


def _resolve(target: str):
    """``"module:Class.attr"`` or ``"module:attr"`` -> (owner, attr), or
    None where the program has no such attribute."""
    mod_name, _, path = target.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError:
        return None
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name, None)
        if owner is None:
            return None
    return (owner, attr) if hasattr(owner, attr) else None


@contextlib.contextmanager
def wrapped(targets: dict):
    """Each ``{label: target}`` wrapped in a profiler range named
    ``label`` for the block; every attribute is put back on exit."""
    import torch

    saved = []
    try:
        for label, target in targets.items():
            found = _resolve(target)
            if found is None:
                continue
            owner, attr = found
            own = attr in vars(owner)
            fn = getattr(owner, attr)

            def ranged(*args, _fn=fn, _label=label, **kwargs):
                with torch.profiler.record_function(_label):
                    return _fn(*args, **kwargs)

            saved.append((owner, attr, own, vars(owner).get(attr)))
            setattr(owner, attr, ranged)
        yield
    finally:
        for owner, attr, own, old in reversed(saved):
            if own:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


@contextlib.contextmanager
def span_ranges():
    """The program's stage spans as profiler ranges too, for the block;
    yields the set of the stage names met."""
    import torch

    names: set = set()
    found = _resolve(":".join(SPAN_API))
    if found is None:
        yield names
        return
    owner, attr = found
    stage = getattr(owner, attr)

    @contextlib.contextmanager
    def ranged(name, **meta):
        names.add(name)
        with torch.profiler.record_function(name), stage(name, **meta):
            yield

    setattr(owner, attr, ranged)
    try:
        yield names
    finally:
        setattr(owner, attr, stage)


def profile(fn, ranges: dict):
    """``fn()`` under the profiler with ``ranges`` (``{label: target}``)
    and the stage spans as ranges, synchronised; returns the profiler and
    the stage names met."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with wrapped(ranges), span_ranges() as names, torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
    return prof, names


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(prof, graph_labels, host_labels) -> dict:
    """The stretch's device numbers: ``busy_s`` (union of device events),
    ``window_s`` (the stretch's range), ``graphs`` ({label: {"us": device
    us attributed, "calls": ranges}}), ``device_ops`` (device seconds by
    event name) and ``idle`` (idle seconds by the innermost host range
    over each gap's middle; "host (no range)" where none)."""
    from torch.autograd import DeviceType

    labels = set(graph_labels) | set(host_labels) | {STRETCH}
    runtime, device, ranges = {}, [], []
    window = None
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in labels:
                device.append(e)
        elif e.name == STRETCH:
            window = (e.time_range.start, e.time_range.end)
        elif e.name in labels:
            ranges.append(e)
        elif e.name.startswith("cu"):
            runtime[e.id] = e
    if window is None:
        return {}
    graphs = {label: {"us": 0.0, "calls": 0} for label in graph_labels}
    for e in ranges:
        if e.name in graphs:
            graphs[e.name]["calls"] += 1
    ops: dict = {}
    spans = []
    for e in device:
        us = e.time_range.elapsed_us()
        ops[e.name] = ops.get(e.name, 0.0) + us / 1e6
        spans.append((e.time_range.start, e.time_range.end))
        node = runtime.get(e.id)
        while node is not None and node.name not in graphs:
            node = node.cpu_parent
        if node is not None:
            graphs[node.name]["us"] += us
    busy = _merge(spans)
    lo, hi = window
    busy_us = sum(min(b, hi) - max(a, lo) for a, b in busy if b > lo and a < hi)
    # idle gaps inside the window, named by the host range around each
    # gap's middle (the innermost: the latest to start)
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in ranges if e.name in host_labels),
                  key=lambda r: r[0])
    starts = [r[0] for r in host]
    idle: dict = {}
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "host (no range)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
            "graphs": graphs, "device_ops": ops, "idle": idle,
            "events": len(device)}


def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` largest entries of ``{name: seconds}``, names cut to
    ``width`` characters."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def null_graph_us(kernels: int = 1000, replays: int = 20) -> float:
    """Device us a kernel of a CUDA graph of ``kernels`` in-place adds on
    32 elements, timed by CUDA events over ``replays`` replays: the
    card's floor a kernel inside a graph."""
    import torch

    x = torch.zeros(32, device="cuda")
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        for _ in range(3):
            x.add_(1)
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(kernels):
                x.add_(1)
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        for _ in range(replays):
            graph.replay()
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (kernels * replays)
