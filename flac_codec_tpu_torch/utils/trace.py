"""Pipeline stage tracing for the port: an in-memory span recorder.

Set ``FLAC_TPU_TRACE=1`` to log each stage span to stderr as it ends
(encode dispatch / download / md5 / assemble, decode read / scan /
upload / parse / reconstruct and their waits), or
``FLAC_TPU_TRACE=/path/file.jsonl`` to keep the spans in memory and
append them to the file, one JSON object a line.  The file is written in
one ``open`` and one write by :func:`flush`: when a ``BatchDecoder``
closes, when a ``BatchEncoder`` finalizes (or leaves its ``with`` block on
an error), and at interpreter exit; never once a span.  Set
``FLAC_TPU_PROFILE_DIR=/path`` to capture a ``torch.profiler`` trace for
the lifetime of each batch pipeline: a Chrome trace at
``$FLAC_TPU_PROFILE_DIR/<label>/trace-<request id>.json``, one file a
pipeline; while such a session runs, every stage span is also a
``torch.profiler.record_function`` range of its name, so the trace shows
the program's spans beside the kernels.

Span sites call ``trace.stage(name, **meta)`` as an attribute of this
module and use no value that ``with`` yields: a profiler harness may
replace ``stage`` with a wrapper that opens a range around the span.
A span's parent is the innermost span open on the same thread.  Its
request id is the ``req=`` meta, else its parent's: ``BatchDecoder`` and
``BatchEncoder`` each take one (:func:`new_request`) at construction.

A record holds ``stage`` (the span's name) and ``ms`` (its duration),
as before, and beside them ``self_ms`` (``ms`` less what its direct
children covered), ``start_ns`` and ``end_ns`` (unix ns on the clock
that ``torch.profiler`` stamps its events with, ``CLOCK_REALTIME``:
``time.perf_counter_ns()`` plus one offset to ``time.time_ns()`` taken
at import), ``id``, ``parent`` (None at the top) and ``req``, then the
site's meta (given to ``stage``, or to :func:`note` inside the span).
A span opened with ``self_record=True`` also writes a record
``<name>.self`` whose ``ms`` is its self time (``span``: its id), for
readers that take the mean ms of a stage.

Next to nothing when disabled: ``stage()`` returns one shared no-op
context manager.  Times are the host's clock; a stage that launches
device work without waiting for it measures the enqueue, not the device.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time

_MODE = os.environ.get("FLAC_TPU_TRACE", "")
# the unix ns of perf_counter_ns()'s zero
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()

_open = threading.local()        # .spans: this thread's open spans
_records: collections.deque = collections.deque()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_sessions = 0                    # profiler sessions running
_lock = threading.Lock()         # flushes and _sessions


def enabled() -> bool:
    return bool(_MODE)


def new_request() -> int:
    """A process-wide serial for one pipeline's spans (``req=``)."""
    return next(_request_ids)


_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "meta", "req", "flush", "self_record", "id",
                 "parent", "t0", "t1", "child_ns", "range")

    def __init__(self, name: str, meta: dict):
        self.name = name
        self.req = meta.pop("req", None)
        self.flush = meta.pop("flush", False)
        self.self_record = meta.pop("self_record", False)
        self.meta = meta

    def __enter__(self):
        stack = getattr(_open, "spans", None)
        if stack is None:
            stack = _open.spans = []
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.req is None and parent is not None:
            self.req = parent.req
        self.id = next(_span_ids)
        self.child_ns = 0
        self.range = None
        if _sessions:
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.t1 = t1 = time.perf_counter_ns()
        stack = _open.spans
        if stack and stack[-1] is self:
            stack.pop()
        if self.parent is not None:
            self.parent.child_ns += t1 - self.t0
        if _MODE == "1":
            for rec in _records_of(self):
                print(f"[flac-tpu-trace] {rec['stage']}: {rec['ms']} ms "
                      + " ".join(f"{k}={v}" for k, v in self.meta.items()),
                      file=sys.stderr)
        else:
            _records.append(self)
            if self.flush:
                flush()
        if self.range is not None:
            self.range.__exit__(*exc)
        return None


def _records_of(span: _Span) -> list:
    """The records of an ended span: its own, and its ``.self`` record
    where it was opened with ``self_record=True``."""
    ns = span.t1 - span.t0
    self_ms = round((ns - span.child_ns) / 1e6, 3)
    parent = span.parent
    out = [{"stage": span.name, "ms": round(ns / 1e6, 3), "self_ms": self_ms,
            "start_ns": span.t0 + _EPOCH_NS, "end_ns": span.t1 + _EPOCH_NS,
            "id": span.id, "parent": None if parent is None else parent.id,
            "req": span.req, **span.meta}]
    if span.self_record:
        out.append({"stage": span.name + ".self", "ms": self_ms,
                    "span": span.id, "req": span.req})
    return out


def stage(name: str, **meta):
    """Context manager timing one pipeline stage as a span (the shared
    no-op when tracing and the profiler session are both off).  ``req``
    is the request id; ``self_record=True`` adds the ``<name>.self``
    record; ``flush=True`` flushes the records, the span's own included,
    as the span ends (inside a profiler range around it)."""
    if _MODE:
        return _Span(name, meta)
    if _sessions:
        import torch

        return torch.profiler.record_function(name)
    return _NOOP


def note(name: str, **meta) -> None:
    """Add ``meta`` to the span ``name``, which must be the innermost open
    on this thread, for what a site learns only inside its span (nothing
    when tracing is off)."""
    if _MODE:
        stack = getattr(_open, "spans", None)
        assert stack and stack[-1].name == name, (name, stack)
        stack[-1].meta.update(meta)


def flush() -> None:
    """Append the records of the spans ended since the last flush to the
    ``FLAC_TPU_TRACE`` file, in one open and one write (nothing when
    there are none)."""
    with _lock:
        n = len(_records)
        if not n:
            return
        lines = "".join(json.dumps(rec) + "\n" for _ in range(n)
                        for rec in _records_of(_records.popleft()))
        with open(_MODE, "a") as fp:
            fp.write(lines)


if _MODE and _MODE != "1":
    atexit.register(flush)


@contextlib.contextmanager
def profiler_session(label: str, req: int):
    """torch.profiler capture (CPU, plus CUDA when present) for the
    lifetime of the block when FLAC_TPU_PROFILE_DIR is set, written to
    ``<label>/trace-<req>.json`` under it; no-op otherwise."""
    global _sessions
    root = os.environ.get("FLAC_TPU_PROFILE_DIR", "")
    if not root:
        yield
        return
    import torch

    path = os.path.join(root, label)
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with _lock:
            _sessions += 1
        try:
            yield
        finally:
            with _lock:
                _sessions -= 1
    prof.export_chrome_trace(os.path.join(path, f"trace-{req}.json"))
