"""Pipeline stage tracing for the port.

Set ``FLAC_TPU_TRACE=1`` to log per-batch stage timings (encode dispatch /
download / md5 / assemble, decode parse / reconstruct) to stderr, or
``FLAC_TPU_TRACE=/path/file.jsonl`` to append one JSON object per stage
event instead.  Set ``FLAC_TPU_PROFILE_DIR=/path`` to capture a
``torch.profiler`` trace for the lifetime of each batch pipeline: a Chrome
trace at ``$FLAC_TPU_PROFILE_DIR/<label>/trace.json``.

Zero overhead when disabled: ``stage()`` returns a no-op context manager.
The stage timer reads the host clock; stages that launch device work
without waiting for it measure the enqueue, not the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

_MODE = os.environ.get("FLAC_TPU_TRACE", "")


def enabled() -> bool:
    return bool(_MODE)


class _StageTimer:
    __slots__ = ("name", "meta", "t0")

    def __init__(self, name: str, meta: dict):
        self.name = name
        self.meta = meta

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        emit(self.name, time.perf_counter() - self.t0, **self.meta)


@contextlib.contextmanager
def _noop():
    yield


def stage(name: str, **meta):
    """Context manager timing one pipeline stage (no-op when disabled)."""
    if not _MODE:
        return _noop()
    return _StageTimer(name, meta)


def emit(name: str, seconds: float, **meta) -> None:
    """Record one stage event."""
    if not _MODE:
        return
    rec = {"stage": name, "ms": round(seconds * 1e3, 3), **meta}
    if _MODE == "1":
        print(f"[flac-tpu-trace] {rec['stage']}: {rec['ms']} ms "
              + " ".join(f"{k}={v}" for k, v in meta.items()),
              file=sys.stderr)
    else:
        with open(_MODE, "a") as fp:
            fp.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def profiler_session(label: str):
    """torch.profiler capture (CPU, plus CUDA when present) for the
    lifetime of the block when FLAC_TPU_PROFILE_DIR is set; no-op
    otherwise."""
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
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
