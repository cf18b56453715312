"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into a shared library with a plain C interface, which is loaded
with ``ctypes``.  The build lands in ``flac_codec_tpu_torch/build/
<hash>/``, keyed by a hash of the sources and flags, so a checkout builds
everything it needs from its own files and an edited source rebuilds.

Every C entry point takes device pointers, sizes and a CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
a nonzero code.  A failed build raises: there is no fallback to the plain
PyTorch versions for CUDA tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
LIB_NAME = "libflac_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None

# kernel launches, counted by each wrapper where it launches its kernel;
# a CUDA graph's kernels count at each replay (``add_launches``)
LAUNCHES = {"splice_subframes": 0, "pack_symbols": 0, "autocorr_levinson": 0,
            "predict_lpc": 0, "parse_frame_bodies": 0}

# what the last build did: seconds, library path, compiler output
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def launches_apart():
    """Count the launches made inside the block into the dict it yields
    instead of ``LAUNCHES``, which leaves the block as it entered.  For a
    CUDA graph capture: it enqueues kernels into the graph and runs none;
    ``add_launches(tally)`` counts them each time the graph runs."""
    before = dict(LAUNCHES)
    tally: dict = {}
    try:
        yield tally
    finally:
        for k, n in before.items():
            tally[k] = LAUNCHES[k] - n
            LAUNCHES[k] = n


def add_launches(tally: dict) -> None:
    """Count the launches of one replay of a graph whose capture
    ``launches_apart`` tallied."""
    for k, n in tally.items():
        LAUNCHES[k] += n


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of flac_codec_tpu_torch cannot be built")
    return found


def _build() -> str:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    out_dir = os.path.join(BUILD, h.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        BUILD_INFO.update(seconds=0.0, path=lib, cached=True, log="")
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    # one compiler per source, all at once; then one link
    objs, procs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{pid}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log += " ".join(cmd) + "\n" + out
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode})")
    tmp = f"{lib}.{pid}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{log}")
    os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
    BUILD_INFO.update(seconds=secs, path=lib, cached=False, log=log)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.flac_splice_subframes.argtypes = [ptr, ptr, ptr, i32, i32,
                                                  i32, i32, ptr]
            lib.flac_splice_subframes.restype = i32
            lib.flac_pack_symbols.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                              i32, i32, i32, ptr]
            lib.flac_pack_symbols.restype = i32
            lib.flac_autocorr_levinson.argtypes = [ptr, ptr, ptr, ptr, i32,
                                                   i32, i32, ptr]
            lib.flac_autocorr_levinson.restype = i32
            lib.flac_autocorr_levinson_tiles.argtypes = [ptr, ptr, ptr, ptr,
                                                         i32, i32, i32, i32,
                                                         ptr]
            lib.flac_autocorr_levinson_tiles.restype = i32
            lib.flac_predict_lpc.argtypes = [ptr, ptr, i32, ptr, ptr, ptr,
                                             i32, i32, i32, ptr, ptr]
            lib.flac_predict_lpc.restype = i32
            lib.flac_parse_frames.argtypes = [ptr, ctypes.c_longlong, ptr,
                                              ptr, ptr, i32, i32, i32, i32,
                                              ptr, ptr, ptr, ptr, ptr, ptr,
                                              ptr]
            lib.flac_parse_frames.restype = i32
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")


def check_inputs(name: str, tensors: dict, dtypes: dict):
    """Check a wrapper's tensors: one device (CPU or CUDA), the expected
    dtypes, contiguous.  Returns the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices: "
                         + ", ".join(f"{k}={t.device}"
                                     for k, t in tensors.items()))
    for k, t in tensors.items():
        if t.dtype != dtypes[k]:
            raise TypeError(f"{name}: {k} must be {dtypes[k]}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def launch(name: str, fn, *args, device) -> None:
    """Call C entry point ``fn`` on ``device``'s current stream, raise on
    a CUDA error, and count the launch."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        code = fn(*args, stream)
    check(code, name)
    LAUNCHES[name] += 1
