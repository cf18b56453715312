"""The benchmark's runner: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file the cell's
configuration names, its traffic mix in ``benchmark/traffic/<traffic>.json``,
the mix's driver in ``benchmark/drivers/<driver>.py`` and each per-layer
metric in ``benchmark/metrics/<metric>.py``.

A run: set-up (the driver makes the seeded pool and warms every shape
the cell meets), then a closed loop of requests until ``--seconds`` have
passed, the last request finished; the window is that whole time.  The
set-up time leaves out the seconds in which the plain reference encoded
the pool's streams, where a driver needs them before the window.  With
``--trace 1`` the program's stage spans are written to a file under
``TMPDIR`` through the whole run, and after the window a stretch of whole
requests runs under ``torch.profiler``.  Once the window has closed,
the device's peak memory is read, the allocator's cached blocks are
released, and every request is held against the plain reference.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
Just before that line is printed, a run that holds a module of ``jax``,
``jaxlib``, ``flax`` or the JAX package ends with no result instead.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

from . import devtrace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "flac_codec_tpu")
TRACE_PREFIX = "flac_tpu_bench_trace."


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time of
    the process against the boot clock)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rpartition(")")[2].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start / os.sysconf("SC_CLK_TCK"))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def for_cell(entries: list, cell: str) -> list:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def cell_spec(bench: dict, workload: str) -> SimpleNamespace:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json``): its entry,
    configuration, traffic mix and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return SimpleNamespace(
        cell=cell, cfg=load_json(os.path.join(ROOT, entry["file"])),
        traffic=load_json(os.path.join(BENCH, "traffic",
                                       cell["traffic"] + ".json")),
        end_to_end=for_cell(bench["end_to_end"], workload),
        per_layer=for_cell(bench["per_layer"], workload))


def with_parked(bench: dict) -> dict:
    """``bench`` (``BENCHMARK.json``) with the entries of every parked
    cell, ``benchmark/parked/<cell>.json``, added: a cell that runs and
    is held to the reference as any other, but that ``BENCHMARK.json``
    leaves out (``PERF.md`` says why)."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    folder = os.path.join(BENCH, "parked")
    for name in sorted(os.listdir(folder)):
        parked = load_json(os.path.join(folder, name))
        out["workloads"].append(parked["workload"])
        out["end_to_end"] += parked["end_to_end"]
        out["per_layer"] += parked["per_layer"]
    return out


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def cpu_seconds() -> float:
    """CPU seconds this process has used, all its threads, user and
    system."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def spans(path: str, start: int, end: int) -> dict:
    """{stage: [ms, ...]} of the stage events written to ``path`` between
    byte offsets ``start`` and ``end``."""
    out: dict = {}
    with open(path, "rb") as f:
        f.seek(start)
        for line in f.read(end - start).splitlines():
            rec = json.loads(line)
            out.setdefault(rec["stage"], []).append(rec["ms"])
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="run the cell's control (a lower precision or a "
                        "broken guarantee) in the program's place: "
                        "correct must come out false")
    return p.parse_args(argv)


def main(argv=None, *, device=None, overrides=None, workers=None,
         bench=None) -> int:
    """One run.  For tests only: ``device`` runs on that device without
    the look for a card, ``overrides`` ({"cfg": {...}, "traffic": {...}})
    changes the cell's files' values, ``workers`` sets the number of
    the reference's worker processes (else the host's cores, at most
    8), and ``bench`` stands in for ``BENCHMARK.json`` (a parked cell's
    entries added to it, ``benchmark/parked/``)."""
    args = parse_args(argv)
    spec = cell_spec(bench or load_json(os.path.join(ROOT, "BENCHMARK.json")),
                     args.workload)
    for part, values in (overrides or {}).items():
        getattr(spec, part).update(values)
    chips = spec.cell["chips"]

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"benchmark: the cell needs {chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda:0"
        log("card:", card())
    device = torch.device(device)
    cuda = device.type == "cuda"
    # the program's kernel caches stay inside the checkout, at fixed
    # paths (the CUDA and native builds go to flac_codec_tpu_torch/build/)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, "cache", "triton")
    trace_path = None
    if args.trace:
        if "flac_codec_tpu_torch.utils.trace" in sys.modules:
            raise RuntimeError("the program's trace module was imported "
                               "before FLAC_TPU_TRACE was set")
        # a file of this run's own under TMPDIR, so that two runs that
        # share TMPDIR do not write into one file
        fd, trace_path = tempfile.mkstemp(prefix=TRACE_PREFIX, suffix=".jsonl")
        os.close(fd)
        os.environ["FLAC_TPU_TRACE"] = trace_path
    ctx = SimpleNamespace(cfg=spec.cfg, traffic=spec.traffic, seed=args.seed,
                          device=device, control=bool(args.control),
                          workers=workers or min(os.cpu_count() or 1, 8),
                          reference_s=0.0, log=log)
    driver_mod = load_module("drivers", spec.traffic["driver"])
    metrics = {m["name"]: load_module("metrics", m["name"])
               for m in spec.per_layer} if args.trace else {}
    try:
        return _run(args, spec, ctx, driver_mod, metrics, trace_path, cuda)
    finally:
        if trace_path and os.path.exists(trace_path):
            os.remove(trace_path)


def _timed(driver, i: int) -> dict:
    try:
        return driver.request(i)
    except Exception:  # a request that raises is counted as failed
        log(f"request {i} raised:\n{traceback.format_exc()}")
        return {"raised": True}


def _run(args, spec, ctx, driver_mod, metrics, trace_path, cuda) -> int:
    import torch

    driver = driver_mod.Driver(ctx)
    if cuda:
        torch.cuda.synchronize()
    # the reference's own encoding of the pool is not set-up
    setup_s = process_seconds() - ctx.reference_s
    log(f"setup_s {setup_s:.3f} (the reference's {ctx.reference_s:.3f} s "
        "left out)")

    offset = os.path.getsize(trace_path) if trace_path else 0
    records = []
    cpu = cpu_seconds()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        records.append(_timed(driver, len(records)))
    window_s = time.perf_counter() - t0
    cpu = cpu_seconds() - cpu
    log(f"host over the window: {cpu:.3f} CPU seconds, "
        f"{cpu / window_s:.3f} cores")
    end = os.path.getsize(trace_path) if trace_path else 0
    peak = (torch.cuda.max_memory_reserved(ctx.device) if cuda else 0)
    lat = sorted(r["latency_s"] * 1e3 for r in records if "latency_s" in r)
    if lat:
        log(f"window {window_s:.3f} s, {len(records)} requests; latency ms "
            f"min {lat[0]:.1f} median {lat[len(lat) // 2]:.1f} "
            f"max {lat[-1]:.1f}")

    log(f"counters {driver.counters(records)}")
    stretch, dev, null_us = [], {}, None
    if args.trace and cuda:
        ranges = {}
        for module in metrics.values():
            ranges.update(getattr(module, "RANGES", {}))
        first = len(records)

        def stretch_fn():
            for j in range(ctx.traffic["profile_requests"]):
                stretch.append(_timed(driver, first + j))

        t1 = time.perf_counter()
        prof, names = devtrace.profile(stretch_fn, ranges)
        t2 = time.perf_counter()
        dev = devtrace.read(prof, list(ranges),
                            set(names) | set(driver_mod.PHASES))
        del prof
        log(f"profiled stretch: {len(stretch)} requests, {t2 - t1:.3f} s; "
            f"read in {time.perf_counter() - t2:.3f} s, "
            f"{dev.get('events')} device events")
        null_us = devtrace.null_graph_us()
        log(f"null graph: {null_us:.4f} us a kernel")

    if cuda:
        torch.cuda.empty_cache()  # the program's cached blocks, before the check
    checks = driver.check(records + stretch)
    failed = sum(map(driver.failed, records))
    correct = all(value <= limit for value, limit in checks.values())

    out = {}
    if args.trace:
        data = {"spans": spans(trace_path, offset, end) if trace_path else {},
                "counters": driver.counters(records), "stretch": dev,
                "work": driver.work(stretch), "cfg": ctx.cfg,
                "null_us": null_us}
        for m in spec.per_layer:
            module = metrics[m["name"]]
            value = module.read(data)
            if hasattr(module, "explain"):
                note = module.explain(data)
                if note:
                    log(f"{m['name']}: {note}")
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = driver.end_to_end(records, window_s)
        values["setup_s"] = setup_s
        log(f"end to end: {values}")
        for m in spec.end_to_end:
            if values.get(m["name"]) is not None:
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if cuda
              else ctx.device.type,
              "count": spec.cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": out, "device": device}
    if args.trace and dev:
        device["busy_s"] = dev["busy_s"]
        device["window_s"] = dev["window_s"]
        result["breakdown"] = {"device_ops": devtrace.top(dev["device_ops"]),
                               "idle_gaps": devtrace.top(dev["idle"])}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    found = forbidden_modules()
    if found:
        log("benchmark: modules that may not be loaded are loaded: "
            + ", ".join(found))
        return 3
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
