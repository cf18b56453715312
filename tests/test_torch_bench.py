"""``bench_torch.py``, the port's benchmark, on the CPU at small sizes.

It must keep ``bench.py``'s output contract (the headline line first,
the final line last with the same metric and value, every section's
keys), report a failed or skipped section instead of dropping it, read
``bench.py``'s ``FLAC_TPU_BENCH_*`` variables with their defaults, make
``bench.py``'s signal and decode stream, and run with jax and the JAX
package refused.  ``bench.py`` itself is read with ``ast``, never
imported: importing it configures jax for the process.
"""

import ast
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_PY = ROOT / "bench.py"
STREAM_3S = ROOT / ".bench_cache" / "bench_p8_3s_seed3.flac"
CPU = torch.device("cpu")

# a small run: 2-frame batches, chains of 2, a 3 s decode stream decoded
# 8 frames a batch, 1 s through the encoder
SMALL = {"FLAC_TPU_BENCH_BATCH": "2", "FLAC_TPU_BENCH_CHAIN": "2",
         "FLAC_TPU_BENCH_REPS": "3", "FLAC_TPU_BENCH_DEC_SECONDS": "3",
         "FLAC_TPU_BENCH_DEC_BATCH": "8", "FLAC_TPU_BENCH_SECONDS": "1"}

# bench.py's environment variables and the Config field each sets
FIELDS = {"BATCH": "batch_frames", "ANALYSIS": "analysis", "REPS": "reps",
          "CHAIN": "chain", "SCAN": "scan",
          "DISPATCH_FORM": "dispatch_form", "MODES": "modes",
          "DECODE": "decode", "DEC_SECONDS": "dec_seconds",
          "DEC_BATCH": "dec_batch", "E2E": "e2e", "SECONDS": "seconds"}

# run bench_torch.py as a script in a process whose import system refuses
# jax, jaxlib and the JAX package, and check none of them loaded
REFUSING_RUNNER = """
import importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flac_codec_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code
loaded = [k for k, v in sys.modules.items() if v is not None
          and k.split(".")[0] in ("jax", "jaxlib", "flac_codec_tpu")]
assert not loaded, loaded
sys.exit(code)
"""


def _bench_py():
    return ast.parse(BENCH_PY.read_text(), str(BENCH_PY))


def _bench_py_env() -> dict:
    """Every ``os.environ.get("FLAC_TPU_BENCH_*", default)`` of bench.py."""
    out = {}
    for node in ast.walk(_bench_py()):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "get"
                and len(node.args) == 2
                and all(isinstance(a, ast.Constant) for a in node.args)
                and str(node.args[0].value).startswith("FLAC_TPU_BENCH_")):
            out[node.args[0].value[len("FLAC_TPU_BENCH_"):]] = \
                node.args[1].value
    return out


def _bench_py_function(name: str):
    """A function of bench.py, compiled from its source alone."""
    fn = next(n for n in _bench_py().body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(BENCH_PY),
                 "exec"), namespace)
    return namespace[name]


def _positive(v) -> bool:
    if isinstance(v, dict):
        return bool(v) and all(_positive(x) for x in v.values())
    return isinstance(v, (int, float)) and math.isfinite(v) and v > 0


def _quiet_env(monkeypatch, **env):
    for k in list(os.environ):
        if k.startswith("FLAC_TPU_BENCH_"):
            monkeypatch.delenv(k)
    for k, v in {**SMALL, "FLAC_TPU_BENCH_DEADLINE": "1e6", **env}.items():
        monkeypatch.setenv(k, v)


def test_bench_contract_on_cpu():
    """The whole bench with --device cpu at a small size, jax refused:
    the headline first and alone, every section's keys positive in the
    final line, which has the headline's metric and value, nothing
    failed, skipped or turned off, exit code 0."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FLAC_TPU_BENCH_")}
    env.update(SMALL, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", REFUSING_RUNNER,
         str(ROOT / "bench_torch.py"), "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    first, last = lines[0], lines[-1]
    assert first["metric"] == "pcm_encode_mbps_preset8"
    assert first["unit"] == "MB/s/chip" and first["batch_frames"] == 2
    assert _positive(first["value"]) and _positive(first["device_step_ms"])
    assert first["vs_baseline"] == pytest.approx(first["value"] / 1000)
    assert first["card"] is None and first["power_limit_w"] is None
    assert not set(first) & (set(bench_torch.KEYS) - {"value",
                                                       "device_step_ms"})
    assert (last["metric"], last["value"]) == (first["metric"],
                                                first["value"])
    for key in bench_torch.KEYS:
        assert _positive(last.get(key)), (key, last.get(key))
    threads = [str(n) for n in bench_torch.thread_counts()]
    assert list(last["decode_mbps_by_threads"]) == threads
    assert list(last["assemble_packed_mbps_by_threads"]) == threads
    assert last["compression_ratio_preset8"] == round(
        STREAM_3S.stat().st_size / (32 * 4096 * 4), 4)
    assert (last["errors"], last["skipped"], last["disabled"]) == ({}, {},
                                                                   [])
    assert list(last["launches"]) == [s[0] for s in bench_torch.sections(
        bench_torch.Config())]
    assert all(not n for n in last["launches"].values())  # CPU: no kernel
    assert last["pool_mib"] == 0 and last["bench_seconds"] > 0


def test_section_failure_is_reported_after_the_headline(monkeypatch,
                                                         capsys):
    """A section that raises lands under errors with its type and
    message, the sections after it still run, and main returns 1; the
    headline was printed first."""
    _quiet_env(monkeypatch, FLAC_TPU_BENCH_MODES="0",
               FLAC_TPU_BENCH_DECODE="0", FLAC_TPU_BENCH_DISPATCH_FORM="0")

    def fail(dev, cfg):
        raise RuntimeError("forced")

    monkeypatch.setattr(bench_torch, "end_to_end", fail)
    assert bench_torch.main(["--device", "cpu"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    assert _positive(lines[0]["value"]) and "errors" not in lines[0]
    last = lines[-1]
    assert last["value"] == lines[0]["value"]
    assert last["errors"] == {"end_to_end": "RuntimeError: forced"}
    assert "end_to_end_mbps" not in last
    assert last["skipped"] == {}
    assert last["disabled"] == ["dispatch", "f64", "24bit", "stream",
                                "decode_device_step", "decode_host",
                                "decode_pipeline",
                                "decode_pipeline_device_parse", "assemble"]


def test_headline_failure_prints_one_line_and_fails(monkeypatch, capsys):
    """A headline that raises: one line, with no value and the error,
    exit code 1, and no later section run."""
    _quiet_env(monkeypatch, FLAC_TPU_BENCH_ANALYSIS="f16")
    assert bench_torch.main(["--device", "cpu"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1
    assert lines[0]["metric"] == "pcm_encode_mbps_preset8"
    assert lines[0]["value"] is None
    assert list(lines[0]["errors"]) == ["headline"]
    assert list(lines[0]["launches"]) == ["headline"]


def test_deadline_skips_sections_by_name():
    """With a minute left after the headline, every later section is
    skipped and named with its reason; nothing fails."""
    lines = []
    cfg = bench_torch.Config(batch_frames=2, chain=2, cache_dir=None)
    out, rc = bench_torch.run(CPU, cfg, time.time() + 60, emit=lines.append)
    assert rc == 0 and out["errors"] == {}
    assert lines[0]["value"] == out["value"] and len(lines) == 2
    names = [s[0] for s in bench_torch.sections(cfg)]
    assert list(out["skipped"]) == names[1:]
    assert out["skipped"]["decode_host"].startswith("no decode stream")
    assert out["skipped"]["end_to_end"].startswith("deadline: ")


def test_config_reads_bench_py_variables():
    """config() reads every FLAC_TPU_BENCH_* variable bench.py reads,
    with bench.py's default, and each one sets its field."""
    env = _bench_py_env()
    assert env.pop("DEADLINE") == "1200"
    assert '"FLAC_TPU_BENCH_DEADLINE", "1200"' in (
        ROOT / "bench_torch.py").read_text()
    assert set(env) == set(FIELDS)
    default = bench_torch.config({})
    for name, value in env.items():
        field = FIELDS[name]
        got = getattr(default, field)
        assert got == (value != "0" if isinstance(got, bool)
                       else type(got)(value)), name
        other = "0" if isinstance(got, bool) else (
            "f64" if field == "analysis" else "7")
        changed = getattr(bench_torch.config(
            {f"FLAC_TPU_BENCH_{name}": other}), field)
        assert changed != got, name


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [1, 1000, 4096 * 3])
def test_make_audio_is_bench_py_s(seed, n):
    want = _bench_py_function("make_audio")(n, seed)
    got = bench_torch.make_audio(n, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bench_stream_is_the_tracked_stream():
    """The 3 s decode stream the port's f64 BatchEncoder makes is
    bench.py's, which its host encoder made and the repo tracks."""
    got = bench_torch.bench_stream(CPU, 3, cache_dir=None)
    assert got == STREAM_3S.read_bytes()


def test_bench_stream_cache(tmp_path):
    """The stream is written to the cache directory and read back from
    it."""
    first = bench_torch.bench_stream(CPU, 1, cache_dir=str(tmp_path))
    path = tmp_path / "bench_p8_1s_seed3.flac"
    assert path.read_bytes() == first
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    path.write_bytes(b"cached")
    assert bench_torch.bench_stream(CPU, 1, cache_dir=str(tmp_path)) == \
        b"cached"


def test_without_gpu_exits_nonzero_and_prints_no_result():
    """Without CUDA and without --device cpu the bench refuses: exit 1,
    nothing on standard output, no fallback to the CPU."""
    assert not torch.cuda.is_available()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "needs a CUDA GPU" in proc.stderr


def test_plan_step_on_cpu_is_the_encoders_plan():
    """The bench's plan step plans what BatchEncoder plans: its frames'
    bytes, assembled, are the encoder's for the same batch."""
    from flac_codec_tpu_torch import metadata
    from flac_codec_tpu_torch.convert import plan_to_numpy
    from flac_codec_tpu_torch.parallel.batch import (BatchEncoder,
                                                     assemble_frames)

    opts = bench_torch.options()
    pcm, = bench_torch.encode_batches(2, opts.block_size, 16, 1)
    step, stream = bench_torch.plan_step(CPU, 2, "f64", 16)
    assert stream is None
    plan = plan_to_numpy(step(torch.from_numpy(pcm)))
    si = metadata.Streaminfo(
        minimum_block_size=opts.block_size,
        maximum_block_size=opts.block_size, sample_rate=44100, channels=2,
        bits_per_sample=16, total_samples=2 * opts.block_size)
    frames, _ = assemble_frames(plan, pcm.astype(np.int32), si, 0,
                                fallback_options=opts)
    buf = io.BytesIO()
    enc = BatchEncoder(buf, opts, 44100, 16, 2,
                       total_samples=2 * opts.block_size, batch_frames=2,
                       analysis="f64", device="cpu")
    enc.write(pcm.transpose(0, 2, 1).reshape(-1).astype(np.int32))
    enc.finalize()
    assert buf.getvalue().endswith(b"".join(frames))
