"""The benchmark's files: the contract of ``BENCHMARK.json``, pieces
found by name, new pieces added as files alone, imports, and the runs
that must print no result."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import runner

ROOT = runner.ROOT
BENCH = runner.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    return runner.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def one_line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


@pytest.mark.parametrize("parked", [False, True],
                         ids=["as_it_is", "with_the_parked_cells"])
def test_benchmark_json_keeps_the_contract(parked):
    """BENCHMARK.json keeps the contract, and so it does with the parked
    cells' entries added back."""
    b = runner.with_parked(bench()) if parked else bench()
    assert set(b) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(b["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) == len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].split("/")[0] in b["paths"]
        assert all(NAME.match(k) for k in c["reduced"])
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert one_line(w["why"])
    assert {w["config"] for w in cells} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layer = {m["name"]: m for m in b["per_layer"]}
    assert 1 <= len(layer) == len(b["per_layer"]) <= 128
    assert not set(layer) & set(e2e)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
    for w in cells:
        mine = [m["name"] for m in runner.for_cell(b["end_to_end"], w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        moved = runner.for_cell(b["per_layer"], w["name"])
        assert moved and all(m["moves"] in mine for m in moved)


def test_every_piece_is_found_by_name():
    b = runner.with_parked(bench())
    for w in b["workloads"]:
        spec = runner.cell_spec(b, w["name"])
        assert spec.cfg["reduced"] == []
        assert os.path.exists(os.path.join(
            BENCH, "drivers", spec.traffic["driver"] + ".py"))
        for m in spec.per_layer:
            assert callable(runner.load_module("metrics", m["name"]).read)
    for m in b["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        assert os.path.exists(path) and PATH.match(
            os.path.relpath(path, ROOT))


def _modules(top):
    for base, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    yield path, ast.parse(fh.read())


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path, tree in _modules(BENCH):
        if os.sep + "tests" + os.sep in path:
            continue
        found = set(_imported(tree)) & {"jax", "jaxlib", "flax",
                                        "flac_codec_tpu"}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path, tree in _modules(os.path.join(BENCH, "reference")):
        found = set(_imported(tree)) & {"flac_codec_tpu_torch", "torch",
                                        "benchmark", "jax",
                                        "flac_codec_tpu"}
        assert not found, (path, found)


def test_the_import_check_compares_whole_names():
    tree = ast.parse("import flac_codec_tpu_torch.encode\n"
                     "from flac_codec_tpu.ops import x\nimport jaxlib\n")
    assert set(_imported(tree)) == {"flac_codec_tpu_torch", "flac_codec_tpu",
                                    "jaxlib"}
    sys.modules.setdefault("flac_codec_tpu_torch_probe", sys)
    try:
        assert "flac_codec_tpu_torch_probe" not in runner.forbidden_modules()
    finally:
        del sys.modules["flac_codec_tpu_torch_probe"]


NEW_METRIC = '''"""Frames the device parsed in the window (a driver counter)."""


def read(data):
    return float(data["counters"]["device_frames"])
'''


def test_new_pieces_are_added_as_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries in BENCHMARK.json) in a copy of the checkout are
    found and run by the harness, and no file that was there changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    os.symlink(os.path.join(ROOT, "flac_codec_tpu_torch"),
               copy / "flac_codec_tpu_torch")
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*")
              if p.is_file()}
    cfg = json.loads((copy / "benchmark/configs/cd16.json").read_text())
    cfg["source"] = "https://example.org/a-new-deployment"
    (copy / "benchmark/configs/cd16b.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "benchmark/traffic/decode_tracks.json")
                     .read_text())
    mix["track_seconds"] = 1.3
    (copy / "benchmark/traffic/decode_clips.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/decode.frames_count.py").write_text(NEW_METRIC)
    b = json.loads((copy / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "cd16b", "source": cfg["source"],
                         "file": "benchmark/configs/cd16b.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "cd16b.decode_clips", "config": "cd16b",
                           "traffic": "decode_clips", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "decode.frames_count", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "decode_mbps",
                           "workloads": ["cd16b.decode_clips"]})
    for m in b["end_to_end"]:
        if "cd16.decode" in m.get("workloads", []):
            m["workloads"].append("cd16b.decode_clips")
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    script = ("import sys; sys.path.insert(0, '.'); "
              "from benchmark.harness import runner; "
              "sys.exit(runner.main(sys.argv[1:], device='cpu', "
              "overrides={'cfg': {'batch_frames': 8}}, workers=2))")
    out = subprocess.run(
        [sys.executable, "-c", script, "--workload", "cd16b.decode_clips",
         "--seed", "7", "--seconds", "0.3", "--trace", "1"],
        cwd=copy, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["metrics"]["decode.frames_count"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before


def test_a_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cd16.decode",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result line."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    script = ("import sys; sys.path[0] = '.'; "
              "from benchmark.harness import runner; "
              "sys.exit(runner.main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-c", script, "--workload", "cd16.decode",
         "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert "correct" not in out.stdout


LOADS_JAX = """
import sys, types
sys.path.insert(0, ".")
from benchmark.harness import runner

real = runner.load_module


def load_jax():
    sys.modules["jax"] = types.ModuleType("jax")


def load(kind, name):
    module = real(kind, name)
    if WHERE == "metric" and kind == "metrics":
        read = module.read
        module.read = lambda data: (load_jax(), read(data))[1]
    if WHERE == "check" and kind == "drivers":
        check = module.Driver.check
        module.Driver.check = lambda self, records: (
            load_jax(), check(self, records))[1]
    return module


runner.load_module = load
sys.exit(runner.main(sys.argv[1:], device="cpu", workers=2, overrides={
    "cfg": {"batch_frames": 8}, "traffic": {"track_seconds": 1.3}}))
"""


@pytest.mark.parametrize("where", ["metric", "check"])
def test_a_run_that_loads_jax_after_the_window_prints_no_result(where):
    """A module named ``jax`` loaded after the window, in a per-layer
    metric's ``read`` or in the driver's check, ends the run with no
    result line."""
    script = f"WHERE = {where!r}\n" + LOADS_JAX
    out = subprocess.run(
        [sys.executable, "-c", script, "--workload", "cd16.decode",
         "--seed", "11", "--seconds", "0.3", "--trace",
         str(int(where == "metric"))],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "jax" in out.stderr.strip().splitlines()[-1], out.stderr[-3000:]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cd16.decode",
         "--seed", "2", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
