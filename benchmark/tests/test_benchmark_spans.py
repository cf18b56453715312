"""The per-layer metrics that read the program's decode spans
(``decode.read.self``, ``decode.fill``, ``decode.gate_wait``,
``decode.stage_wait``, ``graph.capture``) in a traced run on the CPU, in
a process of its own: the runner sets ``FLAC_TPU_TRACE`` before the
program is first imported."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT, TINY

SPAN_METRICS = ("decode.read_self_ms", "decode.fill_ms",
                "decode.gate_wait_ms", "decode.stage_wait_ms",
                "graph.captures")
SCRIPT = ("import sys; sys.path.insert(0, '.'); "
          "from benchmark.harness import runner; "
          f"sys.exit(runner.main(sys.argv[1:], device='cpu', "
          f"overrides={TINY!r}, workers=2))")


@pytest.mark.parametrize("cell", ["cd16.decode", "hires24.decode"])
def test_a_traced_decode_run_prints_the_span_metrics(cell):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, "--workload", cell, "--seed",
         "2200000017", "--seconds", "0.3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    metrics = got["metrics"]
    assert set(SPAN_METRICS) <= set(metrics)
    # the CPU captures no graph
    assert metrics["graph.captures"] == {"value": 0, "unit": "count"}
    for name in SPAN_METRICS[:-1]:
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] >= 0
    assert metrics["decode.fill_ms"]["value"] > 0
