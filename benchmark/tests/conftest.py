"""Helpers of the benchmark's tests: a run of a cell at a tiny size on
the CPU, in this process."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a track of 1.3 s (13 whole frames at 44.1 kHz, 30 at 96 kHz, and a
# short last frame) in batches of 8 frames
TINY = {"traffic": {"track_seconds": 1.3, "lead_silence_s": 0.1,
                    "tail_silence_s": 0.3},
        "cfg": {"batch_frames": 8}}


@pytest.fixture
def tiny_main(capsys):
    """``tiny_main(cell, seed, control=False, trace=False, extra=None)``:
    the exit code, standard output and standard error of one run of
    ``cell`` on the CPU at the tiny size, with ``extra``'s values
    ({"cfg": {...}, "traffic": {...}}) over the cell's files' too."""
    from benchmark.harness import runner

    def run(cell, seed, control=False, trace=False, seconds=0.5,
            extra=None):
        capsys.readouterr()
        argv = ["--workload", cell, "--seed", str(seed), "--seconds",
                str(seconds), "--trace", str(int(trace)), "--control",
                str(int(control))]
        overrides = {k: dict(v) for k, v in TINY.items()}
        for part, values in (extra or {}).items():
            overrides[part].update(values)
        bench = runner.with_parked(runner.load_json(
            os.path.join(ROOT, "BENCHMARK.json")))
        rc = runner.main(argv, device="cpu", overrides=overrides, workers=2,
                         bench=bench)
        got = capsys.readouterr()
        return rc, got.out, got.err

    return run


@pytest.fixture
def tiny_run(tiny_main):
    """``tiny_run(cell, seed, control=False, trace=False, extra=None)``:
    the result line of one run of ``cell`` on the CPU at the tiny size."""
    def run(*args, **kwargs):
        rc, out, err = tiny_main(*args, **kwargs)
        assert rc == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])

    return run


@pytest.fixture
def cuda():
    """Skips a test where no CUDA card is present (decided here, never
    while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
