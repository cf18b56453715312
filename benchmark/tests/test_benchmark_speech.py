"""The ``speech16.loader`` and ``cd16.decode_hostparse`` cells at a tiny
size on the CPU: ``correct`` true for a sound run and false for the
control and for a planted nonzero pad, the speech signal's seeding, and
the per-layer metrics a traced loader run reads (in a process of its
own: the runner sets ``FLAC_TPU_TRACE`` before the program is first
imported)."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark.tests.conftest import ROOT

# 4 utterances of 0.1-0.6 s in blocks of 1024 and batches of 4 frames;
# a loader step of at most 12,000 samples (2-4 utterances)
SPEECH = {"cfg": {"batch_frames": 4, "block_size": 1024},
          "traffic": {"pool_utterances": 4, "utterance_mean_s": 0.35,
                      "utterance_sd_s": 0.1, "utterance_min_s": 0.1,
                      "utterance_max_s": 0.6, "step_samples": 12000,
                      "profile_requests": 2}}
LOADER_METRICS = ("decode.open_ms", "decode.place_ms",
                  "decode.streams_per_batch", "decode.read_self_ms",
                  "decode.fill_ms", "decode.scan_ms", "decode.upload_ms",
                  "decode.gate_wait_ms", "decode.stage_wait_ms",
                  "decode.fallback_pct", "graph.captures")


def plant_nonzero_pad(monkeypatch):
    """A 1 written past the first utterance's length in each batch, once
    the timed requests start."""
    from benchmark.harness import runner
    from flac_codec_tpu_torch.parallel.batch_decode import MultiStreamDecoder

    armed = [False]
    real_timed, real_decode = runner._timed, MultiStreamDecoder.decode

    def timed(driver, i):
        armed[0] = True
        return real_timed(driver, i)

    def decode(self, sources):
        pcm, lengths = real_decode(self, sources)
        n = int(lengths[0])
        if armed[0] and n < pcm.shape[2]:
            pcm[0, 0, n] = 1
        return pcm, lengths

    monkeypatch.setattr(runner, "_timed", timed)
    monkeypatch.setattr(MultiStreamDecoder, "decode", decode)


@pytest.mark.parametrize("case,correct,check", [
    ("sound", True, None), ("control", False, "samples_differing"),
    ("nonzero_pad", False, "padding_nonzero")])
def test_loader_run_is_correct_or_caught(tiny_run, monkeypatch, case,
                                         correct, check):
    if case == "nonzero_pad":
        plant_nonzero_pad(monkeypatch)
    got = tiny_run("speech16.loader", 3100000001, control=case == "control",
                   extra=SPEECH)
    assert got["correct"] is correct
    assert set(got["checks"]) == {"samples_differing", "tracks_differing",
                                  "padding_nonzero"}
    if correct:
        assert got["attempted"] >= 1 and got["failed"] == 0
        assert all(c["value"] == 0 for c in got["checks"].values())
        assert set(got["metrics"]) == {"decode_mbps", "decode_p95_ms",
                                       "setup_s"}
    else:
        assert got["checks"][check]["value"] > 0 and got["failed"] >= 1


def test_the_speech_signal_is_seeded():
    """One seed gives one utterance; another seed another.  Peak at 0.5
    of full scale, and a noise floor under the pauses: no run of 64
    zero samples."""
    from benchmark.harness import speech

    a, b, c = (speech.utterance(0.8, 16000, 16, seed, "cpu", -70)
               for seed in (2**40 + 5, 2**40 + 5, 2**40 + 6))
    assert a.shape == (1, 12800) and a.dtype.is_signed
    assert np.array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    x = a.numpy()[0]
    assert abs(np.abs(x).max() - 0.5 * 32767) < 0.01 * 32767
    edges = np.flatnonzero(np.diff(np.r_[0, x == 0, 0]))
    assert (edges[1::2] - edges[::2]).max(initial=0) < 64


def test_hostparse_cell_runs_correct(tiny_run):
    got = tiny_run("cd16.decode_hostparse", 3100000002)
    assert got["correct"] is True and got["failed"] == 0


SCRIPT = ("import sys; sys.path.insert(0, '.'); "
          "from benchmark.harness import runner; "
          f"sys.exit(runner.main(sys.argv[1:], device='cpu', "
          f"overrides={SPEECH!r}, workers=2))")


def test_a_traced_loader_run_prints_its_span_and_counter_metrics():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, "--workload", "speech16.loader",
         "--seed", "3100000003", "--seconds", "0.3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    metrics = got["metrics"]
    assert set(LOADER_METRICS) <= set(metrics)
    assert all(metrics[m]["value"] is not None for m in LOADER_METRICS)
    assert metrics["decode.open_ms"]["value"] > 0
    assert metrics["decode.place_ms"]["value"] > 0
    # 2-4 utterances of 1-9 whole frames in batches of 4
    assert metrics["decode.streams_per_batch"]["value"] >= 1
    assert metrics["decode.fallback_pct"]["value"] == 0
    assert metrics["graph.captures"]["value"] == 0
