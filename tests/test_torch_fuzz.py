"""The port's round-trip fuzzer, ``tools/fuzz_roundtrip_torch.py``, on the
CPU.

* For seeds 0-19 it draws exactly the JAX tool's trials: the same
  configurations, options and signals, in host and device mode, so a
  failing seed replays in both tools.  Both tools run their own trial
  loops with the encoder swapped for one that records what it was given
  and stops the trial, so no encoder runs (``tools/fuzz_roundtrip.py``
  imports only numpy at its top level).
* Its device mode (``device="cpu"``: the kernels' plain versions) and
  its host mode pass seeded trials with no failure.
* It is not vacuous: an encoder that flips one byte of its output is
  reported, and ``main()`` returns 1.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import time

import numpy as np
import pytest

import flac_codec_tpu.encode as jencode
import flac_codec_tpu.parallel.batch as jbatch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jfuzz = _load("fuzz_roundtrip_jax", ROOT / "tools" / "fuzz_roundtrip.py")
tfuzz = _load("fuzz_roundtrip_port", ROOT / "tools" / "fuzz_roundtrip_torch.py")


class _Drawn(Exception):
    """Ends a trial once its draws are recorded."""


def _recorder(log: list):
    """An encoder class that records its arguments and the samples it is
    given, then raises :class:`_Drawn`."""

    class Recorder:
        def __init__(self, fp, opts, rate, bps, ch, total_samples=None,
                     **kw):
            kw.pop("device", None)
            self.entry = [dataclasses.asdict(opts), rate, bps, ch,
                          total_samples, kw]
            log.append(self.entry)

        def write(self, pcm):
            self.entry.append(np.array(pcm, copy=True))
            raise _Drawn

    return Recorder


def _draws(fuzz, mode: str, seed: int, capsys) -> list:
    """Run ``fuzz``'s ``mode`` loop for 5 trials on ``seed`` with the
    recording encoder; returns the lines it printed (a failure line with
    its config for each trial, then the count)."""
    rng = np.random.default_rng(seed)
    kw = {"device": "cpu"} if fuzz is tfuzz and mode == "device" else {}
    assert getattr(fuzz, f"fuzz_{mode}")(rng, time.time() + 600, 5,
                                         **kw) == 5
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("seed", range(20))
def test_draws_equal_the_jax_tools(seed, monkeypatch, capsys):
    """Seeds 0-19: every trial's configuration, options, signal and
    printed config line are the JAX tool's, in host and device mode."""
    for mode, cls in (("host", "FlacSampleWriter"),
                      ("device", "BatchEncoder")):
        jlog, tlog = [], []
        monkeypatch.setattr(jencode if mode == "host" else jbatch, cls,
                            _recorder(jlog))
        monkeypatch.setattr(tfuzz, cls, _recorder(tlog))
        jlines = _draws(jfuzz, mode, seed, capsys)
        tlines = _draws(tfuzz, mode, seed, capsys)
        assert tlines == jlines
        assert len(jlog) == len(tlog) == 5
        for j, t in zip(jlog, tlog):
            assert t[:-1] == j[:-1]
            assert t[-1].dtype == j[-1].dtype
            np.testing.assert_array_equal(t[-1], j[-1])


@pytest.mark.parametrize("kind", ["noise", "sine", "quiet", "steps",
                                  "wasted"])
@pytest.mark.parametrize("bps", [8, 16, 24, 32])
def test_make_signal_equals_the_jax_tools(kind, bps):
    a = jfuzz.make_signal(np.random.default_rng(bps), kind, bps, 999)
    b = tfuzz.make_signal(np.random.default_rng(bps), kind, bps, 999)
    assert b.dtype == a.dtype == np.int64
    np.testing.assert_array_equal(b, a)


def test_device_mode_on_the_cpu_passes(capsys):
    """Four seeded device-mode trials on the CPU: the f64 batch encoder
    writes the host encoder's bytes, and both parse paths and the host
    reader give back the input."""
    rng = np.random.default_rng(14)
    assert tfuzz.fuzz_device(rng, time.time() + 600, 4, device="cpu") == 0
    assert "device fuzz: 4 trials, 0 failures" in capsys.readouterr().out


def test_host_mode_passes(capsys):
    rng = np.random.default_rng(14)
    assert tfuzz.fuzz_host(rng, time.time() + 600, 4) == 0
    assert "host fuzz: 4 trials, 0 failures" in capsys.readouterr().out


def test_a_flipped_byte_is_reported(monkeypatch, capsys):
    """An encoder whose output has one byte flipped fails every trial,
    the failure names the trial's config, and ``main()`` returns 1."""

    class Flipping(tfuzz.BatchEncoder):
        def __init__(self, fp, *args, **kw):
            super().__init__(fp, *args, **kw)
            self.out = fp

        def finalize(self):
            super().finalize()
            with self.out.getbuffer() as view:
                view[len(view) // 2] ^= 0x10

    monkeypatch.setattr(tfuzz, "BatchEncoder", Flipping)
    rng = np.random.default_rng(14)
    assert tfuzz.fuzz_device(rng, time.time() + 600, 2, device="cpu") == 2
    out = capsys.readouterr().out
    assert out.count("FAIL trial") == 2
    assert "block=" in out and "f64 device/host stream parity" in out
    monkeypatch.setattr(tfuzz, "fuzz_device", functools.partial(
        tfuzz.fuzz_device, device="cpu"))
    argv = ["--device", "--seed", "14", "--trials", "1"]
    assert tfuzz.main(argv) == 1
    assert tfuzz.main(argv[1:]) == 0


def test_device_mode_without_cuda_raises(monkeypatch):
    """No fallback: without CUDA, the command line's --device raises
    before any trial."""
    monkeypatch.setattr(tfuzz.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfuzz.main(["--device", "--trials", "1", "--seed", "0"])
