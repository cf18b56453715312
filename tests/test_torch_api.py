"""The port's public surface, held to the JAX package's.

* The constructors and the device CLIs take the JAX package's positional
  parameters, name for name and place for place; the port's own
  ``device`` and ``graphs`` (``device`` and ``device_parse`` of
  ``convert_one``) are keyword-only.
* ``flac_codec_tpu_torch`` exports the JAX package's top-level names
  (``errors``, ``FlacError`` and 13 lazy ones), and ``ops`` and
  ``parallel`` its subpackages' lists, each as the port's own object;
  importing the package and resolving the lazy names loads neither
  ``torch`` nor the native engine.
* The JAX call shapes work: ``BatchDecoder(f, 256, None, True)`` and
  ``BatchEncoder(..., 64, None, "f64")`` on the CPU give the JAX
  package's PCM and ``FlacSampleWriter``'s bytes.
"""

import ast
import inspect
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import flac_codec_tpu_torch
from flac_codec_tpu import encode as jencode
from flac_codec_tpu.cli import flac2wav as jf2w
from flac_codec_tpu.cli import wav2flac as jw2f
from flac_codec_tpu.parallel import batch as jbatch
from flac_codec_tpu.parallel import batch_decode as jbd
from flac_codec_tpu_torch import encode as tencode
from flac_codec_tpu_torch.cli import flac2wav as tf2w
from flac_codec_tpu_torch.cli import wav2flac as tw2f
from flac_codec_tpu_torch.parallel import batch as tbatch
from flac_codec_tpu_torch.parallel import batch_decode as tbd

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)

# name: (the JAX function, the port's)
SIGNATURES = {
    "BatchEncoder": (jbatch.BatchEncoder.__init__,
                     tbatch.BatchEncoder.__init__),
    "BatchDecoder": (jbd.BatchDecoder.__init__, tbd.BatchDecoder.__init__),
    "convert_one": (jf2w.convert_one, tf2w.convert_one),
    "convert_one_tpu": (jf2w.convert_one_tpu, tf2w.convert_one_tpu),
    "flac2wav.main": (jf2w.main, tf2w.main),
    "wav2flac.main": (jw2f.main, tw2f.main),
    "add_common_args": (jw2f.add_common_args, tw2f.add_common_args),
    "build_options": (jw2f.build_options, tw2f.build_options),
}
# the port's keyword-only parameters and their defaults
KEYWORD_ONLY = {
    "BatchEncoder": {"device": "cuda", "graphs": True},
    "BatchDecoder": {"device": "cuda", "graphs": True},
    "convert_one": {"device": "cuda", "device_parse": False},
    "convert_one_tpu": {"device": "cuda", "device_parse": False},
}
# positional defaults the port changes on purpose: the port's convert_one
# decodes on the device unless asked for the host
DEFAULTS_CHANGED = {("convert_one", "tpu"): (False, True)}


def _params(fn, kinds):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind in kinds]


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_positional_parameters_match_jax(name):
    jfn, tfn = SIGNATURES[name]
    jpos, tpos = _params(jfn, POSITIONAL), _params(tfn, POSITIONAL)
    assert [p.name for p in tpos] == [p.name for p in jpos]
    for jp, tp in zip(jpos, tpos):
        want = DEFAULTS_CHANGED.get((name, tp.name))
        if want is None:
            assert tp.default == jp.default, tp.name
        else:
            assert (jp.default, tp.default) == want, tp.name
    assert not _params(jfn, (inspect.Parameter.VAR_POSITIONAL,))
    assert not _params(tfn, (inspect.Parameter.VAR_POSITIONAL,))
    kwonly = _params(tfn, (inspect.Parameter.KEYWORD_ONLY,))
    assert {p.name: p.default for p in kwonly} == KEYWORD_ONLY.get(name, {})


def test_common_args_hold_the_jax_flags():
    """The port's ``add_common_args`` takes every JAX flag (``--tpu``
    included) and adds ``--device`` and ``--analysis``; only
    ``--batch-frames``' default differs (256 against 64)."""
    import argparse

    parsers = []
    for module in (jw2f, tw2f):
        p = argparse.ArgumentParser()
        module.add_common_args(p)
        parsers.append({a.dest: a for a in p._actions if a.dest != "help"})
    jflags, tflags = parsers
    assert set(tflags) == set(jflags) | {"device", "analysis"}
    for dest, action in jflags.items():
        assert tflags[dest].option_strings == action.option_strings
        default = (64, 256) if dest == "batch_frames" else \
            (action.default,) * 2
        assert (action.default, tflags[dest].default) == default, dest


def _init_names(path: pathlib.Path, *, lazy: bool) -> list:
    """The names a JAX ``__init__.py`` imports, and with ``lazy`` the keys
    of its ``__getattr__`` table."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif lazy and isinstance(node, ast.Dict):
            names += [k.value for k in node.keys]
    return names


JAX_PKG = ROOT / "flac_codec_tpu"
TOP = _init_names(JAX_PKG / "__init__.py", lazy=True)
SUB = [(sub, name) for sub in ("ops", "parallel")
       for name in _init_names(JAX_PKG / sub / "__init__.py", lazy=False)]


def _home(obj) -> str:
    return obj.__name__ if inspect.ismodule(obj) else obj.__module__


def test_export_lists_are_the_jax_packages():
    assert len(TOP) == 15 and {"errors", "FlacError", "FlacSampleWriter",
                               "BlockList"} <= set(TOP)
    assert sorted(SUB) == sorted(
        [("ops", n) for n in ("decorrelate", "fixed", "lpc", "rice",
                              "encode_frames_plan")]
        + [("parallel", n) for n in ("BatchEncoder", "assemble_frames",
                                     "batch_mesh", "shard_batch")])


@pytest.mark.parametrize("name", TOP)
def test_top_level_name_is_the_ports_own(name):
    import flac_codec_tpu

    obj = getattr(flac_codec_tpu_torch, name)
    assert _home(obj).startswith("flac_codec_tpu_torch"), _home(obj)
    ref = getattr(flac_codec_tpu, name)
    assert type(obj) is type(ref)
    assert _home(obj).replace("flac_codec_tpu_torch", "flac_codec_tpu",
                              1) == _home(ref)


@pytest.mark.parametrize("sub,name", SUB)
def test_subpackage_export_is_the_ports_own(sub, name):
    import importlib

    obj = getattr(importlib.import_module(f"flac_codec_tpu_torch.{sub}"),
                  name)
    assert _home(obj).startswith(f"flac_codec_tpu_torch.{sub}"), _home(obj)


def test_unknown_top_level_name_raises():
    with pytest.raises(AttributeError, match="no_such_name"):
        flac_codec_tpu_torch.no_such_name


def test_package_import_stays_light():
    """Importing the package and resolving every lazy name, in a process
    where jax and the JAX package cannot be imported, loads neither
    ``torch`` nor the native engine (so builds nothing)."""
    code = f"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flac_codec_tpu"):
            raise ImportError(f"{{name}} is blocked")
        return None

sys.meta_path.insert(0, Refuse())
import flac_codec_tpu_torch as pkg
for name in {TOP!r}:
    getattr(pkg, name)
assert pkg.FlacSampleWriter.__module__ == "flac_codec_tpu_torch.encode"
assert "torch" not in sys.modules, "torch was imported"
assert "flac_codec_tpu_torch.native" not in sys.modules
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _clip(n, channels=2, seed=16):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.stack([3000 * np.sin(t * (0.011 + 0.003 * c))
                     + rng.integers(-120, 120, n) for c in range(channels)],
                    axis=1).reshape(-1).astype(np.int32)


N = 256 * 9 + 37
OPTS = dict(block_size=256)


def _host_stream(inter):
    buf = io.BytesIO()
    w = tencode.FlacSampleWriter(buf, tencode.Options(**OPTS), 44100, 16,
                                 2, total_samples=N)
    w.write(inter)
    w.finalize()
    return buf.getvalue()


@pytest.mark.parametrize("device_parse", [None, False, True])
def test_positional_batch_decoder_matches_jax(device_parse):
    """``BatchDecoder(f, 256, None, device_parse)`` in both packages: the
    same PCM, and the port parses on the device only for ``True``."""
    inter = _clip(N)
    data = _host_stream(inter)
    jdec = jbd.BatchDecoder(io.BytesIO(data), 256, None, device_parse)
    want = np.asarray(jdec.read_all_device(), dtype=np.int64)
    jdec.close()
    with tbd.BatchDecoder(io.BytesIO(data), 256, None, device_parse,
                          device="cpu") as dec:
        assert (dec.batch_frames, dec.mesh) == (256, None)
        assert dec._device_parse is bool(device_parse)
        got = dec.read_all_device().numpy().astype(np.int64)
        assert dec.parse_fallbacks == int(bool(device_parse))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(-1), inter)


def test_positional_batch_decoder_mesh():
    """The third positional parameter is the mesh."""
    inter = _clip(N)
    with tbd.BatchDecoder(io.BytesIO(_host_stream(inter)), 4,
                          ["cpu", "cpu"]) as dec:
        assert dec.mesh == (torch.device("cpu"),) * 2
        got = dec.read_all_device().numpy().reshape(-1)
    np.testing.assert_array_equal(got, inter)


# positional (pack_budget, frame_pack) after (batch_frames, mesh,
# analysis), and the mode they select: (pack_budget, frame_pack)
MODES = {
    "frame_packed": ((), (18, True)),
    "plan_tree": ((0,), (0, False)),
    "residual_only": ((None, False), (18, False)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_positional_batch_encoder_writes_host_bytes(mode):
    """``BatchEncoder(..., 64, None, "f64", *mode)`` on the CPU writes
    ``FlacSampleWriter``'s bytes, and the JAX encoder's for the same
    positional call."""
    extra, want_mode = MODES[mode]
    inter = _clip(N)
    buf = io.BytesIO()
    enc = tbatch.BatchEncoder(buf, tencode.Options(**OPTS), 44100, 16, 2,
                              N, 64, None, "f64", *extra, device="cpu")
    assert (enc.batch_frames, enc.mesh, enc.analysis) == (64, None, "f64")
    assert (enc.pack_budget, enc.frame_pack) == want_mode
    enc.write(inter)
    enc.finalize()
    assert buf.getvalue() == _host_stream(inter)
    if mode == "frame_packed":
        jbuf = io.BytesIO()
        jenc = jbatch.BatchEncoder(jbuf, jencode.Options(**OPTS), 44100, 16,
                                   2, N, 64, None, "f64")
        jenc.write(inter)
        jenc.finalize()
        assert buf.getvalue() == jbuf.getvalue()
        jw = io.BytesIO()
        w = jencode.FlacSampleWriter(jw, jencode.Options(**OPTS), 44100, 16, 2,
                            total_samples=N)
        w.write(inter)
        w.finalize()
        assert jw.getvalue() == jbuf.getvalue()


def test_positional_batch_encoder_mesh():
    """The eighth positional parameter is the mesh."""
    inter = _clip(N)
    buf = io.BytesIO()
    enc = tbatch.BatchEncoder(buf, tencode.Options(**OPTS), 44100, 16, 2,
                              N, 4, ["cpu", "cpu"], "f64")
    assert enc.mesh == (torch.device("cpu"),) * 2
    enc.write(inter)
    enc.finalize()
    assert buf.getvalue() == _host_stream(inter)


def test_convert_one_host_and_device_write_the_jax_bytes(tmp_path):
    """``convert_one(p, o, False)`` decodes on the host, and
    ``convert_one(p, o, device="cpu")`` and ``convert_one_tpu`` on the
    device path; each writes the WAV of the JAX ``convert_one(p, o)``."""
    src = str(tmp_path / "a.flac")
    with open(src, "wb") as f:
        f.write(_host_stream(_clip(N)))
    want = str(tmp_path / "jax.wav")
    jf2w.convert_one(src, want)
    for name, run in (
            ("host", lambda o: tf2w.convert_one(src, o, False)),
            ("device", lambda o: tf2w.convert_one(src, o, device="cpu")),
            ("tpu", lambda o: tf2w.convert_one_tpu(src, o, device="cpu"))):
        out = str(tmp_path / f"{name}.wav")
        assert run(out) == out
        with open(out, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read(), name
