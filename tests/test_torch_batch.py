"""The port's whole encode slice on the CPU, and its isolation from JAX.

``flac_codec_tpu_torch.parallel.batch.BatchEncoder(device="cpu",
analysis="f64")`` must write the same bytes as the JAX package's
``BatchEncoder`` and as the sequential host encoder ``FlacSampleWriter``.
In f32 analysis the stream must decode losslessly with a matching MD5.
"""

import ast
import io
import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from flac_codec_tpu.decode import FlacSampleReader, Verified, verify
from flac_codec_tpu.encode import FlacSampleWriter, Options
from flac_codec_tpu.parallel.batch import BatchEncoder as JaxBatchEncoder
from flac_codec_tpu_torch import native
from flac_codec_tpu_torch.parallel import batch as tbatch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "flac_codec_tpu_torch"


def _music(rng, n, channels, bps):
    t = np.arange(n)
    amp = 1 << (bps - 3)
    return np.stack([amp * np.sin(t * (0.01 + 0.004 * c))
                     + rng.integers(-(amp >> 6), amp >> 6, n)
                     for c in range(channels)]).T.reshape(-1).astype(np.int32)


def _encode(cls, inter, opts, rate, bps, channels, total, **kw):
    buf = io.BytesIO()
    enc = cls(buf, opts, rate, bps, channels, total_samples=total, **kw)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue(), enc


# name: (options, rate, bps, channels, frames + extra samples, signal, total)
_CASES = {
    "stereo16_block1024": (Options(block_size=1024), 44100, 16, 2,
                           (6, 123), "music", True),
    "stereo16_fast": (Options.fast(), 44100, 16, 2, (5, 77), "music", True),
    "stereo24_rice2": (Options(block_size=1024), 96000, 24, 2, (4, 0),
                       "noise", True),
    "mono16": (Options(block_size=512), 44100, 16, 1, (4, 100), "music",
               True),
    "stereo16_verbatim": (Options(block_size=512), 44100, 16, 2, (5, 0),
                          "noise", True),
    "stereo16_unknown_total": (Options(block_size=1024), 44100, 16, 2,
                               (5, 100), "music", False),
}


def _input(name, rng):
    opts, rate, bps, channels, (frames, extra), kind, _ = _CASES[name]
    n = opts.block_size * frames + extra
    if kind == "noise":
        lim = 1 << (bps - 1) if name.endswith("verbatim") else 1 << (bps - 2)
        return rng.integers(-lim, lim, channels * n).astype(np.int32), n
    return _music(rng, n, channels, bps), n


@pytest.mark.parametrize("case", sorted(_CASES))
def test_batch_encoder_bytes_match_jax_and_host(case):
    opts, rate, bps, channels, _, _, with_total = _CASES[case]
    inter, n = _input(case, np.random.default_rng(21))
    total = n if with_total else None
    host, _ = _encode(FlacSampleWriter, inter, opts, rate, bps, channels,
                      total)
    jaxb, _ = _encode(JaxBatchEncoder, inter, opts, rate, bps, channels,
                      total, batch_frames=2, analysis="f64")
    port, enc = _encode(tbatch.BatchEncoder, inter, opts, rate, bps,
                        channels, total, batch_frames=2, analysis="f64",
                        device="cpu")
    assert jaxb == host
    assert port == host
    assert enc.device_frames == len(inter) // channels // opts.block_size
    if case.endswith("verbatim"):
        assert enc.fallback_frames > 0


def test_batch_encoder_packs_frames_the_jax_packer_cannot():
    """32-bit bursts coded as Rice k=30 overflow the JAX one-hot chunk
    window, so the JAX package re-encodes those frames on the host; the
    port packs them on the device, byte-identical to the host encoder."""
    rng = np.random.default_rng(22)
    n = 2048 * 2
    x = rng.integers(-3, 4, (n, 2))
    for f in range(2):
        x[f * 2048 + 64:f * 2048 + 576] = rng.integers(
            -(1 << 31), 1 << 31, (512, 2))
    inter = x.reshape(-1).astype(np.int32)
    opts = Options(block_size=2048, max_partition_order=4)
    host, _ = _encode(FlacSampleWriter, inter, opts, 96000, 32, 2, n)
    port, enc = _encode(tbatch.BatchEncoder, inter, opts, 96000, 32, 2, n,
                        batch_frames=2, analysis="f64", device="cpu")
    assert port == host
    assert enc.device_frames == 2 and enc.fallback_frames == 0


@pytest.mark.parametrize("bps,rate", [(16, 44100), (24, 96000)])
def test_batch_encoder_f32_is_lossless(bps, rate):
    rng = np.random.default_rng(23)
    opts = Options(block_size=1024)
    n = 1024 * 5 + 300
    inter = _music(rng, n, 2, bps)
    data, _ = _encode(tbatch.BatchEncoder, inter, opts, rate, bps, 2, n,
                      batch_frames=2, analysis="f32", device="cpu")
    assert verify(io.BytesIO(data)) == Verified.MD5_MATCH
    with FlacSampleReader(io.BytesIO(data)) as r:
        np.testing.assert_array_equal(r.read(2 * n), inter)


def _write_wav(path, inter, rate, channels, bps=16):
    data = inter.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate,
                                      rate * channels * bps // 8,
                                      channels * bps // 8, bps))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def test_cli_wav2flac_matches_host_cli(tmp_path):
    from flac_codec_tpu.cli import wav2flac as host_cli
    from flac_codec_tpu_torch.cli import main as port_main

    rng = np.random.default_rng(24)
    wav = tmp_path / "in.wav"
    _write_wav(wav, _music(rng, 1024 * 3 + 50, 2, 16), 44100, 2)
    host_out, port_out = tmp_path / "host.flac", tmp_path / "port.flac"
    assert host_cli.main([str(wav), str(host_out), "--block-size",
                          "1024"]) == 0
    assert port_main(["wav2flac", str(wav), str(port_out), "--block-size",
                      "1024", "--device", "cpu", "--analysis", "f64"]) == 0
    assert port_out.read_bytes() == host_out.read_bytes()


def test_profiler_session_writes_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("FLAC_TPU_PROFILE_DIR", str(tmp_path))
    rng = np.random.default_rng(25)
    inter = _music(rng, 512 * 2, 2, 16)
    encoders = [_encode(tbatch.BatchEncoder, inter, Options(block_size=512),
                        44100, 16, 2, 1024, device="cpu")[1]
                for _ in range(2)]
    # one file a pipeline, named by its request id, with the program's
    # stage spans as ranges beside the operators
    names = {f"trace-{enc.request_id}.json" for enc in encoders}
    assert len(names) == 2
    assert {p.name for p in (tmp_path / "batch-encode").iterdir()} == names
    for name in names:
        with open(tmp_path / "batch-encode" / name) as f:
            events = json.load(f)["traceEvents"]
        assert {"encode.dispatch", "encode.assemble"} <= {
            e.get("name") for e in events}


def test_batch_encoder_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.BatchEncoder(io.BytesIO(), Options(), 44100, 16, 2,
                            device="cuda")


def test_batch_encoder_refuses_missing_native(tmp_path, monkeypatch):
    """A native engine that does not build stops the encoder; nothing
    falls back to a pure-Python path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS", ("-O3", "-shared", "-fPIC",
                                              "--no-such-flag"))
    with pytest.raises(RuntimeError, match="building the native engine"):
        tbatch.BatchEncoder(io.BytesIO(), Options(), 44100, 16, 2,
                            device="cpu")


_FORBIDDEN = ("jax", "jaxlib", "flac_codec_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


def test_port_sources_never_import_jax():
    """No module of the port, not chip_smoke.py or bench_torch.py, and
    none of the port's tools (``tools/fuzz_roundtrip_torch.py``,
    ``tools/bench_*.py``, ``tools/chain_latency.py``,
    ``tools/profile_encode_torch.py``) imports jax, jaxlib
    or any module of the JAX package ``flac_codec_tpu``: no import
    statement, relative or absolute, and no ``import_module`` or
    ``__import__`` call, names one."""
    tools = ROOT / "tools"
    port_tools = ([tools / "fuzz_roundtrip_torch.py",
                   tools / "chain_latency.py",
                   tools / "profile_encode_torch.py"]
                  + sorted(tools.glob("bench_*.py")))
    assert len(port_tools) >= 7 and all(p.is_file() for p in port_tools)
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                            ROOT / "bench_torch.py"]
             + port_tools)
    assert len(files) > 40
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr",
                              getattr(node.func, "id", None))
                  in ("import_module", "__import__")):
                names = [node.args[0].value]
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_port_runs_with_jax_blocked():
    """In a process where jax, jaxlib and every module of the JAX package
    fail to import: import bench_torch.py, tools/profile_encode_torch.py
    and every module of the port,
    encode with the port's BatchEncoder and its own FlacSampleWriter
    (each also resolved through the package's exports), and decode the
    result with the port's BatchDecoder, with the host parse and with the
    device parse."""
    code = """
import importlib, importlib.abc, io, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flac_codec_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Refuse())
import os
import numpy as np
import bench_torch
sys.path.insert(0, os.path.join(os.path.dirname(bench_torch.__file__),
                                "tools"))
import profile_encode_torch
import flac_codec_tpu_torch
for m in pkgutil.walk_packages(flac_codec_tpu_torch.__path__,
                               "flac_codec_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
for name in ("jax", "flac_codec_tpu", "flac_codec_tpu.encode"):
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise AssertionError(f"{name} was not blocked")
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.parallel.batch import BatchEncoder
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder
assert flac_codec_tpu_torch.FlacSampleWriter is FlacSampleWriter
assert flac_codec_tpu_torch.parallel.BatchEncoder is BatchEncoder
x = (np.arange(2 * 700) % 97 * 50 - 2400).astype(np.int32)
outs = []
for cls, kw in ((FlacSampleWriter, {}), (BatchEncoder, {"device": "cpu"})):
    buf = io.BytesIO()
    enc = cls(buf, Options(block_size=256), 44100, 16, 2, total_samples=700,
              **kw)
    enc.write(x)
    enc.finalize()
    outs.append(buf.getvalue())
assert outs[0] == outs[1]
for device_parse in (False, True):
    with BatchDecoder(io.BytesIO(outs[1]), batch_frames=2, device="cpu",
                      device_parse=device_parse) as dec:
        pcm = dec.read_all_device()
        assert dec.device_frames == 2 and dec.host_frames == 1
        assert dec.parse_fallbacks == int(device_parse)
    assert (pcm.numpy().reshape(-1) == x).all()
assert "flac_codec_tpu_torch.ops.framescan" in sys.modules
assert not any(k.split(".")[0] in ("jax", "jaxlib", "flac_codec_tpu")
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
