"""The port's 14 CLI tools and its copies of the ``format`` modules,
held to the JAX package's.

Each tool runs in process through ``flac_codec_tpu.cli.main`` and
``flac_codec_tpu_torch.cli.main`` with the same arguments, each package
in a directory of its own holding the same input files under the same
relative names: the exit code, stdout, stderr and every file the tool
writes or edits must be the same.  ``wav2flac`` and ``flac2wav`` of the
port run on ``--device cpu`` (the JAX package's run on its host encoder
and on ``--tpu``, which is the JAX CPU backend here).  The error path
(a missing input) is run for every tool.
"""

import concurrent.futures
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from flac_codec_tpu import cli as jcli
from flac_codec_tpu import encode as jencode
from flac_codec_tpu.format import analyze as janalyze
from flac_codec_tpu.format import frame_model as jframe_model
from flac_codec_tpu.format import genstream as jgen
from flac_codec_tpu.utils.wav import pcm_to_wave_bytes, write_wave
from flac_codec_tpu_torch import cli as tcli
from flac_codec_tpu_torch.format import analyze as tanalyze
from flac_codec_tpu_torch.format import frame_model as tframe_model
from flac_codec_tpu_torch.format import genstream as tgen

RATE = 44100
N = 12000


def _png() -> bytes:
    """A 4x3 8-bit RGB PNG, filter type 0."""
    w, h = 4, 3
    pixels = (np.arange(h * w * 3) * 21 % 256).astype(np.uint8)
    raw = b"".join(b"\x00" + pixels[y * w * 3:(y + 1) * w * 3].tobytes()
                   for y in range(h))

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


CUE = ('FILE "a.wav" WAVE\n  TRACK 01 AUDIO\n    INDEX 01 00:00:00\n'
       '  TRACK 02 AUDIO\n    INDEX 01 00:00:10\n')


def _inputs(root):
    """The input files every run starts from, written into ``root``."""
    rng = np.random.default_rng(50)
    t = np.arange(N)
    inter = np.stack([(3000 * np.sin(t * 0.01 * (c + 1))
                       + rng.integers(-100, 100, N)) for c in range(2)],
                     axis=1).reshape(-1).astype(np.int32)
    with open(os.path.join(root, "a.wav"), "wb") as f:
        write_wave(f, RATE, 2, 16, N)
        f.write(pcm_to_wave_bytes(inter, 16))
    for name, opts in (("a.flac", jencode.Options(block_size=1024)),
                       ("b.flac", jencode.Options(block_size=576))):
        w = jencode.FlacSampleWriter(os.path.join(root, name), opts, RATE,
                                     16, 2, total_samples=N)
        w.write(inter)
        w.finalize()
    with open(os.path.join(root, "cover.png"), "wb") as f:
        f.write(_png())
    with open(os.path.join(root, "t.cue"), "w") as f:
        f.write(CUE)
    # a.flac with the cue sheet and the cover, for the tools that read them
    for src in ("cued.flac", "covered.flac"):
        with open(os.path.join(root, "a.flac"), "rb") as f, \
                open(os.path.join(root, src), "wb") as g:
            g.write(f.read())
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert jcli.main(["flac-import-cuesheet", "cued.flac", "t.cue"]) == 0
        assert jcli.main(["flac-add-cover", "covered.flac", "cover.png"]) == 0
    finally:
        os.chdir(cwd)


# tool: (arguments of both, extra arguments of the port, extra arguments
# of the JAX package)
CASES = {
    "wav2flac": (["a.wav", "out.flac", "--block-size", "1024"],
                 ["--device", "cpu", "--analysis", "f64"], []),
    "flac2wav": (["a.flac", "-o", "out.wav"], ["--device", "cpu"],
                 ["--tpu"]),
    "flac-info": (["a.flac", "covered.flac", "cued.flac"], [], []),
    "flac-analyze": (["b.flac"], [], []),
    "flac-verify": (["a.flac"], [], []),
    "flac-tag": (["a.flac", "TITLE=t", "ARTIST=a b"], [], []),
    "flac-cat": (["a.flac", "b.flac", "-o", "cat.flac"], [], []),
    "flac-split": (["cued.flac", "-d", "split", "-j", "1"], [], []),
    "flac-play": (["a.flac", "--stdout"], [], []),
    "flac-resample": (["a.flac", "out.flac", "22050"], [], []),
    "flac-add-cover": (["a.flac", "cover.png", "--description", "d"], [],
                       []),
    "flac-view-artwork": (["covered.flac", "--width", "8"], [], []),
    "flac-import-cuesheet": (["a.flac", "t.cue"], [], []),
    "flac-export-cuesheet": (["cued.flac"], [], []),
}
# further runs: (tool, arguments)
MORE = {
    "flac-play-no-backend": ("flac-play", ["a.flac"]),
    "flac-view-artwork-save": ("flac-view-artwork",
                               ["covered.flac", "--save", "out.png"]),
    "flac-split-bytes": ("flac-split",
                         ["cued.flac", "-d", "split", "-j", "1", "--bytes"]),
    "flac-export-cuesheet-none": ("flac-export-cuesheet", ["a.flac"]),
    "flac-view-artwork-none": ("flac-view-artwork", ["a.flac"]),
}


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _run(main, argv, root, monkeypatch):
    """One tool run in ``root``: (exit code, stdout bytes, stderr text,
    the directory's files afterwards)."""
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    err = io.StringIO()
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    try:
        rc = main(argv)
    finally:
        monkeypatch.undo()
    out.flush()
    return rc, out.buffer.getvalue(), err.getvalue(), _tree(root)


def _compare(tmp_path, monkeypatch, tool, args, port_extra=(),
             jax_extra=(), missing=False, sort_lines=False):
    results = []
    for name, main, extra in (("jax", jcli.main, jax_extra),
                              ("port", tcli.main, port_extra)):
        root = tmp_path / name
        root.mkdir()
        if not missing:
            _inputs(str(root))
        # flac-split's workers as threads: the same work in this process
        monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor",
                            concurrent.futures.ThreadPoolExecutor)
        monkeypatch.setitem(sys.modules, "sounddevice", None)
        results.append(_run(main, [tool, *args, *extra], str(root),
                            monkeypatch))
    (jrc, jout, jerr, jfiles), (trc, tout, terr, tfiles) = results
    if sort_lines:   # workers finish in any order
        jout, tout = sorted(jout.splitlines()), sorted(tout.splitlines())
    assert trc == jrc
    assert tout == jout
    assert terr == jerr
    assert sorted(tfiles) == sorted(jfiles)
    for f in jfiles:
        assert tfiles[f] == jfiles[f], f
    return jrc, jout, jerr, jfiles


@pytest.mark.parametrize("tool", sorted(CASES))
def test_tool_matches_jax(tool, tmp_path, monkeypatch):
    args, port_extra, jax_extra = CASES[tool]
    rc, out, err, files = _compare(tmp_path, monkeypatch, tool, args,
                                   port_extra, jax_extra,
                                   sort_lines=tool == "flac-split")
    assert rc == 0, err


@pytest.mark.parametrize("case", sorted(MORE))
def test_tool_variant_matches_jax(case, tmp_path, monkeypatch):
    tool, args = MORE[case]
    rc, _, err, _ = _compare(tmp_path, monkeypatch, tool, args,
                             sort_lines=tool == "flac-split")
    assert (rc == 0) == (case in ("flac-view-artwork-save",
                                  "flac-split-bytes")), err


@pytest.mark.parametrize("tool", sorted(CASES))
def test_tool_missing_input_matches_jax(tool, tmp_path, monkeypatch):
    """A missing input: the same one-line diagnostic on stderr and exit
    code 1 in both packages, and no traceback."""
    args, port_extra, jax_extra = CASES[tool]
    args = ["missing.wav" if a == "a.wav" else
            "missing.flac" if a.endswith(".flac") and a != "out.flac"
            and a != "cat.flac" else a for a in args]
    rc, _, err, _ = _compare(tmp_path, monkeypatch, tool, args, port_extra,
                             jax_extra, missing=True)
    assert rc == 1
    assert "No such file" in err and "Traceback" not in err


def test_flac2wav_device_parse_matches_jax_device_parse(tmp_path,
                                                       monkeypatch):
    """``flac2wav --device cpu --device-parse`` writes the bytes of the
    JAX ``flac2wav --tpu`` under ``FLAC_TPU_DEVICE_PARSE=1``, and both
    parse the frame bodies on the device: 7 frames of block 64 and a
    tail (the JAX parser runs in interpret mode here)."""
    from flac_codec_tpu.ops import framescan as jfs
    from flac_codec_tpu_torch.ops import framescan as tfs

    n = 64 * 7 + 40
    rng = np.random.default_rng(51)
    inter = (3000 * np.sin(np.arange(2 * n) * 0.013)
             + rng.integers(-100, 100, 2 * n)).astype(np.int32)
    parses = {"jax": 0, "port": 0}
    results = []
    for name, main, module, extra in (
            ("jax", jcli.main, jfs, ["--tpu"]),
            ("port", tcli.main, tfs, ["--device", "cpu", "--device-parse"])):
        root = tmp_path / name
        root.mkdir()
        w = jencode.FlacSampleWriter(str(root / "s.flac"),
                                     jencode.Options(block_size=64), RATE,
                                     16, 2, total_samples=n)
        w.write(inter)
        w.finalize()
        parse = module.parse_frame_bodies

        def counted(*args, _parse=parse, _name=name, **kw):
            parses[_name] += 1
            return _parse(*args, **kw)

        monkeypatch.setattr(module, "parse_frame_bodies", counted)
        monkeypatch.setenv("FLAC_TPU_DEVICE_PARSE", "1")
        results.append(_run(main, ["flac2wav", "s.flac", "-o", "s.wav",
                                   *extra], str(root), monkeypatch))
    (jrc, jout, jerr, jfiles), (trc, tout, terr, tfiles) = results
    assert trc == jrc == 0, terr
    assert (tout, terr) == (jout, jerr)
    assert tfiles["s.wav"] == jfiles["s.wav"]
    assert parses["jax"] >= 1 and parses["port"] >= 1


# the JAX package's device command lines: (tool, arguments of both,
# extra arguments of the port, a file the run writes)
JAX_FLAGS = {
    "wav2flac-tpu": ("wav2flac", ["--tpu", "a.wav", "out.flac"],
                     ["--device", "cpu"], "out.flac"),
    "wav2flac-tpu-best": ("wav2flac", ["--tpu", "--best", "--block-size",
                                       "1024", "a.wav", "out.flac"],
                          ["--device", "cpu"], "out.flac"),
    "flac2wav-tpu-jobs": ("flac2wav", ["--tpu", "-j", "2", "a.flac",
                                       "b.flac"], ["--device", "cpu"],
                          "b.wav"),
    "flac2wav-jobs": ("flac2wav", ["-j", "2", "b.flac", "cued.flac"],
                      ["--device", "cpu"], "cued.wav"),
}


@pytest.mark.parametrize("case", sorted(JAX_FLAGS))
def test_device_tool_takes_jax_flags(case, tmp_path, monkeypatch):
    """``wav2flac --tpu`` and ``flac2wav --tpu -j 2`` (and ``-j 2`` alone,
    which the JAX tool runs in a worker pool): the port accepts the JAX
    command line, adds only ``--device cpu``, and writes the JAX tool's
    files and output."""
    tool, args, port_extra, written = JAX_FLAGS[case]
    rc, _, err, files = _compare(tmp_path, monkeypatch, tool, args,
                                 port_extra, sort_lines=True)
    assert rc == 0, err
    assert written in files


def test_cli_table_and_unknown_tool(capsys):
    assert tcli.TOOLS == jcli.TOOLS
    assert tcli.main(["no-such-tool"]) == 2
    assert "no-such-tool" in capsys.readouterr().err


def _frame_specs():
    """A few generator frames: every subframe type, LPC, wasted bits,
    escaped and constant partitions, side-channel stereo."""
    rng = np.random.default_rng(51)
    n = 256
    res = rng.integers(-40, 40, n - 2)
    res[126:190] = 0                               # the constant partition
    res[70] = 30000                                # the escaped partition
    S = tgen.SubframeSpec
    return [
        ([S("constant", values=np.array([-7])),
          S("verbatim", values=rng.integers(-3000, 3000, n))], None),
        ([S("fixed", order=2, warmups=np.array([5, -3]), residuals=res,
            partition_order=2,
            partition_kinds=["rice", "escape", "constant", "rice"]),
          S("lpc", order=3, warmups=np.array([1, 2, 3]),
            residuals=rng.integers(-9, 9, n - 3),
            coeffs=np.array([900, -300, 50]), shift=10, precision=12,
            wasted=2)], None),
        ([S("fixed", order=1, warmups=np.array([100]),
            residuals=rng.integers(-20, 20, n - 1)),
          S("fixed", order=0, warmups=np.array([], dtype=np.int64),
            residuals=rng.integers(-20, 20, n))], 0b1000),
    ]


def _stream_pair():
    out = []
    for gen in (jgen, tgen):
        frames = [gen.FrameSpec(256, [gen.SubframeSpec(**vars(s))
                                      for s in subs], a)
                  for subs, a in _frame_specs()]
        out.append(gen.build_stream(frames, bps=16))
    return out


def test_genstream_frame_model_and_analyze_match_jax():
    (jdata, jpcm), (tdata, tpcm) = _stream_pair()
    assert tdata == jdata
    np.testing.assert_array_equal(tpcm, jpcm)
    assert tframe_model.rebuild_stream(io.BytesIO(tdata)) == \
        jframe_model.rebuild_stream(io.BytesIO(jdata)) == jdata
    tf = list(tframe_model.iter_frame_data(io.BytesIO(tdata)))
    jf = list(jframe_model.iter_frame_data(io.BytesIO(jdata)))
    assert repr(tf) == repr(jf) and len(tf) == 3
    ta = [(repr(f), off) for f, off in tanalyze.FrameIterator(
        io.BytesIO(tdata))]
    ja = [(repr(f), off) for f, off in janalyze.FrameIterator(
        io.BytesIO(jdata))]
    assert ta == ja and len(ta) == 3
