"""``tools/profile_encode_torch.py``, the port of the JAX package's
encode-step profilers, on the CPU at a small size (2 frames, block 256,
LPC order 12, partition order 3).

* The stage calls the ``stages`` mode records from ``encode_frames_plan``
  compose: each stage is fed the previous stages' outputs, each call
  made again gives its recorded output, and the plan made under the
  ranges is the plan made without them leaf for leaf (and the JAX
  package's in f64).
* Under ``stage_ranges`` an eager plan enters every range its
  configuration runs, and every patched attribute is the original again
  after the block, also when the plan raises.
* Every ``timed("...")`` stage of the JAX profilers (read with ``ast``,
  never imported: they configure jax for the process) maps to a port
  stage or to a named "not ported" entry.
* Kernels are attributed to the innermost range around the runtime call
  that launched them (on stand-in profiler events: the CPU launches
  none).
* Without a GPU and without ``--device cpu`` the tool exits non-zero,
  and each mode runs on the CPU with ``--device cpu``.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from flac_codec_tpu_torch.convert import plan_to_numpy
from flac_codec_tpu_torch.ops import encode_batch as teb

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "profile_encode_torch.py"
sys.path.insert(0, str(TOOL.parent))
import profile_encode_torch as pe  # noqa: E402

torch.set_num_threads(2)

BLOCK = 256
CPU = torch.device("cpu")
MODES = {"frame-packed": (18, True), "residual-only": (18, False),
         "plan tree": (0, False)}
JAX_PROFILERS = ("profile_encode_step.py", "profile_stages_scan.py",
                 "profile_encode.py")


def _kw(analysis="f32", mode="frame-packed", bits=16):
    budget, frame_pack = MODES[mode]
    return dict(bits_per_sample=bits, block_size=BLOCK, max_lpc_order=12,
                max_partition_order=3, mid_side=True, exhaustive=True,
                window_kind=("tukey", 0.5), analysis=analysis,
                pack_budget=budget + (bits - 16) * (budget > 0),
                frame_pack=frame_pack)


def _pcm(bits=16, seed=20):
    """Two stereo frames of music-like PCM: a tonal frame and a noisy
    one, at ``bits`` bits."""
    rng = np.random.default_rng(seed)
    t = np.arange(BLOCK)
    tone = 6000 * np.sin(t * 0.03) + 2500 * np.sin(t * 0.11)
    left = np.stack([tone, rng.normal(0, 4000, BLOCK)])
    right = 0.7 * left + rng.normal(0, 300, (2, BLOCK))
    pcm = np.round(np.stack([left, right], axis=1)) * (1 << (bits - 16))
    return torch.as_tensor(pcm.astype(np.int32))


def expected_ranges(kw: dict) -> set:
    """The ranges one stereo ``encode_frames_plan(pcm, **kw)`` enters."""
    out = {"encode_frames_plan", "decorrelate.candidates",
           "_analyze_channel", "encode_batch._wasted_bits", *pe.RICE_LABELS,
           "lpc.analyze", "lpc.best_order", "lpc.quantize", "lpc.residuals",
           "_split_rows"}
    out |= ({"fixed.plan_narrow"} if kw["bits_per_sample"] <= 26
            else {"fixed.diff_cascade", "fixed.best_order"})
    out |= ({"lpc.autocorr_levinson"} if kw["analysis"] != "f32"
            else {"lpc.autocorrelate", "lpc.levinson"})
    if kw["pack_budget"] and kw["frame_pack"]:
        out |= {"framepack.pack_frame_bodies", "pack_residual_sections",
                "bitpack.residual_symbols", "pack_symbols (K2)",
                "splice_subframes (K1)", "framepack.crc16_inner"}
    elif kw["pack_budget"]:
        out |= {"_pack_plan_channels", "pack_residual_sections",
                "bitpack.residual_symbols", "pack_symbols (K2)"}
    return out


def range_labels() -> set:
    """Every label the stage ranges give."""
    return ({label for label, _, _ in pe.RANGES if label != "rice.search"}
            | set(pe.RICE_LABELS))


def _trees_equal(got, want) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "channels":
            assert len(got[k]) == len(w)
            for gc, wc in zip(got[k], w):
                _trees_equal(gc, wc)
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, k)


def _recorded(pcm, kw, limit=4):
    """``encode_frames_plan(pcm, **kw)`` under the stage ranges, with a
    :class:`Recorder`: (plan, recorder)."""
    rec = pe.Recorder(limit)
    with pe.stage_ranges(rec):
        plan = teb.encode_frames_plan(pcm, **kw)
    return plan, rec


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("analysis", ["f32", "f64"])
def test_stages_compose_to_the_plan(analysis, mode):
    """The stage calls recorded from ``encode_frames_plan`` are its own:
    the analysis takes the candidates' rows, the pack (or the returned
    plan tree) the split rows, each call made again gives its recorded
    output, and the plan is the one made without the ranges."""
    kw = _kw(analysis, mode)
    pcm = _pcm()
    plan, rec = _recorded(pcm, kw)
    _trees_equal(plan_to_numpy(plan),
                 plan_to_numpy(teb.encode_frames_plan(pcm, **kw)))
    calls = pe.stage_calls(rec)
    (_, _, _, cands), = calls["decorrelate.candidates"]
    (_, args, _, full), = calls["_analyze_channel"]
    assert torch.equal(args[0], cands.reshape(len(pcm) * 4, BLOCK))
    split = [out for _, args, _, out in calls["_split_rows"]]
    assert all(args[0] is full for _, args, _, _ in calls["_split_rows"])
    budget, frame_pack = MODES[mode]
    if budget:
        packer = ("framepack.pack_frame_bodies" if frame_pack
                  else "_pack_plan_channels")
        (_, args, _, _), = calls[packer]
        assert all(a is b for a, b in zip(args[0]["channels"], split))
    else:
        assert all(a is b for a, b in zip(plan["channels"], split))
    assert pe.PLAN not in calls
    for label, recs in calls.items():
        assert pe.stage_graphs(CPU, None, label, recs) == [], label


@pytest.mark.parametrize("mode", ["residual-only", "plan tree"])
def test_stages_compose_to_the_jax_plan(mode):
    """In f64 the plan made under the ranges is the JAX package's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from flac_codec_tpu.ops import encode_batch as jeb

    kw = _kw("f64", mode)
    pcm = _pcm()
    want = jax.tree_util.tree_map(np.asarray, jeb.encode_frames_plan(
        jnp.asarray(pcm.numpy()), **kw))
    _trees_equal(plan_to_numpy(_recorded(pcm, kw)[0]), want)


def test_recorder_keeps_stage_calls_up_to_its_limit():
    """The recorder keeps no call of the plan itself, and at most its
    limit of calls a stage over several plans."""
    kw = _kw()
    rec = pe.Recorder(2)
    with pe.stage_ranges(rec) as seen:
        for seed in range(3):
            teb.encode_frames_plan(_pcm(seed=seed), **kw)
    assert pe.PLAN not in rec.calls and seen.calls[pe.PLAN] == 3
    assert set(rec.calls) == set(seen.calls) - {pe.PLAN}
    assert len(rec.calls["decorrelate.candidates"]) == 2
    assert len(rec.calls["_split_rows"]) == 2
    assert all(len(v) <= 2 for v in rec.calls.values())


# configurations whose eager plans together enter every range: both
# analyses, the three modes, and the general FIXED path above 26 bits
RANGE_CONFIGS = {"f32 frame-packed": ("f32", "frame-packed", 16),
                 "f64 frame-packed": ("f64", "frame-packed", 16),
                 "f32 residual-only": ("f32", "residual-only", 16),
                 "f64 plan tree": ("f64", "plan tree", 16),
                 "f32 frame-packed 27-bit": ("f32", "frame-packed", 27)}


@pytest.mark.parametrize("name", list(RANGE_CONFIGS))
def test_each_range_wraps_real_work(name):
    """One eager plan enters every range its configuration runs, each as
    often as the plan calls it, and nothing else; the block leaves every
    patched attribute as it was."""
    analysis, mode, bits = RANGE_CONFIGS[name]
    kw = _kw(analysis, mode, bits)
    before = pe.patched_attributes()
    with pe.stage_ranges() as seen:
        patched = pe.patched_attributes()
        teb.encode_frames_plan(_pcm(bits), **kw)
    assert all(patched[k] is not v for k, v in before.items())
    assert set(seen.calls) == expected_ranges(kw)
    assert all(n >= 1 for n in seen.calls.values())
    assert seen.calls["_analyze_channel"] == 1
    assert seen.calls["_split_rows"] == 2
    if kw["pack_budget"]:
        assert seen.calls["pack_residual_sections"] == 2
    assert set(seen.io_bytes) == set(seen.calls)
    after = pe.patched_attributes()
    assert all(after[k] is v for k, v in before.items())


def test_the_ranges_cover_every_registered_stage():
    covered = set().union(*(expected_ranges(_kw(*c))
                            for c in RANGE_CONFIGS.values()))
    assert covered == range_labels()


def test_attributes_restored_when_the_plan_raises():
    """A stage that raises leaves through the block with every patched
    attribute restored."""
    def record(name, fn, args, kwargs, out):
        if name == "lpc.quantize":
            raise RuntimeError("stop in lpc.quantize")

    before = pe.patched_attributes()
    with pytest.raises(RuntimeError, match="stop in lpc.quantize"):
        with pe.stage_ranges(record):
            teb.encode_frames_plan(_pcm(), **_kw())
    after = pe.patched_attributes()
    assert all(after[k] is v for k, v in before.items())


def test_attributes_restored_when_the_block_raises():
    before = pe.patched_attributes()
    with pytest.raises(KeyError):
        with pe.stage_ranges():
            raise KeyError("in the block")
    after = pe.patched_attributes()
    assert all(after[k] is v for k, v in before.items())


def _timed_names(path: pathlib.Path) -> set:
    """The first argument of every ``timed("...")`` call in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "timed"
                and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


@pytest.mark.parametrize("tool", JAX_PROFILERS)
def test_stage_map_covers_the_jax_profilers(tool):
    """Each stage a JAX profiler times maps to port stages the tool
    times, or to a named reason it is not ported."""
    names = _timed_names(ROOT / "tools" / tool)
    assert len(names) >= 8
    known = (range_labels() | {pe.FIXED_GENERAL, pe.NULL}
             | {f"ablate: {a[0]}" for a in pe.ABLATIONS})
    for name in names:
        assert name in pe.STAGE_MAP, name
        target = pe.STAGE_MAP[name]
        if isinstance(target, str):
            assert "not in the port" in target, name
        else:
            assert target and set(target) <= known, (name, target)


def _event(name, parent=None, device=False, start=0.0, dur=0.0, id=0):
    return types.SimpleNamespace(
        name=name, cpu_parent=parent, id=id,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        time_range=types.SimpleNamespace(
            start=start, elapsed_us=lambda d=dur: d))


def test_attribute_takes_the_innermost_range():
    """Each kernel counts for the innermost range around the runtime call
    that launched it (the CPU event with its correlation id), whether an
    aten op or a ctypes wrapper made the call; inclusive time goes to
    every range around it; the range's own device span is no kernel; a
    kernel no range holds is unattributed."""
    outer = _event("lpc.analyze", start=1)
    inner = _event("lpc.levinson", outer, start=2)
    mul = _event("aten::mul", outer, start=1.5, id=1)
    cpu = [outer, inner, mul,
           _event("cudaLaunchKernel", mul, start=1.6, id=11),
           _event("cudaLaunchKernel", inner, start=2.5, id=12),
           _event("cudaMemcpyAsync", inner, start=2.6, id=13),
           _event("cudaLaunchKernel", None, start=0.5, id=14)]
    device = [_event("lpc.levinson", device=True, start=2, dur=9.0, id=2)]
    device += [_event(n, device=True, start=3, dur=d, id=i) for n, d, i in
               (("k_mul", 3.0, 11), ("k_ctypes", 2.0, 12),
                ("Memcpy DtoD", 1.0, 13), ("k_outside", 4.0, 14),
                ("k_orphan", 5.0, 99))]
    att = pe.attribute(cpu + device, {"lpc.analyze", "lpc.levinson"})
    assert att["total_us"] == 15.0 and att["total_launches"] == 5
    assert att["self"]["lpc.analyze"] == [1, 3.0]
    assert att["self"]["lpc.levinson"] == [2, 3.0]
    assert att["incl"]["lpc.analyze"] == [3, 6.0]
    assert att["self"][pe.UNATTRIBUTED] == [2, 9.0]
    assert att["order"] == ["lpc.analyze", "lpc.levinson"]
    assert att["depth"] == {"lpc.analyze": 0, "lpc.levinson": 1}


def test_a_stage_that_differs_from_the_plan_raises():
    """A stage call whose output is not the recorded one fails the run."""
    x = torch.arange(8)
    recs = [(torch.neg, (x,), {}, -x), (torch.neg, (x,), {}, x)]
    with pytest.raises(AssertionError, match="differs"):
        pe.stage_graphs(CPU, None, "neg", recs)


def test_same_compares_bits():
    nan = torch.tensor([float("nan"), 1.0])
    assert pe.same({"a": [nan, 3]}, {"a": [nan.clone(), 3]})
    assert not pe.same(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert not pe.same(torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int64))


def test_without_gpu_exits_nonzero_and_prints_no_result():
    assert not torch.cuda.is_available()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(TOOL), "insitu"], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "needs a CUDA GPU" in proc.stderr


@pytest.mark.parametrize("mode", ["insitu", "stages", "ablate"])
def test_no_mode_falls_back_to_the_cpu(mode, capsys):
    assert pe.main([mode]) == 1
    assert capsys.readouterr().out == ""


def _lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_insitu_on_the_cpu(capsys):
    assert pe.main(["insitu", "--device", "cpu", "--frames", "2"]) == 0
    (table,) = _lines(capsys.readouterr().out)
    assert table["table"] == "insitu_stages" and table["device"] == "cpu"
    assert table["card"] is None and table["power_limit_w"] is None
    rows = {r["stage"]: r for r in table["rows"]}
    assert set(rows) == expected_ranges(_kw()) | {pe.UNATTRIBUTED}
    assert all(r["ms"] is None for r in rows.values())
    assert rows["encode_frames_plan"]["depth"] == 0
    assert rows["lpc.levinson"]["depth"] == 3


def test_stages_on_the_cpu(capsys):
    assert pe.main(["stages", "--device", "cpu", "--frames", "2",
                    "--analysis", "f64"]) == 0
    (table,) = _lines(capsys.readouterr().out)
    rows = {r["stage"]: r for r in table["rows"]}
    assert {pe.FIXED_GENERAL, "lpc.autocorr_levinson",
            "framepack.crc16_inner"} <= set(rows)
    assert pe.PLAN not in rows
    assert all(r["equal"] and r["copies"] == 2 for r in rows.values())
    assert rows["_split_rows"]["calls_per_plan"] == 2
    assert table["chain"] == ["decorrelate.candidates", "_analyze_channel",
                              "_split_rows", "framepack.pack_frame_bodies"]
    assert rows["lpc.residuals"]["depth"] == 2
    assert table["replay_drift"] == [] and table["moved_while_timing"] == []
    assert table["timed_ms"] is None and rows["_split_rows"]["ms"] is None
    assert table["new_plan_graphs"] == 0 and table["stage_pool_released"]
    assert table["stage_map"]["partlookup"].startswith("not ported")


def test_ablate_on_the_cpu(capsys):
    assert pe.main(["ablate", "--device", "cpu", "--frames", "2",
                    "--chain", "1"]) == 0
    (table,) = _lines(capsys.readouterr().out)
    assert table["clock"] == "host"
    rows = {r["config"]: r for r in table["rows"]}
    assert list(rows) == [a[0] for a in pe.ABLATIONS]
    assert rows["full B=4x"]["frames"] == 8
    assert rows["24bit"]["pack_budget"] == 26
    assert rows["f64"]["analysis"] == "f64"
    assert table["frame_body_pack_ms"] == pytest.approx(
        rows["full"]["ms"] - rows["pack_off"]["ms"])
    assert pe.main(["ablate", "--device", "cpu", "--signal", "music",
                    "--once", "2", "f32", "0", "0", "1", "3"]) == 0
    (once,) = _lines(capsys.readouterr().out)
    assert once["table"] == "once" and once["pack_budget"] == 0
    assert once["signal"] == "music"
    assert not once["frame_pack"] and once["mbps"] > 0
