"""The port's span tracer (``flac_codec_tpu_torch.utils.trace``), on the
CPU: span trees over a decode of a tiny stream, self time, the clock it
shares with ``torch.profiler``, and when the trace file is written."""

import builtins
import io
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import devtrace, runner
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder
from flac_codec_tpu_torch.utils import trace
from torch_sources import open_as  # noqa: F401 (fixture)

torch.set_num_threads(2)

BLOCK = 1024
# 5 whole frames and a short last one: batches of 4 frames, then the
# host parse and the host decoder for the tail
SAMPLES = BLOCK * 5 + 300
STAGES = {"decode.read", "decode.fill", "decode.scan", "decode.upload",
          "decode.stage_wait", "decode.parse_device", "decode.gate_wait",
          "decode.reconstruct", "decode.parse", "decode.host_frame",
          "decode.close"}


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(22)
    t = np.arange(SAMPLES)
    tone = 6000 * np.sin(2 * np.pi * 440 * t / 44100)
    pcm = (tone[:, None] + rng.normal(0, 300, (SAMPLES, 2))).astype(np.int32)
    buf = io.BytesIO()
    w = FlacSampleWriter(buf, Options(block_size=BLOCK), 44100, 16, 2,
                         total_samples=SAMPLES)
    w.write(pcm.reshape(-1))
    w.finalize()
    return buf.getvalue(), pcm


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """Tracing on into a file of the test's own; returns its path."""
    path = tmp_path / "trace.jsonl"
    trace._records.clear()
    monkeypatch.setattr(trace, "_MODE", str(path))
    yield path
    trace._records.clear()


def _decode(data, want=None, source=None):
    """Decode ``data`` (from ``source``, else a ``BytesIO``) on the CPU
    with the device parse, batch by batch; returns the decoder (closed)
    and the number of read calls."""
    dec = BatchDecoder(source or io.BytesIO(data), 4, None, True,
                       device="cpu")
    calls, parts = 0, []
    while True:
        calls += 1
        got = dec.read_batch_device()
        if got is None:
            break
        pcm, blocks = got
        parts += [pcm[b, :, :int(n)].T for b, n in enumerate(blocks)]
    dec.close()
    if want is not None:
        assert np.array_equal(torch.cat(parts).numpy(), want)
    return dec, calls


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_decode_spans_carry_parents_and_request_ids(stream, traced):
    data, pcm = stream
    first, calls = _decode(data, pcm)
    second, _ = _decode(data)
    assert second.request_id != first.request_id
    recs = _records(traced)
    spans = {r["id"]: r for r in recs if "id" in r}
    assert len(spans) == sum("id" in r for r in recs)  # ids are unique
    mine = [r for r in spans.values() if r["req"] == first.request_id]
    assert {r["stage"] for r in mine} == STAGES
    reads = [r for r in mine if r["stage"] == "decode.read"]
    assert len(reads) == calls
    top = [r for r in mine if r["parent"] is None]
    assert sorted(r["stage"] for r in top) == \
        ["decode.close"] + ["decode.read"] * calls
    for r in mine:
        if r in top:
            continue
        parent = spans[r["parent"]]
        assert parent["req"] == r["req"]
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= parent["end_ns"]
        want = {"decode.gate_wait": "decode.parse_device",
                "decode.stage_wait": ("decode.upload",
                                      "decode.reconstruct")}.get(
                                          r["stage"], "decode.read")
        assert parent["stage"] in want, r
    fill, = [r for r in mine if r["stage"] == "decode.fill"]
    # the BytesIO's bytes lent from the first frame on
    assert fill["how"] == "view"
    assert fill["bytes"] == len(data) - first.decoder.frames_start
    selfs = [r for r in recs if r["stage"] == "decode.read.self"
             and r["req"] == first.request_id]
    assert sorted(r["span"] for r in selfs) == sorted(r["id"] for r in reads)
    for r in selfs:
        assert r["ms"] == spans[r["span"]]["self_ms"]


@pytest.mark.parametrize("source,how", [
    ("bytesio", "view"), ("file", "chunks"), ("unseekable", "chunks")])
def test_one_fill_a_track_says_how(stream, traced, open_as, source, how):
    data, pcm = stream
    decs = [_decode(data, pcm, open_as(source, data))[0] for _ in range(2)]
    fills = [r for r in _records(traced) if r["stage"] == "decode.fill"]
    assert [r["req"] for r in fills] == [d.request_id for d in decs]
    assert all(r["how"] == how and r["bytes"] > len(data) // 2
               for r in fills)


def test_note_adds_meta_to_the_innermost_open_span(traced, monkeypatch):
    with pytest.raises(AssertionError):
        trace.note("outer", lost=1)     # no span open
    with trace.stage("outer", req=3):
        with trace.stage("inner"):
            trace.note("inner", how="view", bytes=5)
            with pytest.raises(AssertionError):
                trace.note("outer", lost=1)     # not the innermost
        trace.note("outer", n=2)
    trace.flush()
    recs = {r["stage"]: r for r in _records(traced)}
    assert (recs["inner"]["how"], recs["inner"]["bytes"]) == ("view", 5)
    assert recs["outer"]["n"] == 2 and "how" not in recs["outer"]
    assert not any("lost" in r for r in recs.values())
    monkeypatch.setattr(trace, "_MODE", "")
    trace.note("outer", lost=1)         # tracing off: nothing, no check


def test_self_time_of_a_hand_built_tree(traced, monkeypatch):
    """root [0, 100] holds a [10, 40] (which holds c [15, 35]) and
    b [50, 70] ms: self times 50, 10, 20 and 20 ms."""
    ticks = iter(t * 1_000_000 for t in (0, 10, 15, 35, 40, 50, 70, 100))
    monkeypatch.setattr(trace, "time", SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    with trace.stage("decode.read", req=7, self_record=True):
        with trace.stage("a"):
            with trace.stage("c", req=8):
                pass
        with trace.stage("b"):
            pass
    trace.flush()
    recs = {r["stage"]: r for r in _records(traced)}
    want = {"decode.read": (100, 50, 0, None),
            "a": (30, 10, 10, "decode.read"), "c": (20, 20, 15, "a"),
            "b": (20, 20, 50, "decode.read")}
    for name, (ms, self_ms, start, parent) in want.items():
        r = recs[name]
        assert (r["ms"], r["self_ms"]) == (ms, self_ms)
        assert r["start_ns"] == start * 1_000_000 + trace._EPOCH_NS
        assert r["end_ns"] - r["start_ns"] == ms * 1_000_000
        assert (recs[parent]["id"] if parent else None) == r["parent"]
    assert [recs[k]["req"] for k in ("decode.read", "a", "c", "b")] == \
        [7, 7, 8, 7]
    assert recs["decode.read.self"]["ms"] == 50
    assert recs["decode.read.self"]["span"] == recs["decode.read"]["id"]


def test_the_file_is_opened_once_a_flush(stream, traced, monkeypatch):
    opened = []

    def counting_open(*args, **kwargs):
        opened.append(args[0])
        return builtins.open(*args, **kwargs)

    monkeypatch.setattr(trace, "open", counting_open, raising=False)
    data, _ = stream
    dec = BatchDecoder(io.BytesIO(data), 4, None, True, device="cpu")
    while dec.read_batch_device() is not None:
        pass
    assert len(trace._records) > 10 and opened == []
    assert not traced.exists()
    dec.close()
    assert opened == [str(traced)] and len(trace._records) == 0
    n = len(_records(traced))
    _decode(data)
    assert opened == [str(traced)] * 2 and len(_records(traced)) == 2 * n
    trace.flush()  # nothing kept: nothing opened
    assert len(opened) == 2


def test_every_record_keeps_stage_and_ms_for_the_runner(stream, traced):
    dec, calls = _decode(stream[0])
    recs = _records(traced)
    assert all(isinstance(r["stage"], str) and isinstance(r["ms"], float)
               for r in recs)
    got = runner.spans(str(traced), 0, traced.stat().st_size)
    assert set(got) == STAGES | {"decode.read.self"}
    assert len(got["decode.read"]) == len(got["decode.read.self"]) == calls
    assert got["decode.fill"] == [r["ms"] for r in recs
                                  if r["stage"] == "decode.fill"]


def test_tracing_off_writes_nothing_and_shares_one_noop(stream, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(trace, "_MODE", "")
    monkeypatch.chdir(tmp_path)
    assert trace._sessions == 0
    assert trace.stage("decode.read", req=1) is trace.stage("x") \
        is trace._NOOP
    with trace.stage("decode.read", req=1) as got:
        assert got is None
    _decode(stream[0], stream[1])
    assert len(trace._records) == 0 and list(tmp_path.iterdir()) == []


def test_spans_nest_under_the_profiler_harness_wrapper(stream, traced):
    """``devtrace.span_ranges`` replaces ``trace.stage`` with a range
    around the original span: the spans keep their parents."""
    original = trace.stage
    with devtrace.span_ranges() as names:
        assert trace.stage is not original
        dec, calls = _decode(stream[0], stream[1])
    assert trace.stage is original
    assert names == STAGES
    recs = [r for r in _records(traced) if "id" in r]
    reads = {r["id"] for r in recs if r["stage"] == "decode.read"}
    assert len(reads) == calls
    assert all(r["parent"] in reads for r in recs
               if r["stage"] in {"decode.scan", "decode.fill",
                                 "decode.upload", "decode.parse_device"})
    assert all(r["req"] == dec.request_id for r in recs)


def test_spans_share_the_profiler_clock(traced):
    """A 20 ms span inside a ``record_function`` range, under a CPU
    ``torch.profiler``, lies inside that range to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with record_function("warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with trace.stage("inner"):
                time.sleep(0.02)
    trace.flush()
    rec, = _records(traced)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    outer, = [e for e in prof.events() if e.name == "outer"]
    lo = t0 + outer.time_range.start * 1000
    hi = t0 + outer.time_range.end * 1000
    assert rec["end_ns"] - rec["start_ns"] >= 20_000_000
    assert lo - 1e6 <= rec["start_ns"] and rec["end_ns"] <= hi + 1e6
    assert rec["start_ns"] - lo < 1e6 and hi - rec["end_ns"] < 1e6


def test_threads_keep_their_own_trees_and_lose_no_span(traced):
    """Threads that nest spans and flush at once: every span is written
    once, under its own thread's parent."""
    import sys
    import threading

    threads, rounds = 8, 200

    def work(req):
        for i in range(rounds):
            with trace.stage("outer", req=req):
                with trace.stage("inner"):
                    pass
            if i % 10 == 0:
                trace.flush()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(r,))
                for r in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    trace.flush()
    recs = _records(traced)
    assert len(recs) == len({r["id"] for r in recs}) == 2 * threads * rounds
    outer = {r["id"]: r["req"] for r in recs if r["stage"] == "outer"}
    inner = [r for r in recs if r["stage"] == "inner"]
    assert all(outer[r["parent"]] == r["req"] for r in inner)
    assert sorted(outer.values()) == sorted(list(range(threads)) * rounds)
