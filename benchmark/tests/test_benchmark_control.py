"""``correct`` comes out true for a sound run, and false for each cell's
control and for each fault that its timed path can have, with the rest
of the run driven as the benchmark drives it (CPU, tiny size; the same
controls ran on the card at the cells' own sizes, PERF.md)."""

import numpy as np
import pytest

CELLS = ("cd16.encode", "hires24.decode", "cd16.decode")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_run, cell):
    got = tiny_run(cell, 3000000001)
    assert got["correct"] is True
    assert got["attempted"] >= 1 and got["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in got["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_run, cell):
    got = tiny_run(cell, 3000000002, control=True)
    assert got["correct"] is False
    assert any(c["value"] > c["limit"] for c in got["checks"].values())


# faults planted in the program under the timed path, armed once the
# timed requests start (so that set-up, which drives the same path,
# passes: a fault that raised there would end the run before any check)
ARMED = [False]


def encode_altered(monkeypatch):
    """A frame's last byte altered where the frames are assembled."""
    from flac_codec_tpu_torch.parallel import batch

    real = batch.assemble_frames

    def altered(*args, **kwargs):
        frames, fallback = real(*args, **kwargs)
        if ARMED[0]:
            frames[0] = frames[0][:-1] + bytes([frames[0][-1] ^ 1])
        return frames, fallback

    monkeypatch.setattr(batch, "assemble_frames", altered)


def encode_half_batch(monkeypatch):
    """Half of each batch's frames left out of the plan."""
    from flac_codec_tpu_torch.parallel.batch import BatchEncoder

    real = BatchEncoder._dispatch_batch

    def half(self, chunk):
        frame = self._block * self._chans
        keep = max(1, len(chunk) // frame // 2) * frame
        return real(self, chunk[:keep] if ARMED[0] else chunk)

    monkeypatch.setattr(BatchEncoder, "_dispatch_batch", half)


def encode_stale(monkeypatch):
    """Each batch's frames replaced by the previous batch's."""
    from flac_codec_tpu_torch.parallel import batch

    real = batch.assemble_frames
    last = []

    def stale(*args, **kwargs):
        got = real(*args, **kwargs)
        out = last[-1] if last and ARMED[0] else got
        last.append(got)
        return out

    monkeypatch.setattr(batch, "assemble_frames", stale)


def _wrap_decoder(monkeypatch, change):
    from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder

    real = BatchDecoder.read_batch_device
    seen = []

    def wrapped(self):
        got = real(self)
        if got is None:
            return None
        out = change(got, seen) if ARMED[0] else got
        seen.append(got)
        return out

    monkeypatch.setattr(BatchDecoder, "read_batch_device", wrapped)


def decode_altered(monkeypatch):
    """One sample of each batch altered where the PCM is produced."""
    def altered(got, seen):
        pcm, blocks = got
        pcm = pcm.clone()
        pcm[0, 0, 0] += 1
        return pcm, blocks

    _wrap_decoder(monkeypatch, altered)


def decode_half_batch(monkeypatch):
    """Half of each batch's frames left out."""
    def half(got, seen):
        pcm, blocks = got
        keep = max(1, len(blocks) // 2)
        return pcm[:keep], np.asarray(blocks)[:keep]

    _wrap_decoder(monkeypatch, half)


def decode_stale(monkeypatch):
    """Each batch returned as the previous one was (its state
    unchanged)."""
    def stale(got, seen):
        return seen[-1] if seen else got

    _wrap_decoder(monkeypatch, stale)


FAULTS = {"cd16.encode": (encode_altered, encode_half_batch, encode_stale),
          "cd16.decode": (decode_altered, decode_half_batch, decode_stale)}


@pytest.mark.parametrize(
    "cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
    ids=[f"{c}-{f.__name__}" for c, fs in FAULTS.items() for f in fs])
def test_fault_is_not_correct(tiny_run, monkeypatch, cell, fault):
    from benchmark.harness import runner

    real = runner._timed

    def armed(driver, i):
        ARMED[0] = True
        return real(driver, i)

    monkeypatch.setattr(runner, "_timed", armed)
    ARMED[0] = False
    fault(monkeypatch)
    got = tiny_run(cell, 3000000003)
    assert got["correct"] is False
    assert got["failed"] >= 1


# wasted bits: the cells' tracks carry every bit of their width, so the
# decode of a wasted-bits stream is held here, at the tiny size
WASTED = {"hires24.decode": 8, "cd16.decode": 4}


@pytest.mark.parametrize("cell", WASTED)
def test_wasted_bits_decode_is_correct(tiny_run, cell):
    extra = {"cfg": {"track_wasted_bits": [WASTED[cell]]}}
    got = tiny_run(cell, 3000000004, extra=extra)
    assert got["correct"] is True and got["failed"] == 0


@pytest.mark.parametrize("cell", WASTED)
def test_wasted_bits_decode_fault_is_not_correct(tiny_run, monkeypatch,
                                                 cell):
    from benchmark.harness import runner

    real = runner._timed

    def armed(driver, i):
        ARMED[0] = True
        return real(driver, i)

    monkeypatch.setattr(runner, "_timed", armed)
    ARMED[0] = False
    decode_altered(monkeypatch)
    extra = {"cfg": {"track_wasted_bits": [WASTED[cell]]}}
    got = tiny_run(cell, 3000000005, extra=extra)
    assert got["correct"] is False and got["failed"] >= 1


def md5_altered(monkeypatch):
    """The program's STREAMINFO MD5 taken over one byte more than the
    PCM."""
    import hashlib
    import types

    from flac_codec_tpu_torch import encode

    monkeypatch.setattr(encode, "hashlib", types.SimpleNamespace(
        md5=lambda *a: hashlib.md5(b"\0", *a)))


@pytest.mark.parametrize("fault,check", [
    (encode_altered, "roundtrip_samples_differing"),
    (md5_altered, "md5_differing")], ids=["frame", "md5"])
def test_fault_shared_with_the_reference_is_not_correct(
        tiny_run, monkeypatch, fault, check):
    """A fault that the reference's encoder had too (stood in for by
    handing the program's own first stream to the byte comparison) passes
    ``tracks_differing`` and fails the round trip or the MD5."""
    from benchmark.harness import runner

    real_load = runner.load_module

    def load(kind, name):
        module = real_load(kind, name)
        if kind == "drivers":
            reference = module.Driver._reference
            module.Driver._reference = lambda self, k: (
                self.first[k], reference(self, k)[1])
        return module

    monkeypatch.setattr(runner, "load_module", load)
    # armed from set-up on, so that every stream of a track is alike
    ARMED[0] = True
    fault(monkeypatch)
    try:
        got = tiny_run("cd16.encode", 3000000006)
    finally:
        ARMED[0] = False
    assert got["checks"]["tracks_differing"]["value"] == 0
    assert got["checks"][check]["value"] > 0
    assert got["correct"] is False and got["failed"] >= 1
