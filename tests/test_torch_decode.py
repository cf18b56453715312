"""The port's decode slice on the CPU, held to the JAX package.

Inputs come from numpy seeds or from the committed conformance corpus
(``tests/data/conformance/``).  Every comparison is exact integer
equality: the inverse-LPC recurrence is exact in int64 in both packages.

* ``predict_batch_plain`` (what ``predict_lpc`` runs for CPU tensors)
  against the JAX int64 scan ``predict_batch`` (rows whose samples leave
  int32 included), and against the Pallas ``predict_batch_pallas`` in
  interpret mode on its gated domain;
* ``predict_fixed_batch`` and ``fixed_compatible_mask`` against JAX's;
* ``BatchDecoder(device="cpu")`` against the JAX ``BatchDecoder`` and the
  encoded samples, on host-encoded streams and on every corpus stream
  (against the manifest's ``pcm_md5`` too);
* the port's ``flac2wav --device cpu`` against the JAX ``flac2wav --tpu``.
"""

import functools
import hashlib
import io
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from chip_smoke import INT32_EDGE_CASES, int32_edge_rows
from flac_codec_tpu.cli import flac2wav as jax_flac2wav
from flac_codec_tpu.decode import Decoder as JaxHostDecoder
from flac_codec_tpu.ops import predict as jpredict
from flac_codec_tpu.ops.predict_pallas import (pallas_predict_ok,
                                               predict_batch_pallas)
from flac_codec_tpu.parallel.batch_decode import BatchDecoder as JaxDecoder
from flac_codec_tpu_torch.cli import main as port_main
from flac_codec_tpu_torch.decode import Decoder
from flac_codec_tpu_torch.encode import FlacSampleWriter, Options
from flac_codec_tpu_torch.errors import NotSeekable
from flac_codec_tpu_torch.ops import predict as tpredict
from flac_codec_tpu_torch.ops.predict_pallas import (TAP_BUCKETS, int64_rows,
                                                     predict_lpc, tap_bucket)
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder
from torch_sources import open_as  # noqa: F401 (fixture)

torch.set_num_threads(2)

CORPUS = os.path.join(os.path.dirname(__file__), "data", "conformance")
with open(os.path.join(CORPUS, "manifest.json")) as _fp:
    MANIFEST = json.load(_fp)


def _lpc_rows(rng, orders, shifts, N, sample_bits=23):
    """Rows whose inverse recurrence gives back a known signal: the
    forward predictor runs over bounded samples ``y`` with coefficients
    scaled to the shift (as a quantized LPC predictor is), so residuals
    fit int32.  Returns (x int32, q int32 (R, 32), shift, order, y int64).
    """
    R = len(orders)
    y = rng.integers(-(1 << sample_bits), 1 << sample_bits, (R, N))
    x = y.copy()
    q = np.zeros((R, 32), np.int64)
    for r, (o, s) in enumerate(zip(orders, shifts)):
        if not o:
            continue
        lim = min(2 << s, (1 << 14) - 1)
        q[r, :o] = rng.integers(-lim, lim + 1, o)
        # lag[n - o, j] = y[n - 1 - j] for n >= o
        win = np.lib.stride_tricks.sliding_window_view(y[r, :-1], o)
        acc = (win[:, ::-1] * q[r, :o]).sum(1)
        x[r, o:] = y[r, o:] - (acc >> s)
    return (x.astype(np.int32), q.astype(np.int32),
            np.asarray(shifts, np.int32), np.asarray(orders, np.int32), y)


def _port_predict(x, q, shift, order, taps):
    out = predict_lpc(*(torch.from_numpy(np.ascontiguousarray(a))
                        for a in (x, q, shift, order)), taps)
    assert out.dtype == torch.int64
    return out.numpy()


def _jax_predict(x, q, shift, order, taps):
    return np.asarray(jpredict.predict_batch(
        jnp.asarray(x.astype(np.int64)), jnp.asarray(q.astype(np.int64)),
        jnp.asarray(shift), jnp.asarray(order), x.shape[1], taps=taps))


@pytest.mark.parametrize("order", range(33))
def test_predict_plain_matches_jax_scan_by_order(order):
    """One order per case, shifts 0-15 across the rows, 24-bit-range
    warm-ups, N = 256, in the order's tap bucket."""
    rng = np.random.default_rng(100 + order)
    x, q, shift, orders, y = _lpc_rows(rng, [order] * 16, range(16), 256)
    taps = tap_bucket(order)
    got = _port_predict(x, q, shift, orders, taps)
    np.testing.assert_array_equal(got, _jax_predict(x, q, shift, orders,
                                                    taps))
    np.testing.assert_array_equal(got, y)


@pytest.mark.parametrize("taps", TAP_BUCKETS)
def test_predict_plain_matches_jax_scan_by_bucket(taps):
    """Mixed orders 0..taps in one batch, order-0 rows included."""
    rng = np.random.default_rng(200 + taps)
    orders = np.concatenate([[0, taps], rng.integers(0, taps + 1, 22)])
    shifts = rng.integers(0, 16, len(orders))
    x, q, shift, orders, y = _lpc_rows(rng, orders, shifts, 256)
    got = _port_predict(x, q, shift, orders, taps)
    np.testing.assert_array_equal(got, _jax_predict(x, q, shift, orders,
                                                    taps))
    np.testing.assert_array_equal(got, y)


def test_predict_plain_shift_semantics_match_jax():
    """Shifts outside [0, 63] shift in sign bits only, as XLA's
    shift_right_arithmetic does; an order beyond the row's length leaves
    it all warm-up."""
    rng = np.random.default_rng(7)
    x = rng.integers(-(1 << 20), 1 << 20, (4, 64)).astype(np.int32)
    q = np.zeros((4, 32), np.int32)
    q[:, :2] = [[3, -1], [1, 1], [5, 0], [1, 0]]
    shift = np.array([64, -3, 70, 2], np.int32)
    order = np.array([2, 2, 1, 80], np.int32)
    np.testing.assert_array_equal(_port_predict(x, q, shift, order, 4),
                                  _jax_predict(x, q, shift, order, 4))


@pytest.mark.parametrize("case", range(len(INT32_EDGE_CASES)),
                         ids=[c[0] for c in INT32_EDGE_CASES])
def test_predict_plain_at_int32_edge_matches_jax(case):
    """A row built to leave int32 mid-row and come back, or to sit at
    -2^31 or 2^31 - 1 without leaving (``chip_smoke.INT32_EDGE_CASES``),
    beside two ordinary rows, in its order's tap bucket: the plain version
    equals the JAX int64 scan and the row's built samples, and
    ``slow_rows`` counts the row exactly when it leaves int32."""
    name, order, _, _, kind = INT32_EDGE_CASES[case]
    N = 512
    x, q, shift, orders, y = (a[case:case + 1] for a in int32_edge_rows(N))
    rng = np.random.default_rng(300 + case)
    rows = _lpc_rows(rng, [order, 0], rng.integers(0, 16, 2), N)
    x, q, shift, orders, y = (np.concatenate([a, b])
                              for a, b in zip((x, q, shift, orders, y), rows))
    taps = tap_bucket(order)
    got = _port_predict(x, q, shift, orders, taps)
    np.testing.assert_array_equal(got, _jax_predict(x, q, shift, orders,
                                                    taps))
    np.testing.assert_array_equal(got, y)
    top, bottom = (1 << 31) - 1, -(1 << 31)
    leaves = kind in ("up", "down", "late", "early")
    assert ((got[0] > top) | (got[0] < bottom)).any() == leaves
    if kind in ("top", "bottom"):
        assert (got[0] == (top if kind == "top" else bottom)).any()
    slow = torch.zeros(1, dtype=torch.int32)
    predict_lpc(*(torch.from_numpy(np.ascontiguousarray(a))
                  for a in (x, q, shift, orders)), taps, slow_rows=slow)
    assert int(slow) == int(leaves)


@pytest.mark.parametrize("qsum,shift,slow", [
    ((1 << 19) - 1, 15, False), (1 << 19, 15, True), (3, 51, False),
    (3, 52, True), (3, -1, True), (3, 64, True)])
def test_int64_rows_rule(qsum, shift, slow):
    """The rows the kernel runs in int64 without leaving int32: a |q| sum
    over the taps of 2^19 or more, or a shift past 51 as the kernel reads
    it; slow_rows counts them on the CPU as the kernel does on the card.
    The samples match the JAX scan either way."""
    rng = np.random.default_rng(qsum + shift)
    x = rng.integers(-50, 50, (2, 64)).astype(np.int32)
    x[0] = 0                    # taps this large would leave int32
    q = np.zeros((2, 32), np.int32)
    q[0, :2] = [qsum - qsum // 2, -(qsum // 2)]
    q[1, 12] = 1 << 20          # beyond the taps: not counted
    shifts = np.array([shift, 0], np.int32)
    orders = np.array([2, 2], np.int32)
    got = _port_predict(x, q, shifts, orders, 12)
    np.testing.assert_array_equal(got, _jax_predict(x, q, shifts, orders, 12))
    rule = int64_rows(torch.from_numpy(got), torch.from_numpy(q),
                      torch.from_numpy(shifts), 12)
    assert rule.tolist() == [slow, False]
    counted = torch.zeros(1, dtype=torch.int32)
    predict_lpc(*(torch.from_numpy(a) for a in (x, q, shifts, orders)), 12,
                slow_rows=counted)
    assert int(counted) == int(slow)


def _gated_rows(seed, R, N, max_order, sample_bits, shifts, q_bits):
    """Rows in the Pallas gate's domain, built as tests/test_predict_ops.py
    builds them: bounded samples through the forward predictor."""
    rng = np.random.default_rng(seed)
    orders = rng.integers(0, max_order + 1, R)
    shift = np.where(orders > 0, rng.integers(*shifts, R), 0)
    x, q, shift, orders, y = _lpc_rows(rng, orders, shift, N, sample_bits)
    q[:, :] = np.clip(q, -(1 << q_bits), (1 << q_bits) - 1)
    # recompute the residuals for the clipped coefficients
    for r in range(R):
        o, s = int(orders[r]), int(shift[r])
        if o:
            win = np.lib.stride_tricks.sliding_window_view(y[r, :-1], o)
            acc = (win[:, ::-1] * q[r, :o].astype(np.int64)).sum(1)
            x[r, o:] = y[r, o:] - (acc >> s)
    return x, q, shift, orders, y


@pytest.mark.parametrize("limbs,bps,sample_bits,shifts,q_bits", [
    (2, 16, 12, (10, 14), 11),
    (3, 24, 20, (10, 16), 9),
])
def test_predict_plain_matches_pallas_interpret(limbs, bps, sample_bits,
                                                shifts, q_bits):
    x, q, shift, orders, y = _gated_rows(40 + limbs, 12, 192, 12,
                                         sample_bits, shifts, q_bits)
    assert pallas_predict_ok(x, q, shift, orders, bps, 16) == limbs
    want = np.asarray(predict_batch_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(shift),
        jnp.asarray(orders), x.shape[1], taps=16, limbs=limbs,
        interpret=True))
    got = _port_predict(x, q, shift, orders, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, y)


def _fixed_rows(rng, orders, N):
    """FIXED-predictor rows (shift 0, FIXED_COEFFS taps) from small
    samples, so every level of the cumsum pyramid stays small."""
    orders = np.asarray(orders)
    q = np.zeros((len(orders), 32), np.int32)
    q[:, :4] = tpredict.FIXED_ROWS[orders]
    shift = np.zeros(len(orders), np.int32)
    x, _, _, _, y = _lpc_rows(rng, [0] * len(orders), shift, N, 15)
    for r, o in enumerate(orders):
        if o:
            win = np.lib.stride_tricks.sliding_window_view(y[r, :-1], o)
            acc = (win[:, ::-1] * q[r, :o].astype(np.int64)).sum(1)
            x[r, o:] = y[r, o:] - acc
    return x, q, shift, orders.astype(np.int32), y


@pytest.mark.parametrize("orders", [[0] * 4, [1] * 4, [2] * 4, [3] * 4,
                                    [4] * 4, [0, 1, 2, 3, 4, 4, 2, 0]])
def test_predict_fixed_matches_jax(orders):
    rng = np.random.default_rng(sum(orders) + len(orders))
    x, q, shift, orders, y = _fixed_rows(rng, orders, 300)
    got = tpredict.predict_fixed_batch(torch.from_numpy(x),
                                       torch.from_numpy(orders))
    assert got.dtype == torch.int64
    want = jpredict.predict_fixed_batch(jnp.asarray(x), jnp.asarray(orders),
                                        x.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), y)
    assert tpredict.fixed_compatible_mask(q, shift, orders).all()


def test_fixed_compatible_mask_matches_jax():
    rng = np.random.default_rng(5)
    x, q, shift, orders, _ = _lpc_rows(rng, rng.integers(0, 9, 40),
                                       rng.integers(0, 3, 40), 32)
    xf, qf, sf, of, _ = _fixed_rows(rng, rng.integers(0, 5, 40), 32)
    q, shift, orders = (np.concatenate([q, qf]), np.concatenate([shift, sf]),
                        np.concatenate([orders, of]))
    got = tpredict.fixed_compatible_mask(q, shift, orders)
    np.testing.assert_array_equal(
        got, jpredict.fixed_compatible_mask(q, shift, orders))
    assert got.any() and not got.all()


def test_predict_lpc_rejects_bad_inputs():
    x = torch.zeros((2, 8), dtype=torch.int32)
    q = torch.zeros((2, 32), dtype=torch.int32)
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="x must be torch.int32"):
        predict_lpc(x.long(), q, s, s, 4)
    with pytest.raises(ValueError, match="taps must be one of"):
        predict_lpc(x, q, s, s, 5)
    with pytest.raises(ValueError, match="shapes do not match"):
        predict_lpc(x, q[:, :3].contiguous(), s, s, 4)
    with pytest.raises(ValueError, match="contiguous"):
        predict_lpc(x.t(), q, s, s, 4)
    with pytest.raises(ValueError, match="shapes do not match"):
        predict_lpc(x, q, s, s, 4, slow_rows=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="order 33 exceeds"):
        tap_bucket(33)


# ---------------------------------------------------------------------------
# BatchDecoder
# ---------------------------------------------------------------------------

def _music(rng, n, channels, bps):
    t = np.arange(n)
    amp = 1 << (bps - 3)
    return np.stack([amp * np.sin(t * (0.01 + 0.004 * c))
                     + rng.integers(-(amp >> 6), amp >> 6, n)
                     for c in range(channels)]).T.reshape(-1).astype(np.int32)


def _stream(inter, opts, rate, bps, channels, total):
    buf = io.BytesIO()
    enc = FlacSampleWriter(buf, opts, rate, bps, channels,
                           total_samples=total)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue()


# name: (options, rate, bps, channels, frames + extra samples, total known,
# seek target or None)
_STREAMS = {
    "stereo16_best": (Options.best(), 44100, 16, 2, (5, 0), True, None),
    "stereo24": (Options(block_size=1152), 96000, 24, 2, (6, 0), True,
                 None),
    "mono16": (Options.best(), 44100, 16, 1, (4, 0), True, None),
    "unknown_total": (Options(block_size=1024), 44100, 16, 2, (7, 300),
                      False, None),
    "short_tail": (Options.best(), 44100, 16, 2, (5, 1234), True, None),
    "seek": (Options(block_size=1024), 48000, 16, 2, (9, 500), True, 5000),
}


@functools.lru_cache(maxsize=16)
def _jax_decode(data, batch_frames, seek=None):
    dec = JaxDecoder(io.BytesIO(data), batch_frames=batch_frames)
    if seek is not None:
        dec.seek(seek)
    out = np.asarray(dec.read_all_device(), dtype=np.int64)
    dec.close()
    return out


def _case_stream(case):
    """(stream, its interleaved samples, options, samples) of a case."""
    opts, rate, bps, channels, (frames, extra), with_total, _ = _STREAMS[case]
    n = opts.block_size * frames + extra
    inter = _music(np.random.default_rng(len(case)), n, channels, bps)
    data = _stream(inter, opts, rate, bps, channels,
                   n if with_total else None)
    return data, inter, opts, n


# the stream as a BytesIO with the host parse under the case's own name;
# then each kind of source a reader fills from ("bytesio" lends its
# bytes, "file" and "unseekable" are read a MiB at a time, the second
# refusing a seek), with the host and the device parse
SOURCES = ("bytesio", "file", "unseekable")
_DECODES = [pytest.param(c, "bytesio", False, id=c) for c in sorted(_STREAMS)]
_DECODES += [pytest.param(c, src, dp, id=f"{c}-{src}-{('host', 'device')[dp]}")
             for c in sorted(_STREAMS) for src in SOURCES for dp in (0, 1)
             if (src, dp) != ("bytesio", 0)]


@pytest.mark.parametrize("case,source,device_parse", _DECODES)
def test_batch_decoder_matches_jax(case, source, device_parse, open_as):
    _, _, _, channels, (frames, extra), with_total, seek = _STREAMS[case]
    data, inter, opts, n = _case_stream(case)
    with BatchDecoder(open_as(source, data), batch_frames=2, device="cpu",
                      device_parse=bool(device_parse)) as dec:
        if seek is not None and source == "unseekable":
            with pytest.raises(NotSeekable):
                dec.seek(seek)
            seek = None
        start = 0 if seek is None else dec.seek(seek)
        got = dec.read_all_device()
        device_frames, host_frames = dec.device_frames, dec.host_frames
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    got = got.numpy().astype(np.int64)
    np.testing.assert_array_equal(got, _jax_decode(data, 2, seek))
    np.testing.assert_array_equal(got.reshape(-1),
                                  inter[start * channels:])
    assert device_frames + host_frames == -(-(n - start) // opts.block_size)
    assert device_frames >= frames - 1 - (start // opts.block_size)
    if extra and with_total:
        assert host_frames >= 1        # the short tail


@pytest.mark.parametrize("source", SOURCES)
def test_host_decoder_frames_then_seek_match_jax(source, open_as):
    """``Decoder.read_frame`` (whose first Rice run fills the reader),
    then ``seek`` back to the stream's one seek point (a new reader over
    the same source), frame by frame as the JAX package's host decoder
    reads them."""
    data, _, _, _ = _case_stream("seek")
    target = _STREAMS["seek"][-1]
    port, ref = Decoder(open_as(source, data)), JaxHostDecoder(
        io.BytesIO(data))
    for _ in range(3):
        np.testing.assert_array_equal(port.read_frame(), ref.read_frame())
    if source == "unseekable":
        with pytest.raises(NotSeekable):
            port.seek(target)
    else:
        assert port.seek(target) == ref.seek(target) == 0
    while True:
        got, want = port.read_frame(), ref.read_frame()
        if want is None:
            assert got is None
            break
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_stream_matches_manifest_and_jax(name):
    with open(os.path.join(CORPUS, name), "rb") as fp:
        data = fp.read()
    with BatchDecoder(io.BytesIO(data), batch_frames=4, device="cpu") as dec:
        got = dec.read_all_device().numpy().astype(np.int64)
    flat = got.reshape(-1)     # interleaved, as the manifest counts them
    assert len(flat) == MANIFEST[name]["total_samples"]
    assert hashlib.md5(flat.astype("<i8").tobytes()).hexdigest() \
        == MANIFEST[name]["pcm_md5"], name
    np.testing.assert_array_equal(got, _jax_decode(data, 4))


def _mesh_decode(data, mesh, device_parse):
    with BatchDecoder(io.BytesIO(data), batch_frames=4, device="cpu",
                      mesh=mesh, device_parse=device_parse) as dec:
        got = dec.read_all_device()
    return got.numpy().astype(np.int64), dec


def test_mesh_with_device_parse_decodes_through_the_host_parse():
    """``mesh`` with ``device_parse=True`` decodes as the JAX package
    does: the device parse is off, the host parse fills each batch, the
    shards reconstruct it, and the PCM is the input's, the unsharded
    device-parse decode's and the JAX decoder's."""
    from flac_codec_tpu.parallel.mesh import batch_mesh as jax_batch_mesh

    opts = Options(block_size=1024)
    n = 1024 * 11 + 300
    inter = _music(np.random.default_rng(15), n, 2, 16)
    data = _stream(inter, opts, 44100, 16, 2, n)
    got, dec = _mesh_decode(data, ["cpu", "cpu"], True)
    assert not dec._device_parse
    assert dec.device_frames == 11 and dec.host_frames == 1
    assert dec.parse_fallbacks == 0
    np.testing.assert_array_equal(got.reshape(-1), inter)
    alone, adec = _mesh_decode(data, None, True)
    assert adec._device_parse
    np.testing.assert_array_equal(got, alone)
    with JaxDecoder(io.BytesIO(data), batch_frames=4, device_parse=True,
                    mesh=jax_batch_mesh(jax.devices("cpu"))) as jdec:
        assert not jdec._device_parse
        want = np.asarray(jdec.read_all_device(), dtype=np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]])
def test_variable_block_stream_with_device_parse_decodes_on_the_host(mesh):
    """A variable-block-size stream with ``device_parse=True`` keeps the
    host parse, with a mesh or without: its PCM is the manifest's."""
    name = "variable-blocksize.flac"
    with open(os.path.join(CORPUS, name), "rb") as fp:
        data = fp.read()
    got, dec = _mesh_decode(data, mesh, True)
    assert not dec._device_parse and dec.device_frames == 0
    flat = got.reshape(-1)
    assert len(flat) == MANIFEST[name]["total_samples"]
    assert hashlib.md5(flat.astype("<i8").tobytes()).hexdigest() \
        == MANIFEST[name]["pcm_md5"]


def test_batch_decoder_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchDecoder(io.BytesIO(b""), device="cuda")


@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 6)])
def test_flac2wav_matches_jax_tpu(tmp_path, bps, channels):
    # more frames than one 256-frame batch, and a short tail
    opts = Options(block_size=32)
    n = 32 * 300 + 7
    inter = _music(np.random.default_rng(bps + channels), n, channels, bps)
    src = tmp_path / "in.flac"
    src.write_bytes(_stream(inter, opts, 48000, bps, channels, n))
    jax_out, port_out = tmp_path / "jax.wav", tmp_path / "port.wav"
    assert jax_flac2wav.main([str(src), "-o", str(jax_out), "--tpu"]) == 0
    assert port_main(["flac2wav", str(src), "-o", str(port_out),
                      "--device", "cpu"]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert len(port_out.read_bytes()) > n * channels * (bps // 8)


def test_flac2wav_reports_bad_input(tmp_path, capsys):
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"not a flac stream")
    assert port_main(["flac2wav", str(bad), "--device", "cpu"]) == 1
    assert str(bad) in capsys.readouterr().err
