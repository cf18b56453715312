"""Batched decode pipeline: FLAC -> PCM tensors on the device.

Counterpart of ``flac_codec_tpu/parallel/batch_decode.py`` on its default
path.  The native engine parses and CRC-checks a batch of frames on the
host and extracts each subframe raw (warm-ups plus residuals, predictor
parameters); the device runs the inverse predictors, applies the
wasted-bits shift and inverts the stereo decorrelation, so the decoded
PCM stays in device memory.  A batch is reconstructed in one of two modes
(:func:`_mode_taps`): ``"fixed"``, the cumsum inverse
``predict_fixed_batch``, where every subframe is FIXED-compatible, else
``"lpc"``, the ``predict_lpc`` kernel with the smallest tap bucket that
covers the batch's largest order, exact in int64 on every input (the JAX
package's ``"scan"`` and ``"pallas"`` modes, and the gate between them).

``device_parse=True`` (off by default, as in the JAX package) moves the
Rice parse to the device for fixed-block-size streams of at most 24 bits.
Both decoders then run one batch step, :func:`_device_parse_batch`: the
native ``scan_frames`` finds the frame bodies and checks their CRCs, the
bodies are staged in one pinned buffer (:func:`_stage_bodies`), one copy
uploads them, ``parse_frame_bodies`` (K4) parses them, the gate's download
is the step's one synchronisation, and the reconstruction follows on the
device.  A batch the scan cannot start or the gate refuses goes to the
host parse, which raises the precise error or decodes it
(``parse_fallbacks``).  A frame the host decodes alone (a short tail, the
frame where the parsers stop) goes through one tail, :func:`_host_frame`:
the native decoder first, ``Decoder.read_frame`` where that one stops.
``host_frames`` counts them and variable-block-size streams' frames,
``device_frames`` the frames reconstructed on the device.  The host
parse runs a batch's frames in contiguous spans on the host's cores
(native ``parse_frames_raw``); ``threaded_batches`` counts the batches
it parsed on two or more, and each ``decode.parse`` span notes ``spans``.

With ``mesh`` (``parallel.mesh``) the host parse fills each batch, each
device reconstructs one contiguous shard of it on a stream of its own,
and the shards are gathered in order onto the mesh's first device; the
device parse is off there, as in the JAX package.

The JAX package jits the device parse (``parse_frame_bodies``,
``parse_gate``) and ``_device_reconstruct``; here each is a CUDA graph
(``graphs.CapturedGraph``: ``ops.framescan.ParseGraph``,
:class:`ReconstructGraph`) captured once per device, stream and
configuration and replayed once per batch, and the CPU and
``graphs=False`` run the same batches eagerly.  Every batch is padded to
a frame bucket (:func:`frame_bucket`, the JAX decoder's rule) with
all-zero rows, which parse and reconstruct to zeros and which the gate
leaves out; the JAX package pads only its device parse, but a graph per
distinct short batch would keep a graph's memory for one batch.  The
parse reads a byte buffer of a few capacities
(``ops.framescan.byte_capacity``).  Real rows are read out of a graph's
static output on its stream, which the caller's current stream then
waits for, so the returned tensor is the caller's.

:class:`MultiStreamDecoder` (the port's own) packs whole frames of
consecutive short streams into each batch of the same step, and places
the rows by (stream, frame) in one zero-padded tensor.  Not ported: the
``FLAC_TPU_PALLAS`` / ``FLAC_TPU_NO_PALLAS`` / ``FLAC_TPU_DEVICE_PARSE``
switches.
"""

from __future__ import annotations

import collections
import io
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import metadata as meta
from .. import native
from ..decode import Decoder
from ..graphs import CapturedGraph
from ..ops.framescan import (byte_capacity, parse_batch, parse_graph,
                             upload_views)
from ..ops.predict import fixed_compatible_mask, predict_fixed_batch
from ..ops.predict_pallas import predict_lpc, tap_bucket
from ..utils import trace
from .mesh import batch_mesh, on_stream, shard_streams

# the inputs of _device_reconstruct, in its order; a reconstruct blob
# holds them as int32, one after another
RECON_KEYS = ("buf", "qcoeffs", "shift", "order", "wasted", "assignment")


def frame_bucket(n: int, batch_frames: int) -> int:
    """The padded length of an n-frame batch: ``batch_frames`` halved
    while the half still holds the batch and the bucket is above 64 (the
    JAX decoder's rule, with ``batch_frames`` in the place of ``LANES``),
    so a stream meets a few batch shapes."""
    bucket = batch_frames
    while bucket // 2 >= n and bucket > 64:
        bucket //= 2
    return bucket


def recon_len(B: int, C: int, N: int) -> int:
    """int32 elements of a (B, C, N) reconstruct blob."""
    return B * C * (N + 35) + B


def recon_views(blob: torch.Tensor, B: int, C: int, N: int) -> tuple:
    """The six inputs of :func:`_device_reconstruct` (``RECON_KEYS``)
    inside a flat int32 ``blob`` of ``recon_len(B, C, N)``, as views."""
    out, lo = [], 0
    for shape in ((B, C, N), (B, C, 32), (B, C), (B, C), (B, C), (B,)):
        size = int(np.prod(shape))
        out.append(blob[lo:lo + size].view(shape))
        lo += size
    return tuple(out)


def _device_reconstruct(buf, qcoeffs, shift, order, wasted, assignment,
                        mode: str, taps: int = 32) -> torch.Tensor:
    """(B, C, N) raw subframes -> (B, C, N) int32 PCM, on their device.

    buf int32; qcoeffs (B, C, 32) int32; shift, order, wasted (B, C) and
    assignment (B,) integer tensors.  ``mode`` "fixed" takes the cumsum
    inverse (every row must be FIXED-compatible); "lpc" the kernel.
    """
    B, C, N = buf.shape
    flat = buf.reshape(B * C, N)
    order = order.reshape(B * C).to(torch.int32)
    if mode == "fixed":
        out = predict_fixed_batch(flat, order)
    elif mode == "lpc":
        out = predict_lpc(flat.contiguous(),
                          qcoeffs.reshape(B * C, -1).contiguous(),
                          shift.reshape(B * C).to(torch.int32), order, taps)
    else:
        raise ValueError(f"unknown reconstruct mode {mode!r}")
    out = out << wasted.reshape(B * C, 1).to(torch.int64)
    return _decorrelate(out.reshape(B, C, N), assignment, C)


def _decorrelate(out: torch.Tensor, assignment: torch.Tensor,
                 C: int) -> torch.Tensor:
    """Inverse stereo decorrelation in int64, then int32
    (reference decorrelation: src/decode.rs:1512-1625)."""
    if C == 2:
        a = assignment.to(torch.int32)[:, None, None]
        c0, c1 = out[:, 0], out[:, 1]
        left_side = torch.stack([c0, c0 - c1], dim=1)
        side_right = torch.stack([c0 + c1, c1], dim=1)
        total = c0 * 2 + (c1.abs() % 2)
        mid_side = torch.stack([(total + c1) >> 1, (total - c1) >> 1], dim=1)
        out = torch.where(a == 0b1000, left_side,
                          torch.where(a == 0b1001, side_right,
                                      torch.where(a == 0b1010, mid_side,
                                                  out)))
    return out.to(torch.int32)


class _Staging:
    """The host side of a decoder's uploads: on CUDA one pinned uint8
    buffer, reused once the copies queued out of it have left it; on the
    CPU a new buffer each time."""

    def __init__(self, cuda: bool):
        self._cuda = cuda
        self._buf = None
        self._events = []

    def take(self, nbytes: int) -> torch.Tensor:
        """A host uint8 buffer of ``nbytes``, after the wait for the last
        copies out of it (the ``decode.stage_wait`` span)."""
        with trace.stage("decode.stage_wait"):
            for event in self._events:
                event.synchronize()
        self._events = []
        if not self._cuda:
            return torch.empty(nbytes, dtype=torch.uint8)
        if self._buf is None or len(self._buf) < nbytes:
            self._buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf[:nbytes]

    def copied(self, stream) -> None:
        """Note that a copy out of the buffer is queued on ``stream``."""
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
            self._events.append(event)


def _stage_bodies(staging: _Staging, parts: list, bucket: int,
                  places: list = None) -> tuple:
    """Stage stream ``parts``, [(stream bytes, scan), ...], for the parse
    (``ops.framescan.upload_views`` of ``bucket`` lanes): each scan's
    bytes from its first body to the end of its last, one after another,
    zero up to the byte capacity, and each body's lane (offset rebased
    onto the staged bytes, bit length, assignment), padding lanes zero;
    after them, given ``places``, each part's (stream, first frame), each
    lane's stream and frame (2 x ``bucket`` int64).  Returns (blob, byte
    capacity, places block or None)."""
    spans = [(int(scan["body_off"][0]),
              int(scan["body_off"][-1]) + int(scan["body_bytes"][-1]))
             for _, scan in parts]
    cap = byte_capacity(sum(hi - lo for lo, hi in spans))
    head = 16 * bucket + cap
    host = staging.take(head + (16 * bucket if places else 0))
    data, offs, nbits, assign = (t.numpy()
                                 for t in upload_views(host[:head], bucket))
    where = places and host[head:].view(torch.int64).numpy().reshape(2, -1)
    lane = base = 0
    for i, ((view, scan), (lo, hi)) in enumerate(zip(parts, spans)):
        n = scan["n"]
        offs[lane:lane + n] = scan["body_off"].astype(np.int64) - lo + base
        nbits[lane:lane + n] = scan["body_bytes"] * 8
        assign[lane:lane + n] = scan["assignment"]
        data[base:base + hi - lo] = view[lo:hi]
        if places:
            stream, first = places[i]
            where[0, lane:lane + n] = stream
            where[1, lane:lane + n] = np.arange(first, first + n)
        lane += n
        base += hi - lo
    for dst, end in ((offs, lane), (nbits, lane), (assign, lane),
                     (data, base)):
        dst[end:] = 0
    return host[:head], cap, host[head:] if places else None


def _parse_device(blob, bucket: int, cap: int, block_size: int,
                  channels: int, bits: int, d, s, graphs: bool,
                  staging: _Staging, frames: int) -> tuple:
    """The device parse of a staged ``blob`` of ``bucket`` lanes over
    ``cap`` bytes on device ``d`` and stream ``s``: one copy up, the
    parse graph's replay (eager with ``graphs`` False or on the CPU),
    and the gate's download, the one synchronisation.  Returns (parsed,
    all_ok, order_max, fixed)."""
    with trace.stage("decode.parse_device", frames=frames), on_stream(s):
        if graphs and d.type == "cuda":
            graph = parse_graph(s, bucket, cap, block_size, channels, bits)
            graph.input.copy_(blob, non_blocking=True)
            staging.copied(s)
            parsed, gate = graph.replay()
        else:
            blob = blob.to(d, non_blocking=True)
            staging.copied(s)
            parsed, gate = parse_batch(blob, bucket, block_size, channels,
                                       bits)
        with trace.stage("decode.gate_wait"):
            return (parsed, *gate.tolist())


def _mode_taps(fixed: bool, order_max: int) -> tuple:
    """A batch's reconstruct mode and taps (module docstring)."""
    return ("fixed", 32) if fixed else ("lpc", tap_bucket(int(order_max)))


def _replay_reconstruct(x, shape, mode: str, taps: int, d, s, graphs: bool,
                        staging: _Staging) -> torch.Tensor:
    """:func:`_device_reconstruct` of a (B, C, N) ``shape`` on device ``d``
    and stream ``s``, made current by the caller: the graph's replay with
    ``graphs`` on CUDA, whose static output is read on ``s`` before its
    next replay, else eager.  ``x``: the six inputs on the device (a
    device parse's), or a reconstruct blob staged on the host."""
    staged = not isinstance(x, tuple)
    if graphs and d.type == "cuda":
        graph = reconstruct_graph(s, shape, mode, taps)
        if staged:
            graph.input.copy_(x, non_blocking=True)
            staging.copied(s)
        else:
            for dst, src in zip(recon_views(graph.input, *shape), x):
                dst.copy_(src)
        return graph.replay()
    if staged:
        x = recon_views(x.to(d, non_blocking=True), *shape)
        staging.copied(s)
    return _device_reconstruct(*x, mode=mode, taps=taps)


def _device_parse_batch(parts: list, fmt: tuple, batch_frames: int, shard,
                        graphs: bool, staging: _Staging, take,
                        places: list = None, req: int = None):
    """The device-parse batch of both decoders: stream ``parts`` staged
    (:func:`_stage_bodies`, in ``decode.upload``), parsed on the
    ``shard``'s device and stream (d, s) and reconstructed there as
    (bucket, C, N) of ``fmt`` (C, bits, N); ``take(out, places)`` reads
    the real rows in ``decode.reconstruct`` and gives the result (never
    None).  None where the gate refuses the batch."""
    C, bits, N = fmt
    d, s = shard
    n = sum(scan["n"] for _, scan in parts)
    bucket = frame_bucket(n, batch_frames)
    with trace.stage("decode.upload", req=req, frames=n):
        blob, cap, where = _stage_bodies(staging, parts, bucket, places)
    parsed, all_ok, order_max, fixed = _parse_device(
        blob, bucket, cap, N, C, bits, d, s, graphs, staging, n)
    if not all_ok:
        return None
    mode, taps = _mode_taps(fixed, order_max)
    with trace.stage("decode.reconstruct", req=req, frames=n, mode=mode):
        with on_stream(s):
            out = _replay_reconstruct(tuple(parsed[k] for k in RECON_KEYS),
                                      (bucket, C, N), mode, taps, d, s,
                                      graphs, staging)
        return take(out, where)


def _host_frame(nat, dec: Decoder, left: int | None, req: int = None):
    """The frame at ``dec``'s reader as (channels, samples) int32, None at
    the end of the stream, decoded on the host (``decode.host_frame``):
    by the native decoder, and where that one stops by
    ``Decoder.read_frame``, which raises the precise error.  ``left``:
    the samples left, None if unknown.  Moves the reader past it."""
    si = dec.streaminfo
    with trace.stage("decode.host_frame", req=req):
        out, sizes, end, _ = nat.decode_frames(
            dec.r.np_view(), dec.r.pos, 1, si.sample_rate, si.channels,
            si.bits_per_sample, si.maximum_block_size or 65535, left,
            nthreads=1)
        if len(sizes) == 0:
            return dec.read_frame()
        dec.r.pos = end
        dec.current_sample += int(sizes[0])
        return np.ascontiguousarray(out.reshape(-1, si.channels).T)


def _device(device, who: str) -> torch.device:
    """A decoder's ``device``: CUDA where it is available, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _shard_sizes(rows: int, shards: int) -> list:
    """Rows of each shard when ``rows`` are cut into ``shards``
    contiguous chunks (``torch.tensor_split``'s sizes)."""
    q, r = divmod(rows, shards)
    return [q + (i < r) for i in range(shards)]


class ReconstructGraph(CapturedGraph):
    """:func:`_device_reconstruct` of a (B, C, N) batch on ``stream``,
    captured once (``graphs.CapturedGraph``) with one static int32
    ``input`` blob (:func:`recon_views`): the counterpart of the JAX
    decoder's jitted ``_device_reconstruct``."""

    def __init__(self, stream, shape, mode: str, taps: int):
        super().__init__(
            lambda blob: _device_reconstruct(*recon_views(blob, *shape),
                                             mode=mode, taps=taps),
            lambda: torch.zeros(recon_len(*shape), dtype=torch.int32,
                                device=stream.device),
            stream, shape=tuple(shape), mode=mode, taps=taps)


# every reconstruct graph of the process, by reconstruct_graph's key
RECONSTRUCT_GRAPHS: dict = {}


def reconstruct_graph(stream, shape, mode: str, taps: int) -> ReconstructGraph:
    """The :class:`ReconstructGraph` for a (B, C, N) ``shape``, ``mode``
    and ``taps``, captured on first use; keyed as JAX's jit (``limbs`` and
    ``mesh`` not ported), and by device and stream."""
    key = (stream.device, stream.cuda_stream, tuple(shape), mode, taps)
    graph = RECONSTRUCT_GRAPHS.get(key)
    if graph is None:
        graph = RECONSTRUCT_GRAPHS[key] = ReconstructGraph(stream, shape,
                                                           mode, taps)
    return graph


class BatchDecoder:
    """Decode a FLAC stream in frame batches on ``device``.

    ``device="cuda"`` without CUDA raises, and so does a native engine
    that does not build; ``device="cpu"`` runs the same pipeline with the
    kernels' plain versions.  Decoded batches are int32 tensors on
    ``device``.  The positional parameters are the JAX package's;
    ``device`` and ``graphs`` are keyword-only.  ``device_parse`` parses
    the frame bodies on the device (None, the default, means off:
    ``FLAC_TPU_DEVICE_PARSE`` is not read); ``mesh``
    (``parallel.mesh.batch_mesh``) shards the reconstruction over its
    devices and leaves the PCM on the first, ``device`` unread.
    ``graphs=False`` runs each batch eagerly instead of as graph
    replays, the counterpart of ``jax.disable_jit()`` (the CPU always
    runs eagerly).  A failed capture or replay raises.
    """

    def __init__(self, fp_or_path, batch_frames: int = 256, mesh=None,
                 device_parse: bool | None = None, *, device="cuda",
                 graphs: bool = True):
        self.mesh = None if mesh is None else batch_mesh(mesh)
        if self.mesh is not None:
            self.device, devices = self.mesh[0], self.mesh
        else:
            self.device = _device(device, "BatchDecoder")
            devices = batch_mesh([self.device])
        # a device and a process-wide stream per shard (one without a
        # mesh), so later decoders replay the same graphs
        self._shards = list(zip(devices, shard_streams(devices)))
        self.graphs = graphs
        self._nat = native.load()
        self._owns_fp = isinstance(fp_or_path, (str, bytes))
        if self._owns_fp:
            fp_or_path = open(fp_or_path, "rb")
        try:
            self.decoder = Decoder(fp_or_path)
        except BaseException:
            if self._owns_fp:
                fp_or_path.close()
            raise
        self.batch_frames = batch_frames
        si = self.decoder.streaminfo
        self.block_size = si.maximum_block_size
        self._fixed_blocks = (si.minimum_block_size == si.maximum_block_size
                              and si.maximum_block_size > 0)
        self._device_parse = (bool(device_parse) and self._fixed_blocks
                              and si.bits_per_sample <= 24
                              and self.mesh is None)
        # the pinned upload buffer (on CUDA) and its last copies' events
        self._staging = _Staging(any(d.type == "cuda" for d in devices))
        # real frames reconstructed on the device, frames the host
        # decoded, batches the device parse handed to the host parse, and
        # host parses that ran on two or more threads
        self.device_frames = 0
        self.host_frames = 0
        self.parse_fallbacks = 0
        self.threaded_batches = 0
        # this decoder's spans' request id
        self.request_id = trace.new_request()
        self._profiler = trace.profiler_session("batch-decode",
                                                self.request_id)
        self._profiler.__enter__()

    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self.decoder.streaminfo

    def seek(self, sample: int) -> int:
        """Position at the nearest decodable frame boundary <= ``sample``
        (via SEEKTABLE when present); returns the sample actually seeked
        to — the caller discards ``sample - actual`` leading samples."""
        return self.decoder.seek(sample)

    def close(self) -> None:
        """Close an owned file, end the profiler session and write the
        trace's records (the ``decode.close`` span)."""
        with trace.stage("decode.close", req=self.request_id, flush=True):
            if self._owns_fp:
                self.decoder.fp.close()
            if self._profiler is not None:
                self._profiler.__exit__(None, None, None)
                self._profiler = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _remaining(self) -> int | None:
        dec = self.decoder
        total = dec.total_samples
        return None if total is None else total - dec.current_sample

    def _host_frame(self):
        """A frame decoded by :func:`_host_frame`, as a batch of one."""
        frame = _host_frame(self._nat, self.decoder, self._remaining(),
                            self.request_id)
        if frame is None:
            return None
        self.host_frames += 1
        return (torch.from_numpy(frame[None]).to(self.device),
                np.array([frame.shape[1]]))

    def _read_batch_bulk_host(self, remaining: int | None):
        """Variable-block-size streams: decode a whole batch with one
        native bulk call (which handles per-frame sizes) and upload the
        batch, padded to its largest frame."""
        dec = self.decoder
        si = dec.streaminfo
        max_block = si.maximum_block_size or 65535
        with trace.stage("decode.bulk_host", req=self.request_id,
                         frames=self.batch_frames):
            out, sizes, end, err = self._nat.decode_frames(
                dec.r.np_view(), dec.r.pos, self.batch_frames,
                si.sample_rate, si.channels, si.bits_per_sample,
                max_block, remaining, nthreads=1)
        if len(sizes) == 0:
            # error or EOF: the Python path raises the precise error
            return self._host_frame()
        dec.r.pos = end
        dec.current_sample += int(sizes.sum())
        C = si.channels
        pcm = np.zeros((len(sizes), C, int(sizes.max())), np.int32)
        cuts = np.cumsum(sizes[:-1].astype(np.int64)) * C
        for b, x in enumerate(np.split(out, cuts)):
            pcm[b, :, :len(x) // C] = x.reshape(-1, C).T
        self.host_frames += len(sizes)
        return torch.from_numpy(pcm).to(self.device), sizes

    def _read_batch_device_parse(self, remaining: int | None):
        """The native scan of the batch's frames, then
        :func:`_device_parse_batch`: (pcm, blocks), or None with the
        reader untouched where the scan finds no frame (a short tail, a
        damaged frame) or the gate refuses the batch."""
        dec = self.decoder
        si = dec.streaminfo
        view = dec.r.np_view()
        with trace.stage("decode.scan", req=self.request_id,
                         frames=self.batch_frames):
            scan = self._nat.scan_frames(
                view, dec.r.pos, self.batch_frames, si.sample_rate,
                si.channels, si.bits_per_sample, self.block_size, remaining)
            trace.note("decode.scan", simd=self._nat.scan_simd)
        B = scan["n"]
        # an empty body would look like a padding lane to the gate: the
        # host parse raises its error
        if B == 0 or not scan["body_bytes"].all():
            return None
        (d, s), = self._shards
        pcm = _device_parse_batch(
            [(view, scan)], (si.channels, si.bits_per_sample,
                             self.block_size), self.batch_frames, (d, s),
            self.graphs, self._staging,
            lambda out, _: self._take(out, B, d, s), req=self.request_id)
        if pcm is None:
            return None
        dec.r.pos = scan["end_bitpos"]
        dec.current_sample += int(scan["blocks"].sum())
        self.device_frames += B
        return pcm, scan["blocks"]

    def read_batch_device(self):
        """Decode up to batch_frames frames; returns a (B, channels,
        block_size) int32 tensor on the device and the per-frame sample
        counts, or None at end of stream.  A short tail, and a frame the
        native parser stops at, go to the host decoder.  The tensor is
        the caller's: later batches do not write to it.  The call is
        the ``decode.read`` span, parent of the batch's stage spans."""
        with trace.stage("decode.read", req=self.request_id,
                         self_record=True):
            return self._read_batch()

    def _read_batch(self):
        remaining = self._remaining()
        if remaining is not None and remaining <= 0:
            return None
        if not self._fixed_blocks:
            return self._read_batch_bulk_host(remaining)
        if self._device_parse:
            got = self._read_batch_device_parse(remaining)
            if got is not None:
                return got
            self.parse_fallbacks += 1
        dec = self.decoder
        si = dec.streaminfo
        with trace.stage("decode.parse", req=self.request_id,
                         frames=self.batch_frames):
            raw = self._nat.parse_frames_raw(
                dec.r.np_view(), dec.r.pos, self.batch_frames,
                si.sample_rate, si.channels, si.bits_per_sample,
                self.block_size, remaining)
            trace.note("decode.parse", spans=raw["spans"])
        self.threaded_batches += raw["spans"] >= 2
        n = raw["n"]
        if n == 0:
            # tail / error: host path (raises precise errors)
            return self._host_frame()
        dec.r.pos = raw["end_bitpos"]
        dec.current_sample += int(raw["blocks"].sum())

        mode, taps = _mode_taps(
            fixed_compatible_mask(raw["qcoeffs"].reshape(-1, 32),
                                  raw["shift"].reshape(-1),
                                  raw["order"].reshape(-1)).all(),
            raw["order"].max())
        with trace.stage("decode.reconstruct", req=self.request_id,
                         frames=n, mode=mode):
            pcm = self._reconstruct(raw, n, mode, taps)
        self.device_frames += n
        return pcm, raw["blocks"]

    def _take(self, out, m: int, d, s) -> torch.Tensor:
        """The first ``m`` rows of ``out`` (device ``d``), read on its
        stream ``s`` and handed to the first device's current stream; a
        graph's static output is copied out before the next replay."""
        home = self._shards[0][0]
        with on_stream(s):
            part = (out[:m].clone() if self.graphs and d == home
                    and d.type == "cuda" else out[:m].to(home))
        if home.type == "cuda":
            consumer = torch.cuda.current_stream(home)
            if s is not None:
                consumer.wait_stream(s)
            part.record_stream(consumer)
        return part

    def _reconstruct(self, raw: dict, n: int, mode: str,
                     taps: int) -> torch.Tensor:
        """The PCM of the ``n`` frames of a host parse ``raw``, padded to
        their bucket and cut into one shard a mesh entry, each staged as a
        reconstruct blob (padding rows zero) in one host buffer, then
        reconstructed where it holds a real frame and taken in order."""
        C, N = self.streaminfo.channels, self.block_size
        sizes = _shard_sizes(frame_bucket(n, self.batch_frames),
                             len(self._shards))
        host = self._staging.take(4 * sum(recon_len(b, C, N) for b in sizes))
        host = host.view(torch.int32)
        parts, lo, first = [], 0, 0
        for (d, s), b in zip(self._shards, sizes):
            blob = host[lo:lo + recon_len(b, C, N)]
            m = min(max(n - first, 0), b)
            for dst, k in zip(recon_views(blob, b, C, N), RECON_KEYS):
                dst = dst.numpy()
                dst[:m] = raw[k][first:first + m]
                dst[m:] = 0
            lo, first = lo + len(blob), first + b
            if m == 0:
                continue
            with on_stream(s):
                out = _replay_reconstruct(blob, (b, C, N), mode, taps, d, s,
                                          self.graphs, self._staging)
            parts.append(self._take(out, m, d, s))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def read_batch_interleaved(self):
        """One decoded batch as a (samples, channels) int32 tensor on the
        device with padding trimmed, or None at end of stream."""
        got = self.read_batch_device()
        if got is None:
            return None
        pcm, blocks = got
        blocks = np.asarray(blocks)
        N = pcm.shape[2]
        if (blocks[:-1] == N).all():
            # fixed-size batch (at most a short LAST frame — FLAC's
            # only-last-frame-short invariant): one reshape + tail trim
            flat = pcm.transpose(1, 2).reshape(-1, pcm.shape[1])
            return flat[:int(blocks.sum())]
        # variable-block batch: per-frame trim
        return torch.cat([pcm[b, :, :int(n)].T for b, n in enumerate(blocks)])

    def read_all_device(self) -> torch.Tensor:
        """Whole stream as one (total, channels) int32 tensor on the
        device."""
        parts = []
        while True:
            flat = self.read_batch_interleaved()
            if flat is None:
                break
            parts.append(flat)
        if not parts:
            return torch.zeros((0, self.streaminfo.channels),
                               dtype=torch.int32, device=self.device)
        return torch.cat(parts)


@dataclass(eq=False)
class _Stream:
    """One source of a :meth:`MultiStreamDecoder.decode` call."""
    index: int           # its row of the output
    fp: object           # the binary file object, seekable
    owned: bool          # opened from a path by the call
    start: int           # fp's position at the stream's first byte
    decoder: Decoder
    view: np.ndarray = None   # the frames' bytes (device format only)
    pos: int = 0         # bit position of its next whole frame
    whole: int = 0       # its whole frames
    done: int = 0        # whole frames packed into device batches

    @property
    def length(self) -> int:
        return self.decoder.total_samples


class MultiStreamDecoder:
    """Decode many FLAC streams on ``device`` into one zero-padded batch.

    :meth:`decode` takes a list of binary file objects or paths and
    returns ``(pcm, lengths)``: a (U, channels, max_samples) int32 tensor
    on the device, zero past each stream's length (and past its channels,
    where streams of fewer channels are mixed in), and a (U,) int64
    tensor of the streams' lengths.

    The call's device format is that of its first stream the device parse
    can take: a fixed block size, at most 24 bits, a known length.  The
    whole frames of the streams of that format are packed in order into
    batches of at most ``batch_frames`` frames, a stream straddling two
    batches where it must; each batch is a native ``scan_frames`` a
    stream part and :func:`_device_parse_batch`, whose rows one index
    copy puts in their (stream, frame) places, staged beside the bytes.
    Each stream's short last frame is decoded by :func:`_host_frame`, and
    the call's tails and lengths go up in one copy.  A stream of another
    format, or whose whole frames the scan does not find, is decoded
    alone by a :class:`BatchDecoder` with the device parse
    (``stream_fallbacks``); the streams of a batch the gate refuses,
    alone by its host parse (``parse_fallbacks``).  So the result stays
    exact, and a damaged stream raises what ``BatchDecoder`` raises.

    One request id, profiler session and flush of the trace a call (the
    ``decode.streams`` span); the pinned buffer and the graphs live as
    long as the decoder.  ``device`` is checked as in
    :class:`BatchDecoder`; the CPU runs the batches eagerly, as
    ``graphs=False`` does on CUDA.  The counters are summed over calls.
    """

    def __init__(self, batch_frames: int = 256, device="cuda",
                 graphs: bool = True):
        self.device = _device(device, "MultiStreamDecoder")
        self._shard_stream, = shard_streams([self.device])
        self.batch_frames = batch_frames
        self.graphs = graphs
        self._nat = native.load()
        self._staging = _Staging(self.device.type == "cuda")
        # streams decoded; frames reconstructed on the device and decoded
        # on the host; device batches, and the streams each holds frames
        # of, summed; batches whose gate failed; streams decoded alone
        self.streams = 0
        self.device_frames = 0
        self.host_frames = 0
        self.device_batches = 0
        self.batch_streams = 0
        self.parse_fallbacks = 0
        self.stream_fallbacks = 0

    def decode(self, sources) -> tuple:
        """(pcm, lengths) of ``sources`` (class docstring); the call is
        the ``decode.streams`` span."""
        sources = list(sources)
        req = trace.new_request()
        with trace.profiler_session("multi-stream-decode", req), \
                trace.stage("decode.streams", req=req, flush=True,
                            streams=len(sources)):
            streams = []
            try:
                for i, src in enumerate(sources):
                    streams.append(self._open(i, src))
                return self._decode(streams)
            finally:
                for st in streams:
                    if st.owned:
                        st.fp.close()

    def _open(self, index: int, src) -> _Stream:
        """A stream's metadata, and the rest of it as one buffer (the
        ``decode.fill`` span) where it can take the device parse (the
        ``decode.open`` span)."""
        with trace.stage("decode.open"):
            owned = isinstance(src, (str, bytes, os.PathLike))
            fp = open(src, "rb") if owned else src
            try:
                if not fp.seekable():
                    fp = io.BytesIO(fp.read())
                st = _Stream(index, fp, owned, fp.tell(), Decoder(fp))
            except BaseException:
                if owned:
                    fp.close()
                raise
            si = st.decoder.streaminfo
            if (si.minimum_block_size == si.maximum_block_size > 0
                    and si.bits_per_sample <= 24 and st.length is not None):
                st.view = st.decoder.r.np_view()
                st.pos = st.decoder.r.pos
                st.whole = st.length // si.maximum_block_size
            return st

    @staticmethod
    def _format(st: _Stream) -> tuple:
        si = st.decoder.streaminfo
        return si.channels, si.bits_per_sample, si.maximum_block_size

    def _decode(self, streams: list) -> tuple:
        self.streams += len(streams)
        fmt = next((self._format(st) for st in streams
                    if st.view is not None), None)
        device = [st for st in streams
                  if st.view is not None and self._format(st) == fmt]
        chosen = set(device)
        alone = {st.index: self._alone(st, True) for st in streams
                 if st not in chosen}
        U = len(streams)
        C = max([st.decoder.streaminfo.channels for st in streams],
                default=0)
        S = max([st.length for st in device]
                + [len(x) for x in alone.values()], default=0)
        pcm = torch.zeros((U, C, S), dtype=torch.int32, device=self.device)
        for u, x in alone.items():
            pcm[u, :x.shape[1], :len(x)] = x.T
        redo = {}     # stream -> decode it with the device parse
        s = self._shard_stream
        consumer = (torch.cuda.current_stream(self.device)
                    if s is not None else None)
        if s is not None:
            s.wait_stream(consumer)
        pending = collections.deque(st for st in device if st.whole)
        while pending:
            with trace.stage("decode.read", self_record=True):
                self._batch(pending, redo, pcm, fmt)
        if s is not None:
            consumer.wait_stream(s)
        tails = []
        for st in device:
            # each stream's short last frame, on the host; one that is not
            # the stream's last samples sends the stream to redo
            dec, done = st.decoder, st.whole * fmt[2]
            if st in redo or st.length == done:
                continue
            dec.r.pos, dec.current_sample = st.pos, done
            frame = _host_frame(self._nat, dec, st.length - done)
            if frame is None or dec.current_sample != st.length:
                redo[st] = True
            else:
                self.host_frames += 1
                tails.append((st, frame))
        lengths = [len(alone[st.index]) if st.index in alone else st.length
                   for st in streams]
        with trace.stage("decode.place", tails=len(tails)):
            lengths = self._place(pcm, lengths, tails, fmt[2] if fmt else 0)
        for st, device_parse in redo.items():
            x = self._alone(st, device_parse)
            pcm[st.index, :x.shape[1], :len(x)] = x.T
        return pcm, lengths

    def _batch(self, pending, redo: dict, pcm: torch.Tensor,
               fmt: tuple) -> None:
        """The next batch of ``pending`` streams, its rows placed in
        ``pcm``; streams whose frames the scan does not find, and those of
        a batch the gate refuses, go to ``redo``."""
        C, bits, N = fmt
        parts, n = [], 0
        with trace.stage("decode.scan"):
            while pending and n < self.batch_frames:
                st = pending[0]
                want = min(st.whole - st.done, self.batch_frames - n)
                si = st.decoder.streaminfo
                scan = self._nat.scan_frames(
                    st.view, st.pos, want, si.sample_rate, C, bits, N,
                    st.length - st.done * N)
                if scan["n"] < want or not scan["body_bytes"].all():
                    # a short or empty body: BatchDecoder's host parse
                    # raises its error
                    redo[st] = True
                    pending.popleft()
                    continue
                parts.append((st, scan, st.done))
                st.pos = scan["end_bitpos"]
                st.done += want
                n += want
                if st.done == st.whole:
                    pending.popleft()
            trace.note("decode.scan", frames=n, parts=len(parts),
                       simd=self._nat.scan_simd)
        if not parts:
            return
        d, s = self.device, self._shard_stream

        def place(out, where):
            # the real rows to their (stream, frame) places, read on the
            # graph's stream before its next replay
            U, Cs, S = pcm.shape
            frames = pcm.as_strided((U, S // N, C, N), (Cs * S, N, S, 1))
            with on_stream(s):
                where = where.to(d, non_blocking=True).view(torch.int64)
                self._staging.copied(s)
                u, f = where.view(2, -1)[:, :n]
                return frames.index_put_((u, f), out[:n])

        if _device_parse_batch(
                [(st.view, scan) for st, scan, _ in parts], fmt,
                self.batch_frames, (d, s), self.graphs, self._staging, place,
                places=[(st.index, first) for st, _, first in parts]) is None:
            self.parse_fallbacks += 1
            for st, _, _ in parts:
                redo[st] = False
            if pending and pending[0] is parts[-1][0]:
                pending.popleft()
            return
        self.device_frames += n
        self.device_batches += 1
        self.batch_streams += len(parts)

    def _place(self, pcm: torch.Tensor, lengths: list, tails: list,
               block: int) -> torch.Tensor:
        """Upload the call's ``lengths`` and ``tails``, [(stream, frame),
        ...], in one copy, and put each tail after its stream's whole
        frames of ``block`` samples in ``pcm``; returns the lengths on the
        device."""
        U, Cs, S = pcm.shape
        T = sum(f.size for _, f in tails)
        host = self._staging.take(8 * U + 12 * T)
        host[:8 * U].view(torch.int64).numpy()[:] = lengths
        idx = host[8 * U:8 * (U + T)].view(torch.int64).numpy()
        vals = host[8 * (U + T):].view(torch.int32).numpy()
        lo = 0
        for st, frame in tails:
            c, t = frame.shape
            base = st.index * Cs * S + st.whole * block
            idx[lo:lo + c * t] = (np.arange(c)[:, None] * S
                                  + np.arange(t) + base).reshape(-1)
            vals[lo:lo + c * t] = frame.reshape(-1)
            lo += c * t
        dev = host.to(self.device, non_blocking=True)
        self._staging.copied(torch.cuda.current_stream(self.device)
                             if self.device.type == "cuda" else None)
        if T:
            pcm.view(-1).index_put_(
                (dev[8 * U:8 * (U + T)].view(torch.int64),),
                dev[8 * (U + T):].view(torch.int32))
        return dev[:8 * U].view(torch.int64)

    def _alone(self, st: _Stream, device_parse: bool) -> torch.Tensor:
        """The whole stream through a :class:`BatchDecoder` of its own,
        (samples, channels) int32 on the device."""
        self.stream_fallbacks += device_parse
        st.fp.seek(st.start)
        dec = BatchDecoder(st.fp, self.batch_frames, None, device_parse,
                           device=self.device, graphs=self.graphs)
        try:
            return dec.read_all_device()
        finally:
            dec.close()
            self.device_frames += dec.device_frames
            self.host_frames += dec.host_frames
