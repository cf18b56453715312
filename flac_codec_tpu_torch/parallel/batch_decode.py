"""Batched decode pipeline: FLAC -> PCM tensors on the device.

Counterpart of ``flac_codec_tpu/parallel/batch_decode.py`` on its default
path.  The native engine parses and CRC-checks a batch of frames on the
host and extracts each subframe raw (warm-ups plus residuals, predictor
parameters); the device runs the inverse predictors, applies the
wasted-bits shift and inverts the stereo decorrelation, so the decoded
PCM stays in device memory.

Reconstruction takes one of two modes per batch:
* ``"fixed"``: every subframe is FIXED-compatible, and the k-fold cumsum
  inverse ``predict_fixed_batch`` needs no sequential step;
* ``"lpc"``: the ``predict_lpc`` kernel with the smallest tap bucket that
  covers the batch's largest order.  It is exact in int64 on every input,
  so the JAX package's ``"scan"`` and ``"pallas"`` modes, and the gate
  between them, are one mode here.

Frames the host decodes itself (a short tail, the frame where the native
parser stops, variable-block-size streams) are counted in
``host_frames``; frames reconstructed on the device in ``device_frames``.

``device_parse=True`` (off by default, as in the JAX package) moves the
Rice parse to the device for fixed-block-size streams of at most 24 bits:
the native ``scan_frames`` only finds the frame bodies and checks their
CRCs, one copy uploads the batch's bytes, and ``parse_frame_bodies`` (K4)
parses them.  A batch the scan cannot start or the parser does not take
whole goes to the host parse, which raises the precise error or decodes
it; ``parse_fallbacks`` counts such batches.

With ``mesh`` (``parallel.mesh``) the host parse fills each batch as
before, then each device reconstructs one contiguous shard of its frames
on a stream of its own, and the shards are gathered in order onto the
mesh's first device.  The device parse does not run under a mesh: with
``device_parse=True`` the host parse fills each batch, as the JAX
package turns the device parse off under a mesh.

The JAX package jits the device parse (``parse_frame_bodies`` and
``parse_gate``) and ``_device_reconstruct``.  The counterparts here are
CUDA graphs (``graphs.CapturedGraph``), each captured once per device,
stream and configuration and replayed once per batch:
``ops.framescan.ParseGraph`` and :class:`ReconstructGraph`.  A batch is
padded to a frame bucket (:func:`frame_bucket`, the JAX decoder's rule)
with all-zero rows: lanes of zero bits, which parse to zeros and which
the gate leaves out, and subframes of order, shift and assignment 0,
which reconstruct to zeros and change no real row.  The JAX package pads
only its device parse and compiles the host-parse reconstruction anew for
each batch length; the port pads both, because a graph per distinct
short batch would keep a graph's memory for one batch.  The parse reads
a byte buffer of a few capacities (``ops.framescan.byte_capacity``),
zero past the batch's bytes.  Each batch goes up in one copy out of a
pinned staging buffer into the graph's static input, and its real rows
are copied out of the static output on the graph's stream, which the
caller's current stream then waits for; so the returned tensor is the
caller's, as JAX returns a fresh array.  The gate's download is the one
synchronisation of a device-parse batch.  The CPU, and
``graphs=False``, run the same padded batches eagerly.

:class:`MultiStreamDecoder` (the port's own; the JAX package has none)
decodes many streams in one call into one zero-padded (streams,
channels, samples) tensor, for a loader of short files: a
``BatchDecoder`` batches the frames of one stream only, so a stream of
fifty frames would cost a decoder, a scan and upload, a mostly padded
parse and reconstruct and a gate sync of its own.  It packs whole
frames of consecutive streams into each device-parse batch and runs the
same scan, staging, ``ParseGraph``, gate and ``ReconstructGraph`` as
``BatchDecoder``'s device parse, with the byte blob holding the bodies
of several streams, then places the batch's rows by (stream, frame).

Not ported: the ``FLAC_TPU_PALLAS`` / ``FLAC_TPU_NO_PALLAS`` /
``FLAC_TPU_DEVICE_PARSE`` switches.
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


def _recon_shapes(B: int, C: int, N: int) -> tuple:
    return ((B, C, N), (B, C, 32), (B, C), (B, C), (B, C), (B,))


def recon_len(B: int, C: int, N: int) -> int:
    """int32 elements of a (B, C, N) reconstruct blob."""
    return B * C * (N + 35) + B


def recon_views(blob: torch.Tensor, B: int, C: int, N: int) -> tuple:
    """The six inputs of :func:`_device_reconstruct` (``RECON_KEYS``)
    inside a flat int32 ``blob`` of ``recon_len(B, C, N)``, as views."""
    out, lo = [], 0
    for shape in _recon_shapes(B, C, N):
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


def _body_span(scan: dict) -> tuple:
    """The byte range of a scan's frame bodies: from the first body's
    start to the last body's end."""
    return (int(scan["body_off"][0]),
            int(scan["body_off"][-1]) + int(scan["body_bytes"][-1]))


def _write_bodies(blob: torch.Tensor, bucket: int, bodies: list) -> None:
    """Stage ``bodies``, [(stream bytes, scan), ...], in ``blob`` for the
    parse (``ops.framescan.upload_views`` of ``bucket`` lanes): each
    scan's bytes from its first body to the end of its last, one scan
    after another, and each body's lane (offset rebased onto the staged
    bytes, bit length, assignment) in the same order.  Padding lanes and
    the bytes past the last body are zero."""
    data, offs, nbits, assign = (t.numpy() for t in upload_views(blob, bucket))
    lane = base = 0
    for view, scan in bodies:
        lo, hi = _body_span(scan)
        n = scan["n"]
        offs[lane:lane + n] = scan["body_off"].astype(np.int64) - lo + base
        nbits[lane:lane + n] = scan["body_bytes"] * 8
        assign[lane:lane + n] = scan["assignment"]
        data[base:base + hi - lo] = view[lo:hi]
        lane += n
        base += hi - lo
    for dst, end in ((offs, lane), (nbits, lane), (assign, lane),
                     (data, base)):
        dst[end:] = 0


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
    and ``taps``, captured on first use.  The key is JAX's jit key (the
    shape and the static arguments; ``limbs`` and ``mesh`` are not
    ported) plus the device and stream."""
    key = (stream.device, stream.cuda_stream, tuple(shape), mode, taps)
    graph = RECONSTRUCT_GRAPHS.get(key)
    if graph is None:
        graph = RECONSTRUCT_GRAPHS[key] = ReconstructGraph(stream, shape,
                                                           mode, taps)
    return graph


class BatchDecoder:
    """Decode a FLAC stream in frame batches on ``device``.

    ``device="cuda"`` without CUDA raises, and so does a native engine
    that does not build.  ``device="cpu"`` runs the same pipeline with the
    kernels' plain versions.  Decoded batches are int32 tensors on
    ``device``.  The positional parameters are the JAX package's;
    ``device`` and ``graphs`` are keyword-only.  ``device_parse`` parses
    the frame bodies on the device (None, the default, means off: the
    port does not read ``FLAC_TPU_DEVICE_PARSE``);
    ``mesh`` (``parallel.mesh.batch_mesh``) shards the reconstruction over
    its devices and leaves the PCM on the first, and ``device`` is then
    not consulted (module docstring).  On CUDA each batch's parse and
    reconstruction are replays of the configuration's CUDA graphs;
    ``graphs=False`` runs them eagerly, op by op, the counterpart of
    running the JAX decoder under ``jax.disable_jit()`` (the CPU always
    runs eagerly).  A failed capture or replay raises.
    """

    def __init__(self, fp_or_path, batch_frames: int = 256, mesh=None,
                 device_parse: bool | None = None, *, device="cuda",
                 graphs: bool = True):
        self.mesh = None if mesh is None else batch_mesh(mesh)
        if self.mesh is not None:
            self.device, devices = self.mesh[0], self.mesh
        else:
            self.device = torch.device(device)
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "BatchDecoder(device='cuda'): CUDA is not available")
            elif self.device.type != "cpu":
                raise ValueError(f"unsupported device {self.device}")
            devices = batch_mesh([self.device])
        # a device and a process-wide stream per shard (one without a
        # mesh), so later decoders replay the same graphs
        self._shards = list(zip(devices, shard_streams(devices)))
        self._cuda = any(d.type == "cuda" for d in devices)
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
        # the pinned upload buffer on CUDA, and the events of its last
        # copies
        self._staging = _Staging(self._cuda)
        # real frames reconstructed on the device, frames the host
        # decoded, and batches the device parse handed to the host parse
        self.device_frames = 0
        self.host_frames = 0
        self.parse_fallbacks = 0
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
        """One frame through the host decoder, which raises the precise
        error for a bad frame; None at end of stream."""
        with trace.stage("decode.host_frame", req=self.request_id):
            frame = self.decoder.read_frame()
        if frame is None:
            return None
        self.host_frames += 1
        return (torch.from_numpy(frame[None]).to(self.device),
                np.array([frame.shape[1]]))

    def _read_batch_bulk_host(self):
        """Variable-block-size streams: decode a whole batch with one
        native bulk call (which handles per-frame sizes) and upload the
        batch, padded to its largest frame."""
        dec = self.decoder
        si = dec.streaminfo
        remaining = self._remaining()
        if remaining is not None and remaining <= 0:
            return None
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
        B, C = len(sizes), si.channels
        N = int(sizes.max())
        pcm = np.zeros((B, C, N), np.int32)
        pos = 0
        for b, n in enumerate(sizes):
            n = int(n)
            pcm[b, :, :n] = out[pos:pos + n * C].reshape(n, C).T
            pos += n * C
        self.host_frames += B
        return torch.from_numpy(pcm).to(self.device), sizes

    def _upload(self, view: np.ndarray, scan: dict, bucket: int):
        """Stage the batch for the parse (``ops.framescan.upload_views``
        of ``bucket`` lanes): body offsets, bit lengths, assignments,
        then the bytes from the first body to the end of the last, zero
        up to the byte capacity.  Padding lanes are all zero.  Returns
        the staged blob and the capacity."""
        lo, hi = _body_span(scan)
        cap = byte_capacity(hi - lo)
        blob = self._staging.take(16 * bucket + cap)
        _write_bodies(blob, bucket, [(view, scan)])
        return blob, cap

    def _read_batch_device_parse(self):
        """The device-parse step: the native scan finds the batch's frame
        bodies and checks their CRCs, one copy uploads them, the device
        parses them and reconstructs the PCM.  Returns (pcm, blocks), None
        at end of stream, or "fallback" with the reader's position
        untouched when the scan finds no frame (a short tail, a damaged
        frame) or a body does not parse."""
        dec = self.decoder
        si = dec.streaminfo
        remaining = self._remaining()
        if remaining is not None and remaining <= 0:
            return None
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
            return "fallback"
        bucket = frame_bucket(B, self.batch_frames)
        C, N = si.channels, self.block_size
        (d, s), = self._shards
        with trace.stage("decode.upload", req=self.request_id, frames=B):
            blob, cap = self._upload(view, scan, bucket)
        parsed, all_ok, order_max, fixed = _parse_device(
            blob, bucket, cap, N, C, si.bits_per_sample, d, s, self.graphs,
            self._staging, B)
        if not all_ok:
            return "fallback"
        dec.r.pos = scan["end_bitpos"]
        dec.current_sample += int(scan["blocks"].sum())
        mode = "fixed" if fixed else "lpc"
        taps = 32 if fixed else tap_bucket(order_max)
        with trace.stage("decode.reconstruct", req=self.request_id,
                         frames=B, mode=mode):
            pcm = self._reconstruct(
                [tuple(parsed[k] for k in RECON_KEYS)], bucket, B, mode,
                taps)
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
        if not self._fixed_blocks:
            return self._read_batch_bulk_host()
        if self._device_parse:
            got = self._read_batch_device_parse()
            if not isinstance(got, str):
                return got
            self.parse_fallbacks += 1
        dec = self.decoder
        si = dec.streaminfo
        remaining = self._remaining()
        if remaining is not None and remaining <= 0:
            return None
        with trace.stage("decode.parse", req=self.request_id,
                         frames=self.batch_frames):
            raw = self._nat.parse_frames_raw(
                dec.r.np_view(), dec.r.pos, self.batch_frames,
                si.sample_rate, si.channels, si.bits_per_sample,
                self.block_size, remaining)
        n = raw["n"]
        if n == 0:
            # tail / error: host path (raises precise errors)
            return self._host_frame()
        dec.r.pos = raw["end_bitpos"]
        dec.current_sample += int(raw["blocks"].sum())

        # all-FIXED batches take the cumsum inverse; otherwise the kernel
        # runs with the smallest tap bucket covering the largest order
        C, N = si.channels, self.block_size
        fixed = fixed_compatible_mask(raw["qcoeffs"].reshape(n * C, 32),
                                      raw["shift"].reshape(n * C),
                                      raw["order"].reshape(n * C)).all()
        mode = "fixed" if fixed else "lpc"
        taps = 32 if fixed else tap_bucket(int(raw["order"].max()))
        bucket = frame_bucket(n, self.batch_frames)
        with trace.stage("decode.reconstruct", req=self.request_id,
                         frames=n, mode=mode):
            # one staged reconstruct blob per shard of the padded batch,
            # padding rows zero
            sizes = _shard_sizes(bucket, len(self._shards))
            host = self._staging.take(
                4 * sum(recon_len(b, C, N) for b in sizes))
            host = host.view(torch.int32)
            blobs, lo, first = [], 0, 0
            for b in sizes:
                blob = host[lo:lo + recon_len(b, C, N)]
                m = min(max(n - first, 0), b)
                for dst, k in zip(recon_views(blob, b, C, N), RECON_KEYS):
                    dst = dst.numpy()
                    dst[:m] = raw[k][first:first + m]
                    dst[m:] = 0
                blobs.append(blob)
                lo += len(blob)
                first += b
            pcm = self._reconstruct(blobs, bucket, n, mode, taps)
        self.device_frames += n
        return pcm, raw["blocks"]

    def _reconstruct(self, inputs: list, bucket: int, n: int, mode: str,
                     taps: int) -> torch.Tensor:
        """The PCM of a batch's ``n`` real frames, padded to ``bucket``
        and cut into one shard a mesh entry (``inputs``: each shard's
        reconstruct blob staged on the host, or, without a mesh, the six
        tensors of a device parse).  Each shard holding a real frame is
        reconstructed on its device and stream (a graph replay on CUDA)
        and its real rows copied out, so the next replay cannot overwrite
        them; the shards are gathered in order on the first device, whose
        current stream waits for every shard."""
        home = self._shards[0][0]
        consumer = (torch.cuda.current_stream(home) if home.type == "cuda"
                    else None)
        C, N = self.streaminfo.channels, self.block_size
        parts, first = [], 0
        for (d, s), x, b in zip(self._shards, inputs,
                                _shard_sizes(bucket, len(self._shards))):
            m, first = min(n - first, b), first + b
            if m <= 0:
                continue
            shape = (b, C, N)
            with on_stream(s):
                if self.graphs and d.type == "cuda":
                    graph = reconstruct_graph(s, shape, mode, taps)
                    if isinstance(x, tuple):
                        for dst, src in zip(recon_views(graph.input, *shape),
                                            x):
                            dst.copy_(src)
                    else:
                        graph.input.copy_(x, non_blocking=True)
                        self._staging.copied(s)
                    part = graph.replay()[:m]
                    # the static output: copy it out (.to(home) alone
                    # would hand it out when d is home)
                    part = part.clone() if d == home else part.to(home)
                else:
                    if not isinstance(x, tuple):
                        x = recon_views(x.to(d, non_blocking=True), *shape)
                        self._staging.copied(s)
                    part = _device_reconstruct(*x, mode=mode,
                                               taps=taps)[:m].to(home)
            if consumer is not None:
                if s is not None:
                    consumer.wait_stream(s)
                part.record_stream(consumer)
            parts.append(part)
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
    whole frames of the streams of that channel count, bit depth and
    block size are packed in order into device batches of at most
    ``batch_frames`` frames, a stream straddling two batches where it
    must.  A batch is one native ``scan_frames`` a stream part, one copy
    out of the decoder's pinned buffer, one parse graph replay (K4) and
    gate download, one reconstruct graph replay (K3) and one device-side
    index copy of its real rows to their (stream, frame) places, staged
    beside its bytes.  Each stream's short last frame is decoded on the
    host (by the native decoder, and by ``Decoder.read_frame`` where that
    one stops), and the call's tails and lengths go up in one copy.

    A stream of another format, or one whose whole frames the scan does
    not find, is decoded alone through :class:`BatchDecoder` with the
    device parse (``stream_fallbacks``); the streams of a batch whose
    gate fails, alone through its host parse (``parse_fallbacks``).  So
    the result stays exact, and a damaged stream raises what
    ``BatchDecoder`` raises.

    One request id, one profiler session and one flush of the trace a
    call (the ``decode.streams`` span); the pinned buffer and the graphs
    live as long as the decoder.  ``device="cuda"`` without CUDA raises,
    as in :class:`BatchDecoder`; ``device="cpu"`` runs the same batches
    eagerly, as ``graphs=False`` does on CUDA.  The counters below are
    summed over calls.
    """

    def __init__(self, batch_frames: int = 256, device="cuda",
                 graphs: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MultiStreamDecoder(device='cuda'): CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
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
            if st not in redo and st.length > st.whole * fmt[2]:
                frame = self._tail(st)
                if frame is None:
                    redo[st] = True
                else:
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
        """Pack the next batch from ``pending`` streams, parse and
        reconstruct it, and place its rows in ``pcm``.  Streams whose
        frames the scan does not find, and the streams of a batch whose
        gate fails, go to ``redo``."""
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
        bucket = frame_bucket(n, self.batch_frames)
        d, s = self.device, self._shard_stream
        with trace.stage("decode.upload", frames=n):
            blob, cap, where = self._upload(parts, bucket)
        parsed, all_ok, order_max, fixed = _parse_device(
            blob, bucket, cap, N, C, bits, d, s, self.graphs, self._staging,
            n)
        if not all_ok:
            self.parse_fallbacks += 1
            for st, _, _ in parts:
                redo[st] = False
            if pending and pending[0] is parts[-1][0]:
                pending.popleft()
            return
        mode = "fixed" if fixed else "lpc"
        taps = 32 if fixed else tap_bucket(order_max)
        shape = (bucket, C, N)
        x = tuple(parsed[k] for k in RECON_KEYS)
        with trace.stage("decode.reconstruct", frames=n, mode=mode), \
                on_stream(s):
            if self.graphs and d.type == "cuda":
                graph = reconstruct_graph(s, shape, mode, taps)
                for dst, src in zip(recon_views(graph.input, *shape), x):
                    dst.copy_(src)
                out = graph.replay()
            else:
                out = _device_reconstruct(*x, mode=mode, taps=taps)
            # the real rows to their (stream, frame) places, read on the
            # graph's stream before its next replay
            U, Cs, S = pcm.shape
            rows = pcm.as_strided((U, S // N, C, N), (Cs * S, N, S, 1))
            where = where.to(d, non_blocking=True).view(torch.int64)
            self._staging.copied(s)
            rows.index_put_((where[:n], where[bucket:bucket + n]), out[:n])
        self.device_frames += n
        self.device_batches += 1
        self.batch_streams += len(parts)

    def _upload(self, parts: list, bucket: int) -> tuple:
        """Stage a batch of stream ``parts``, [(stream, scan, first
        frame), ...], in the pinned buffer: the parse's blob (the bodies
        of every part, :func:`_write_bodies`) and after it each lane's
        stream and frame (2 x ``bucket`` int64).  Returns (blob, byte
        capacity, places)."""
        cap = byte_capacity(sum(hi - lo for lo, hi in
                                (_body_span(scan) for _, scan, _ in parts)))
        head = 16 * bucket + cap
        host = self._staging.take(head + 16 * bucket)
        blob, where = host[:head], host[head:]
        _write_bodies(blob, bucket, [(st.view, scan) for st, scan, _ in parts])
        u, f = where.view(torch.int64).numpy().reshape(2, bucket)
        lane = 0
        for st, scan, first in parts:
            k = scan["n"]
            u[lane:lane + k] = st.index
            f[lane:lane + k] = np.arange(first, first + k)
            lane += k
        return blob, cap, where

    def _tail(self, st: _Stream):
        """The stream's short last frame, (channels, samples) int32, on
        the host (the ``decode.host_frame`` span): the native decoder's,
        as ``BatchDecoder``'s bulk host path decodes frames of any size,
        and where it stops, the host decoder's (``Decoder.read_frame``),
        which raises the precise error for a bad frame.  None where the
        frame is not the stream's last samples."""
        dec = st.decoder
        si = dec.streaminfo
        done = st.whole * si.maximum_block_size
        left = st.length - done
        with trace.stage("decode.host_frame"):
            out, sizes, _, _ = self._nat.decode_frames(
                st.view, st.pos, 1, si.sample_rate, si.channels,
                si.bits_per_sample, si.maximum_block_size, left, nthreads=1)
            if len(sizes) == 1 and sizes[0] == left:
                frame = out.reshape(left, si.channels).T
            else:
                dec.r.pos, dec.current_sample = st.pos, done
                frame = dec.read_frame()
                if frame is None or dec.current_sample != st.length:
                    return None
        self.host_frames += 1
        return frame

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
