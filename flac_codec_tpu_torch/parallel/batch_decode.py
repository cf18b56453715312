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
mesh's first device.  The device parse does not run under a mesh: asking
for both raises, where the JAX package turns the device parse off.

Not ported: the ``FLAC_TPU_PALLAS`` / ``FLAC_TPU_NO_PALLAS`` /
``FLAC_TPU_DEVICE_PARSE`` switches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metadata as meta
from .. import native
from ..decode import Decoder
from ..ops.framescan import parse_frame_bodies, parse_gate
from ..ops.predict import fixed_compatible_mask, predict_fixed_batch
from ..ops.predict_pallas import predict_lpc, tap_bucket
from ..utils import trace
from .mesh import batch_mesh, on_stream, shard_streams


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


class BatchDecoder:
    """Decode a FLAC stream in frame batches on ``device``.

    ``device="cuda"`` without CUDA raises, and so does a native engine
    that does not build.  ``device="cpu"`` runs the same pipeline with the
    kernels' plain versions.  Decoded batches are int32 tensors on
    ``device``.  ``device_parse`` parses the frame bodies on the device;
    ``mesh`` (``parallel.mesh.batch_mesh``) shards the reconstruction over
    its devices and leaves the PCM on the first, and ``device`` is then
    not consulted (module docstring).
    """

    def __init__(self, fp_or_path, batch_frames: int = 256, device="cuda",
                 device_parse: bool = False, mesh=None):
        self.mesh = None if mesh is None else batch_mesh(mesh)
        if self.mesh is not None:
            if device_parse:
                raise ValueError("BatchDecoder: device_parse=True does not "
                                 "run under a mesh")
            self.device = self.mesh[0]
            self._streams = shard_streams(self.mesh)
        else:
            self.device = torch.device(device)
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "BatchDecoder(device='cuda'): CUDA is not available")
            elif self.device.type != "cpu":
                raise ValueError(f"unsupported device {self.device}")
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
        self._device_parse = (device_parse and self._fixed_blocks
                              and si.bits_per_sample <= 24)
        # the pinned upload buffer of the device parse, and the event of
        # its last copy
        self._staging = None
        self._staged = None
        # frames reconstructed on the device, frames the host decoded, and
        # batches the device parse handed to the host parse
        self.device_frames = 0
        self.host_frames = 0
        self.parse_fallbacks = 0
        self._profiler = trace.profiler_session("batch-decode")
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
        with trace.stage("decode.bulk_host", frames=self.batch_frames):
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

    def _upload(self, view: np.ndarray, scan: dict):
        """One host-to-device copy of the batch: body offsets (int64), bit
        lengths and assignments (int32), then the bytes from the first
        body to the end of the last, staged in pinned memory on CUDA.
        Returns the four tensors on the device."""
        B = scan["n"]
        off = scan["body_off"].astype(np.int64)
        lo, hi = int(off[0]), int(off[-1]) + int(scan["body_bytes"][-1])
        head = 16 * B                         # 8 + 4 + 4 bytes a frame
        nbytes = head + hi - lo
        if self.device.type == "cuda":
            if self._staged is not None:
                self._staged.synchronize()    # the last copy has left it
            if self._staging is None or len(self._staging) < nbytes:
                self._staging = torch.empty(max(nbytes, 1 << 20),
                                            dtype=torch.uint8,
                                            pin_memory=True)
            host = self._staging[:nbytes]
        else:
            host = torch.empty(nbytes, dtype=torch.uint8)
        h = host.numpy()
        h[:8 * B].view(np.int64)[:] = off - lo
        h[8 * B:12 * B].view(np.int32)[:] = scan["body_bytes"] * 8
        h[12 * B:head].view(np.int32)[:] = scan["assignment"]
        h[head:] = view[lo:hi]
        dev = host.to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._staged = torch.cuda.Event()
            self._staged.record()
        return (dev[head:], dev[:8 * B].view(torch.int64),
                dev[8 * B:12 * B].view(torch.int32),
                dev[12 * B:head].view(torch.int32))

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
        with trace.stage("decode.scan", frames=self.batch_frames):
            scan = self._nat.scan_frames(
                view, dec.r.pos, self.batch_frames, si.sample_rate,
                si.channels, si.bits_per_sample, self.block_size, remaining)
        B = scan["n"]
        if B == 0:
            return "fallback"
        with trace.stage("decode.upload", frames=B):
            data, off, nbits, assign = self._upload(view, scan)
        with trace.stage("decode.parse_device", frames=B):
            parsed = parse_frame_bodies(data, off, nbits, assign,
                                        self.block_size, si.channels,
                                        si.bits_per_sample)
            all_ok, order_max, fixed = parse_gate(
                parsed, torch.ones(B, dtype=torch.bool,
                                   device=self.device)).tolist()
        if not all_ok:
            return "fallback"
        dec.r.pos = scan["end_bitpos"]
        dec.current_sample += int(scan["blocks"].sum())
        mode = "fixed" if fixed else "lpc"
        taps = 32 if fixed else tap_bucket(order_max)
        with trace.stage("decode.reconstruct", frames=B, mode=mode):
            pcm = _device_reconstruct(
                parsed["buf"], parsed["qcoeffs"], parsed["shift"],
                parsed["order"], parsed["wasted"], assign, mode=mode,
                taps=taps)
        self.device_frames += B
        return pcm, scan["blocks"]

    def read_batch_device(self):
        """Decode up to batch_frames frames; returns a (B, channels,
        block_size) int32 tensor on the device and the per-frame sample
        counts, or None at end of stream.  A short tail, and a frame the
        native parser stops at, go to the host decoder."""
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
        with trace.stage("decode.parse", frames=self.batch_frames):
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
        C = si.channels
        fixed = fixed_compatible_mask(raw["qcoeffs"].reshape(n * C, 32),
                                      raw["shift"].reshape(n * C),
                                      raw["order"].reshape(n * C)).all()
        mode = "fixed" if fixed else "lpc"
        taps = 32 if fixed else tap_bucket(int(raw["order"].max()))
        args = [torch.from_numpy(raw[k]) for k in (
            "buf", "qcoeffs", "shift", "order", "wasted", "assignment")]
        with trace.stage("decode.reconstruct", frames=n, mode=mode):
            if self.mesh is None:
                pcm = _device_reconstruct(
                    *(a.to(self.device) for a in args), mode=mode, taps=taps)
            else:
                pcm = self._reconstruct_sharded(args, mode, taps)
        self.device_frames += n
        return pcm, raw["blocks"]

    def _reconstruct_sharded(self, args, mode: str, taps: int):
        """Reconstruct one contiguous shard of the batch on each mesh
        device and stream, and gather the shards in order on the first
        device, whose current stream waits for every shard."""
        home = self.mesh[0]
        consumer = (torch.cuda.current_stream(home) if home.type == "cuda"
                    else None)
        parts = []
        shards = zip(*(torch.tensor_split(a, len(self.mesh)) for a in args))
        for d, s, shard in zip(self.mesh, self._streams, shards):
            if shard[0].shape[0] == 0:
                continue
            with on_stream(s):
                part = _device_reconstruct(
                    *(a.to(d) for a in shard), mode=mode, taps=taps)
                part = part.to(home)
            if consumer is not None:
                if s is not None:
                    consumer.wait_stream(s)
                part.record_stream(consumer)
            parts.append(part)
        return torch.cat(parts)

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
