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

Not ported: ``mesh`` sharding, the opt-in device frame parser
(``device_parse``) and the ``FLAC_TPU_PALLAS`` / ``FLAC_TPU_NO_PALLAS`` /
``FLAC_TPU_DEVICE_PARSE`` switches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metadata as meta
from .. import native
from ..decode import Decoder
from ..ops.predict import fixed_compatible_mask, predict_fixed_batch
from ..ops.predict_pallas import predict_lpc, tap_bucket
from ..utils import trace


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
    ``device``.
    """

    def __init__(self, fp_or_path, batch_frames: int = 256, device="cuda"):
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
        # frames reconstructed on the device, and frames the host decoded
        self.device_frames = 0
        self.host_frames = 0
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

    def read_batch_device(self):
        """Decode up to batch_frames frames; returns a (B, channels,
        block_size) int32 tensor on the device and the per-frame sample
        counts, or None at end of stream.  A short tail, and a frame the
        native parser stops at, go to the host decoder."""
        if not self._fixed_blocks:
            return self._read_batch_bulk_host()
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
        with trace.stage("decode.reconstruct", frames=n, mode=mode):
            args = [torch.from_numpy(raw[k]).to(self.device)
                    for k in ("buf", "qcoeffs", "shift", "order", "wasted",
                              "assignment")]
            pcm = _device_reconstruct(*args, mode=mode, taps=taps)
        self.device_frames += n
        return pcm, raw["blocks"]

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
