"""Closed-loop decode of whole tracks to the card, one client: each
request is ``BatchDecoder(BytesIO(stream), batch_frames, None,
device_parse)`` and ``read_batch_device()`` until ``None``, each batch's
PCM consumed on the card, one ``synchronize()`` a track; a request ends
when its PCM is on the card.  The streams are the plain reference's
encoding of the pool tracks, made at set-up.

The consumer holds every decoded sample against the track's source PCM
on the card, a device-side reduction into a count of differing samples
that is read once the window has closed.

Control (``ctx.control``): each batch's PCM with its lowest bit cleared,
a decode that breaks the lossless guarantee."""

from __future__ import annotations

import io
import time

from benchmark.harness import tracks

PHASES = ("request.open", "request.read", "request.consume", "request.sync")


class Driver:
    def __init__(self, ctx):
        import torch
        from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder

        self.torch = torch
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.decoder = BatchDecoder
        self.device_parse = bool(ctx.traffic["device_parse"])
        self.src, self.streams, self.layouts = [], [], []
        for i in range(ctx.traffic["pool_tracks"]):
            pcm = tracks.make(ctx, i)
            stream, layout = tracks.reference(ctx, tracks.interleaved(pcm))
            self.src.append(pcm)
            self.streams.append(stream)
            self.layouts.append(layout)
        # set-up: every graph (bucket, byte capacity, mode, taps) and
        # buffer that the pool's streams meet
        for i in range(len(self.streams)):
            self.request(i)
        from flac_codec_tpu_torch.parallel import batch_decode

        modes = sorted({key[3] for key in getattr(
            batch_decode, "RECONSTRUCT_GRAPHS", {})})
        ctx.log(f"reconstruct graphs after set-up: modes {modes}")

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            self.torch.cuda.synchronize(self.ctx.device)

    def request(self, i: int) -> dict:
        torch, cfg, k = self.torch, self.cfg, i % len(self.streams)
        src = self.src[k]
        channels, samples = src.shape
        t0 = time.perf_counter()
        with tracks.phase("request.open"):
            dec = self.decoder(io.BytesIO(self.streams[k]),
                               cfg["batch_frames"], None, self.device_parse,
                               device=self.ctx.device)
        differing = torch.zeros((), dtype=torch.int64, device=src.device)
        pos = device_batches = 0
        while True:
            frames, fallbacks = dec.device_frames, dec.parse_fallbacks
            with tracks.phase("request.read"):
                got = dec.read_batch_device()
            if got is None:
                break
            if dec.device_frames > frames and dec.parse_fallbacks == fallbacks:
                device_batches += int(self.device_parse)
            with tracks.phase("request.consume"):
                pcm, blocks = got
                if self.ctx.control:
                    pcm = pcm & ~1
                n = int(blocks.sum())
                if (blocks[:-1] == pcm.shape[2]).all():
                    flat = pcm.permute(1, 0, 2).reshape(channels, -1)[:, :n]
                else:
                    flat = torch.cat([pcm[b, :, :int(m)]
                                      for b, m in enumerate(blocks)], dim=1)
                want = src[:, pos:pos + n]
                m = want.shape[1]
                differing += (flat[:, :m] != want).sum()
                differing += (n - m) * channels  # samples past the track
                pos += n
        with tracks.phase("request.sync"):
            self._sync()
        dec.close()
        latency = time.perf_counter() - t0
        return {"track": k, "latency_s": latency,
                "pcm_bytes": tracks.pcm_bytes(cfg, samples),
                "differing": differing,
                "missing": (samples - min(pos, samples)) * channels,
                "device_frames": dec.device_frames,
                "parse_fallbacks": dec.parse_fallbacks,
                "device_batches": device_batches}

    @staticmethod
    def _differing(record: dict) -> int:
        return int(record["differing"]) + record["missing"]

    def failed(self, record: dict) -> bool:
        """A request that raised, or whose PCM differs from the source in
        a sample, or in length."""
        return "differing" not in record or self._differing(record) > 0

    def check(self, records: list) -> dict:
        """{name: (value, limit)}: the samples that differ from the
        source (or are missing or extra), and the tracks that hold one."""
        return {"samples_differing": (sum(self._differing(r) for r in records
                                          if "differing" in r), 0),
                "tracks_differing": (sum(map(self.failed, records)), 0)}

    def end_to_end(self, records: list, window_s: float) -> dict:
        import numpy as np

        done = [r for r in records if "differing" in r]
        pcm = sum(r["pcm_bytes"] for r in done)
        lat = [r["latency_s"] * 1e3 for r in done]
        return {"decode_mbps": pcm / window_s / 1e6,
                "decode_p95_ms": float(np.percentile(lat, 95)) if lat else None}

    def counters(self, records: list) -> dict:
        return {k: sum(r.get(k, 0) for r in records)
                for k in ("device_frames", "parse_fallbacks",
                          "device_batches")}

    def work(self, records: list) -> dict:
        """The parse and reconstruct layers' work over ``records``, for
        the frames reconstructed on the device: the frames' bytes, and
        their samples (channels x block)."""
        cfg = self.cfg
        frame_bytes = samples = 0
        for r in records:
            if "differing" not in r:
                continue
            layout, n = self.layouts[r["track"]], r["device_frames"]
            frame_bytes += layout["frame_bytes"] * n / layout["frames"]
            samples += n * cfg["block_size"] * cfg["channels"]
        return {"frame_bytes": frame_bytes, "samples": samples}
