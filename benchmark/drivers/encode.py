"""Closed-loop encode of whole tracks, one client: each request is
``BatchEncoder(BytesIO(), ...)``, ``write(track)``, ``finalize()``, timed
from the constructor to the finalised stream, as a bulk job encodes file
after file.  Every stream is held against the plain reference's bytes:
the first stream of each pool track is kept, every later one is compared
with it byte for byte as it finishes (outside its latency, and dropped,
so the process does not grow by a stream a track), and once the window
has closed each kept stream is compared with the reference's.  Each kept
stream is also decoded by the plain reference and held to its source
samples, and its STREAMINFO MD5 to the MD5 of its source's bytes, so
that a fault the program shares with the reference's encoder still
shows.

Control (``ctx.control``): the program's own lower precision,
``analysis="f32"``, whose bytes need not equal the reference's."""

from __future__ import annotations

import hashlib
import io
import time

from benchmark.harness import tracks
from benchmark.harness.pool import decode_reference, options
from benchmark.reference import metadata as ref_meta
from benchmark.reference.byteorder import samples_to_bytes

PHASES = ("request.open", "request.write", "request.finalize")


class Driver:
    def __init__(self, ctx):
        from flac_codec_tpu_torch.encode import Options
        from flac_codec_tpu_torch.parallel.batch import BatchEncoder

        self.ctx = ctx
        self.cfg = ctx.cfg
        self.encoder = BatchEncoder
        self.options = options(Options, self.cfg)
        self.analysis = "f32" if ctx.control else self.cfg["analysis"]
        self.pcm = [tracks.interleaved(tracks.make(ctx, i))
                    for i in range(ctx.traffic["pool_tracks"])]
        self.refs = {}
        self.trips = {}  # pool track -> (samples differing, MD5 differs)
        self.first = {}  # pool track -> its first finished stream
        # set-up: the plan graph, the pinned buffers and the host tail
        # path, as the first request meets them
        self.request(0)

    def request(self, i: int) -> dict:
        cfg, k = self.cfg, i % len(self.pcm)
        x = self.pcm[k]
        samples = len(x) // cfg["channels"]
        buf = io.BytesIO()
        t0 = time.perf_counter()
        with tracks.phase("request.open"):
            enc = self.encoder(buf, self.options, cfg["sample_rate"],
                               cfg["bits_per_sample"], cfg["channels"],
                               samples, cfg["batch_frames"], None,
                               self.analysis, device=self.ctx.device)
        with tracks.phase("request.write"):
            enc.write(x)
        with tracks.phase("request.finalize"):
            enc.finalize()
        latency = time.perf_counter() - t0
        # bytes, not a memoryview: bytes compare with memcmp, a memoryview
        # element by element
        stream = buf.getvalue()
        first = self.first.setdefault(k, stream)
        return {"track": k, "latency_s": latency,
                "pcm_bytes": tracks.pcm_bytes(cfg, samples),
                "flac_bytes": len(stream), "same_as_first": stream == first,
                "device_frames": enc.device_frames,
                "fallback_frames": enc.fallback_frames}

    def _reference(self, k: int) -> tuple:
        """The reference's stream and layout of pool track ``k``, made
        once the window has closed."""
        if k not in self.refs:
            self.refs[k] = tracks.reference(self.ctx, self.pcm[k])
        return self.refs[k]

    def _round_trip(self, k: int) -> tuple:
        """The first stream of pool track ``k`` against its source: the
        samples that the reference's decode of it gets wrong (all of them
        where it does not decode), and whether its STREAMINFO MD5 differs
        from the MD5 of the source's bytes."""
        if k not in self.trips:
            x, stream = self.pcm[k], self.first[k]
            bps = self.cfg["bits_per_sample"]
            t0 = time.perf_counter()
            try:
                got = decode_reference(stream, self.ctx.workers)
                self.ctx.log(f"track {k} decoded by the reference in "
                             f"{time.perf_counter() - t0:.3f} s")
                differing = int((got[:len(x)] != x[:len(got)]).sum()
                                + abs(len(got) - len(x)))
            except Exception as e:  # a stream that does not decode
                self.ctx.log(f"track {k} does not decode: {e}")
                differing = len(x)
            try:
                md5 = ref_meta.read_blocks(io.BytesIO(stream)).streaminfo.md5
            except Exception:
                md5 = None
            want = hashlib.md5(samples_to_bytes(x, bps)).digest()
            self.trips[k] = (differing, md5 != want)
        return self.trips[k]

    def _differs(self, record: dict) -> bool:
        """A request that raised, or whose stream is not the reference's,
        byte for byte (not its pool track's first stream, or that first
        stream not the reference's)."""
        return ("track" not in record or not record["same_as_first"]
                or self.first[record["track"]] != self._reference(
                    record["track"])[0])

    def failed(self, record: dict) -> bool:
        """A request that differs from the reference, or whose first
        stream does not decode to its source or carries another MD5."""
        return self._differs(record) or any(self._round_trip(
            record["track"]))

    def check(self, records: list) -> dict:
        """{name: (value, limit)}: the tracks whose stream is not the
        reference's, the samples that the pool tracks' streams do not
        decode to, and the streams whose MD5 is not their source's."""
        done = sorted({r["track"] for r in records if "track" in r})
        trips = [self._round_trip(k) for k in done]
        return {"tracks_differing": (sum(map(self._differs, records)), 0),
                "roundtrip_samples_differing": (
                    sum(d for d, _ in trips), 0),
                "md5_differing": (sum(m for _, m in trips), 0)}

    def end_to_end(self, records: list, window_s: float) -> dict:
        pcm = sum(r["pcm_bytes"] for r in records if "track" in r)
        flac = sum(r["flac_bytes"] for r in records if "track" in r)
        return {"encode_mbps": pcm / window_s / 1e6,
                "compression_ratio": flac / pcm if pcm else None}

    def counters(self, records: list) -> dict:
        return {k: sum(r.get(k, 0) for r in records)
                for k in ("device_frames", "fallback_frames")}

    def work(self, records: list) -> dict:
        """The plan layer's work over ``records``: PCM in at the dtype the
        batch is handed over (int16 up to 16 bits, int32 above), and the
        FLAC frame bytes out, of the frames the device planned."""
        cfg = self.cfg
        width = 2 if cfg["bits_per_sample"] <= 16 else 4
        pcm_in = frames_out = 0
        for r in records:
            if "track" not in r:
                continue
            layout = self._reference(r["track"])[1]
            n = r["device_frames"]
            pcm_in += n * cfg["block_size"] * cfg["channels"] * width
            frames_out += layout["frame_bytes"] * n / layout["frames"]
        return {"plan_bytes_in": pcm_in, "plan_bytes_out": frames_out,
                "plan_frames": sum(r.get("device_frames", 0)
                                   for r in records)}
