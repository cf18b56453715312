"""Closed-loop decode of an ASR training loader's steps to the card, one
client.  The pool is ``pool_utterances`` seeded speech utterances
(``benchmark.harness.speech``) whose durations are drawn from a normal
distribution (``utterance_mean_s``, ``utterance_sd_s``, clipped to
``utterance_min_s``-``utterance_max_s``), each encoded by the plain
reference at set-up, the utterances in parallel.  A request is one
loader step: utterances taken in a seeded shuffled order through the
pool (a new order each pass), added while their samples stay within
``step_samples``, decoded by one ``MultiStreamDecoder`` that every
request reuses, ``decode([BytesIO(stream), ...])``, then one
``synchronize()``; a request ends when its padded batch is on the card.

The consumer holds each utterance against its source on the card: the
samples inside its length (and its length) against the source, and
every sample past its length against zero, device-side reductions into
counts read once the window has closed.

Control (``ctx.control``): each batch's PCM with its lowest bit cleared,
a decode that breaks the lossless guarantee."""

from __future__ import annotations

import io
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.harness import speech, tracks
from benchmark.harness.pool import encode_reference
from benchmark.reference import crc as ref_crc

PHASES = ("request.decode", "request.consume", "request.sync")
COUNTERS = ("device_batches", "parse_fallbacks", "device_frames",
            "host_frames", "stream_fallbacks", "batch_streams")
# seeds of the durations, the window's order and the warm-up's order
# (pool utterance k takes tracks.track_seed(seed, k))
DURATIONS, ORDER, WARM_ORDER = ((1 << 32) + i for i in range(3))
# set-up ends once this many warm-up steps in a row captured no graph,
# or after WARM_STEPS
QUIET_STEPS, WARM_STEPS = 16, 512
# the warm-up's one-frame streams: sums of sines (Hz) that LPC of order
# twice their count predicts and FIXED does not, over a noise floor (dB
# of full scale), coded with LPC orders up to the third number; the
# second's frame takes more than 4 KiB, so that a batch of 256 passes
# 1 MiB
WARM_TONES = (((1500, 3100), -60, 4), ((700, 1900, 3300, 5100), -40, 8))


class Driver:
    def __init__(self, ctx):
        import torch
        from flac_codec_tpu_torch.parallel.batch_decode import \
            MultiStreamDecoder

        self.torch = torch
        self.ctx = ctx
        cfg, traffic = ctx.cfg, ctx.traffic
        if cfg["channels"] != 1:
            raise ValueError("the speech signal is mono")
        rate, pool = cfg["sample_rate"], traffic["pool_utterances"]
        rng = np.random.default_rng(tracks.track_seed(ctx.seed, DURATIONS))
        seconds = np.clip(rng.normal(traffic["utterance_mean_s"],
                                     traffic["utterance_sd_s"], pool),
                          traffic["utterance_min_s"],
                          traffic["utterance_max_s"])
        self.lens = np.round(seconds * rate).astype(np.int64)
        pcm = [speech.utterance(n / rate, rate, cfg["bits_per_sample"],
                                tracks.track_seed(ctx.seed, k), ctx.device,
                                traffic["noise_floor_dbfs"])
               for k, n in enumerate(self.lens)]
        ctx.log(f"pool of {pool} utterances, {self.lens.sum()} samples; "
                f"checksum {sum(tracks.checksum(x) for x in pcm)}")
        self.src = torch.zeros((pool, int(self.lens.max())),
                               dtype=torch.int32, device=ctx.device)
        for k, x in enumerate(pcm):
            self.src[k, :x.shape[1]] = x[0]
        self.lens_dev = torch.as_tensor(self.lens, device=ctx.device)
        self.streams, self.layouts = self._reference(
            [x[0].cpu().numpy() for x in pcm])
        frames = self._one_frame_streams()
        del pcm
        self.decoder = MultiStreamDecoder(cfg["batch_frames"],
                                          device=ctx.device)
        self.plan = []
        self._order = self._steps(ORDER)
        # set-up: batches of one-frame streams of each content, of
        # lengths from 1 to batch_frames spaced by a factor of about 1.4,
        # so that each padded batch length meets each reconstruct mode,
        # and a full batch both byte capacities; then every utterance
        # alone, then loader steps in another order until QUIET_STEPS in
        # a row capture no graph
        bf = cfg["batch_frames"]
        for stream in frames:
            for k in sorted({min(bf, round(2 ** (i / 2)))
                             for i in range(2 * bf.bit_length())}):
                self.decoder.decode([io.BytesIO(stream) for _ in range(k)])
        for k in range(pool):
            self._run([k])
        warm, quiet, steps = self._steps(WARM_ORDER), 0, 0
        while quiet < QUIET_STEPS and steps < WARM_STEPS:
            before = self._graphs()
            self._run(next(warm))
            steps += 1
            quiet = quiet + 1 if self._graphs() == before else 0
        ctx.log(f"set-up: {pool} utterances alone and {steps} steps; "
                f"{self._graphs()} graphs")

    def _reference(self, pcm: list) -> tuple:
        """The plain reference's stream and layout of each utterance, the
        utterances in parallel (one worker process each); the seconds are
        added to ``ctx.reference_s``, which set-up leaves out."""
        ctx = self.ctx
        t0 = time.perf_counter()
        # the reference's CRC-16 builds its tables at first use, and two
        # threads that build them at once leave them wrong: build every
        # table a stream's frames need here, before the threads start
        ref_crc.crc16(bytes(1 << 20))
        with ThreadPoolExecutor(ctx.workers) as pool:
            got = list(pool.map(lambda x: encode_reference(x, ctx.cfg, 1),
                                pcm))
        seconds = time.perf_counter() - t0
        ctx.reference_s += seconds
        streams = [s for s, _ in got]
        ratio = sum(map(len, streams)) / tracks.pcm_bytes(
            ctx.cfg, int(self.lens.sum()))
        ctx.log(f"reference streams made in {seconds:.3f} s by "
                f"{ctx.workers} workers; {ratio:.4f} of the PCM's bytes")
        return streams, [layout for _, layout in got]

    def _one_frame_streams(self) -> list:
        """The reference's streams of one whole frame each, for the
        warm-up: digital silence (the FIXED path) and each of WARM_TONES
        (LPC of order 4, the smaller tap bucket, and of order 8).  A short
        last frame follows each, as in any utterance: the scan finds a
        whole frame's end by the next frame's header."""
        ctx, cfg = self.ctx, self.ctx.cfg
        n, rate = cfg["block_size"] + 100, cfg["sample_rate"]
        full = (1 << (cfg["bits_per_sample"] - 1)) - 1
        rng = np.random.default_rng(tracks.track_seed(ctx.seed, WARM_ORDER))
        t = np.arange(n) / rate
        frames = [(np.zeros(n, np.int32), cfg["max_lpc_order"])]
        for tones, dbfs, order in WARM_TONES:
            x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
                    for f in tones) * (0.4 * full / len(tones))
            x += rng.normal(0, full * 10 ** (dbfs / 20), n)
            frames.append((np.round(x).astype(np.int32), order))
        t0 = time.perf_counter()
        out = [encode_reference(x, dict(cfg, max_lpc_order=order), 1)[0]
               for x, order in frames]
        ctx.reference_s += time.perf_counter() - t0
        return out

    def _steps(self, key: int):
        """Loader steps, endlessly: lists of pool indices taken in a
        seeded shuffled order, each list as long as its samples stay
        within ``step_samples``."""
        rng = np.random.default_rng(tracks.track_seed(self.ctx.seed, key))
        limit = self.ctx.traffic["step_samples"]
        step, total = [], 0
        while True:
            for k in rng.permutation(len(self.lens)):
                if step and total + self.lens[k] > limit:
                    yield step
                    step, total = [], 0
                step.append(int(k))
                total += int(self.lens[k])

    def _graphs(self) -> int:
        """CUDA graphs the program holds (0 where it keeps none)."""
        from flac_codec_tpu_torch.ops import framescan
        from flac_codec_tpu_torch.parallel import batch_decode

        return (len(getattr(batch_decode, "RECONSTRUCT_GRAPHS", {}))
                + len(getattr(framescan, "PARSE_GRAPHS", {})))

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            self.torch.cuda.synchronize(self.ctx.device)

    def request(self, i: int) -> dict:
        while len(self.plan) <= i:
            self.plan.append(next(self._order))
        return self._run(self.plan[i])

    def _run(self, idx: list) -> dict:
        dec = self.decoder
        before = {k: getattr(dec, k) for k in COUNTERS}
        t0 = time.perf_counter()
        with tracks.phase("request.decode"):
            pcm, lengths = dec.decode([io.BytesIO(self.streams[k])
                                       for k in idx])
        with tracks.phase("request.consume"):
            counts = self._compare(idx, pcm, lengths)
        with tracks.phase("request.sync"):
            self._sync()
        latency = time.perf_counter() - t0
        return {"utterances": idx, "latency_s": latency,
                "pcm_bytes": tracks.pcm_bytes(self.ctx.cfg,
                                              int(self.lens[idx].sum())),
                **counts,
                **{k: getattr(dec, k) - before[k] for k in COUNTERS}}

    def _compare(self, idx: list, pcm, lengths) -> dict:
        """Device-side counts of a step: samples inside an utterance's
        length that differ from its source (and the samples its length
        is off by), utterances with such a sample, and nonzero samples
        past an utterance's length."""
        torch = self.torch
        U, S = len(idx), int(self.lens[idx].max())
        if tuple(pcm.shape) != (U, 1, S) or tuple(lengths.shape) != (U,):
            return {"differing": U * S, "utterances_differing": U,
                    "padding_nonzero": 0}
        if self.ctx.control:
            pcm = pcm & ~1
        ix = torch.as_tensor(idx, device=pcm.device)
        want_len = self.lens_dev[ix]
        inside = (torch.arange(S, device=pcm.device)[None]
                  < want_len[:, None])
        got = pcm[:, 0]
        per = (((got != self.src[ix, :S]) & inside).sum(1)
               + (lengths - want_len).abs())
        return {"differing": per.sum(),
                "utterances_differing": (per > 0).sum(),
                "padding_nonzero": ((got != 0) & ~inside).sum()}

    def failed(self, record: dict) -> bool:
        """A request that raised, or whose batch differs from its sources
        in a sample, a length or a padding sample."""
        return "differing" not in record or any(
            int(record[k]) > 0 for k in ("differing", "padding_nonzero"))

    def check(self, records: list) -> dict:
        """{name: (value, limit)}: the samples that differ from the
        sources (or by which a length is off), the utterances that hold
        one (and a request that raised counts one), and the nonzero
        samples of the padding."""
        done = [r for r in records if "differing" in r]
        raised = len(records) - len(done)
        return {"samples_differing": (sum(int(r["differing"]) for r in done),
                                      0),
                "tracks_differing": (sum(int(r["utterances_differing"])
                                         for r in done) + raised, 0),
                "padding_nonzero": (sum(int(r["padding_nonzero"])
                                        for r in done), 0)}

    def end_to_end(self, records: list, window_s: float) -> dict:
        done = [r for r in records if "differing" in r]
        lat = [r["latency_s"] * 1e3 for r in done]
        return {"decode_mbps": sum(r["pcm_bytes"] for r in done)
                / window_s / 1e6,
                "decode_p95_ms": float(np.percentile(lat, 95)) if lat
                else None}

    def counters(self, records: list) -> dict:
        return {k: sum(r.get(k, 0) for r in records) for k in COUNTERS}

    def work(self, records: list) -> dict:
        """The parse and reconstruct layers' work over ``records``, for
        the frames reconstructed on the device: the frames' bytes (each
        step's whole frames' bytes in the share of its whole frames that
        the device took), and their samples (channels x block)."""
        cfg = self.ctx.cfg
        frame_bytes = samples = 0
        for r in records:
            if "differing" not in r:
                continue
            whole = sum(self.layouts[k]["frames"] for k in r["utterances"])
            if whole:
                frame_bytes += (sum(self.layouts[k]["frame_bytes"]
                                    for k in r["utterances"])
                                * r["device_frames"] / whole)
            samples += r["device_frames"] * cfg["block_size"] * cfg["channels"]
        return {"frame_bytes": frame_bytes, "samples": samples}
