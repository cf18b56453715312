"""The plain reference's stream of a track, and its decode of a stream,
made in parallel.

FLAC frames are independent, so :func:`encode_reference` cuts a track's
whole frames into one contiguous range per worker process
(``python -m benchmark.harness.refworker``, fed and read through pipes),
and writes the frames in order through the reference ``Encoder``, whose
short tail frame, MD5 and seek table it finishes itself: the same bytes
as the reference's sequential ``FlacSampleWriter``.
:func:`decode_reference` cuts a stream at its seek points, which give
each run of frames its first sample and its byte offset, and decodes
one contiguous range of runs per worker.

The streams are made anew in every run and never cached: a cache hit
would make a run's set-up shorter than a miss by the whole encoding, and
the set-up time's median would then turn on how many runs of a check
hit.
"""

from __future__ import annotations

import io
import json
import os
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..reference import encode as ref_encode
from ..reference import metadata as ref_meta
from ..reference.byteorder import deinterleave

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the configuration keys that make the stream
STREAM_KEYS = ("sample_rate", "bits_per_sample", "channels", "block_size",
               "max_lpc_order", "max_partition_order", "mid_side", "window",
               "exhaustive_channel_correlation", "padding",
               "seektable_seconds")


def options(cls, cfg: dict):
    """``cls`` (the reference's or the program's ``Options``) as the
    configuration sets it."""
    return cls(block_size=cfg["block_size"],
               max_lpc_order=cfg["max_lpc_order"],
               max_partition_order=cfg["max_partition_order"],
               mid_side=cfg["mid_side"], window=tuple(cfg["window"]),
               exhaustive_channel_correlation=cfg[
                   "exhaustive_channel_correlation"],
               padding=cfg["padding"],
               seektable_interval=("seconds", cfg["seektable_seconds"]))


def _worker(header: dict, payload: bytes) -> bytes:
    """Run one worker on ``header`` and ``payload``; returns what it
    wrote."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "benchmark.harness.refworker"], cwd=ROOT,
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    out, err = proc.communicate(json.dumps(header).encode() + b"\n"
                                + payload)
    if proc.returncode:
        raise RuntimeError(f"reference worker exited {proc.returncode}: "
                           + err.decode(errors="replace")[-2000:])
    return out


def _worker_frames(header: dict, pcm: np.ndarray) -> list:
    """Run one worker over its frames; returns their bytes."""
    out = _worker(header, pcm.tobytes())
    frames, pos = [], 0
    while pos < len(out):
        (size,) = struct.unpack_from("<I", out, pos)
        frames.append(out[pos + 4:pos + 4 + size])
        pos += 4 + size
    if len(frames) != header["frames"]:
        raise RuntimeError(f"reference worker returned {len(frames)} of "
                           f"{header['frames']} frames")
    return frames


def encode_reference(pcm: np.ndarray, cfg: dict, workers: int) -> tuple:
    """The reference's stream of the interleaved int32 track ``pcm``, and
    its layout: ``frames`` (whole frames), ``frame_bytes`` (their bytes),
    ``tail_samples`` (samples a channel of the short last frame, 0 if
    none), ``stream_bytes``."""
    ch, block = cfg["channels"], cfg["block_size"]
    total = len(pcm) // ch
    whole = total // block
    cuts = np.linspace(0, whole, max(1, min(workers, whole)) + 1).astype(int)
    jobs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        if b > a:
            header = {"cfg": {k: cfg[k] for k in STREAM_KEYS},
                      "total": total, "first": int(a), "frames": int(b - a)}
            jobs.append((header, pcm[a * block * ch:b * block * ch]))
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        parts = list(pool.map(lambda job: _worker_frames(*job), jobs))
    fp = io.BytesIO()
    enc = ref_encode.Encoder(fp, options(ref_encode.Options, cfg),
                             cfg["sample_rate"], cfg["bits_per_sample"], ch,
                             total)
    frame_bytes = 0
    for frames in parts:
        for data in frames:
            enc.write_frame(data, block)
            frame_bytes += len(data)
    enc.update_md5(pcm)
    tail = pcm[whole * block * ch:].astype(np.int64)
    if len(tail):
        enc.encode(list(deinterleave(tail, ch)))
    enc.finalize()
    stream = fp.getvalue()
    return stream, {"frames": int(whole), "frame_bytes": frame_bytes,
                    "tail_samples": len(tail) // ch,
                    "stream_bytes": len(stream)}


def decode_reference(stream: bytes, workers: int) -> np.ndarray:
    """The plain reference's decode of ``stream`` as interleaved int32
    samples, a run of frames between two seek points at a time (the
    whole stream where it has no seek table).  Raises where the stream
    does not decode: a frame that fails its CRC or its syntax, or a seek
    point that does not lead to a frame's start."""
    fp = io.BytesIO(stream)
    blocks = ref_meta.read_blocks(fp)
    start, info = fp.tell(), blocks.streaminfo
    table = blocks.get(ref_meta.SeekTable)
    points = sorted({(p.sample_offset, p.byte_offset)
                     for p in (table.points if table else [])
                     if not p.is_placeholder} | {(0, 0)})
    runs = [(s, b, e_s, e_b) for (s, b), (e_s, e_b) in zip(
        points, points[1:] + [(info.total_samples, len(stream) - start)])]
    cuts = np.linspace(0, len(runs), max(1, min(workers, len(runs))) + 1)
    jobs = []
    for a, b in zip(cuts[:-1].astype(int), cuts[1:].astype(int)):
        if b > a:
            first, lo = runs[a][:2]
            end, hi = runs[b - 1][2:]
            jobs.append(({"op": "decode", "first": first,
                          "samples": end - first},
                         stream[:start] + stream[start + lo:start + hi]))
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        parts = list(pool.map(lambda job: _worker(*job), jobs))
    return np.frombuffer(b"".join(parts), dtype="<i4")
