"""A worker of :mod:`benchmark.harness.pool`, run as
``python -m benchmark.harness.refworker``.  It reads a JSON header line
and a payload from standard input.  To encode (``encode_reference``),
the payload is its frames' interleaved int32 PCM, and it writes each
frame's bytes to standard output behind its length (4 bytes, little
endian).  To decode (``"op": "decode"``, ``decode_reference``), the
payload is a stream's metadata followed by a run of its frames, and it
writes the frames' interleaved int32 samples."""

from __future__ import annotations

import io
import json
import struct
import sys

import numpy as np

from ..reference import decode as ref_decode
from ..reference import encode as ref_encode
from ..reference import metadata as ref_meta
from ..reference.byteorder import deinterleave, interleave
from .pool import options


def decode(header: dict, payload: bytes) -> bytes:
    """The ``header["samples"]`` samples a channel that the frames in
    ``payload`` (after the stream's metadata) hold, from sample
    ``header["first"]`` on, as interleaved int32 bytes."""
    fp = io.BytesIO(payload)
    dec = ref_decode.Decoder(fp, ref_meta.read_blocks(fp))
    dec.current_sample = header["first"]
    out, got = [], 0
    while got < header["samples"]:
        frame = dec.read_frame()
        if frame is None:
            raise ValueError(f"the frames end after {got} of "
                             f"{header['samples']} samples")
        out.append(interleave(frame).astype("<i4"))
        got += frame.shape[1]
    if got != header["samples"]:
        raise ValueError(f"{got} samples where {header['samples']} were due")
    return b"".join(a.tobytes() for a in out)


def main() -> int:
    stdin = sys.stdin.buffer
    header = json.loads(stdin.readline())
    if header.get("op") == "decode":
        sys.stdout.buffer.write(decode(header, stdin.read()))
        sys.stdout.buffer.flush()
        return 0
    cfg = header["cfg"]
    ch, block = cfg["channels"], cfg["block_size"]
    pcm = np.frombuffer(stdin.read(), dtype=np.int32).astype(np.int64)
    enc = ref_encode.Encoder(io.BytesIO(), options(ref_encode.Options, cfg),
                             cfg["sample_rate"], cfg["bits_per_sample"], ch,
                             header["total"])
    out = sys.stdout.buffer
    step = block * ch
    for i in range(header["frames"]):
        data = ref_encode.encode_frame(
            enc.options, enc.streaminfo, header["first"] + i,
            list(deinterleave(pcm[i * step:(i + 1) * step], ch)))
        out.write(struct.pack("<I", len(data)) + data)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
