"""flac-play — decode to the default audio device
(reference: examples/flac-play.rs, cpal-based).

Uses ``sounddevice`` when available; otherwise falls back to writing raw
PCM to stdout (pipe into aplay/sox) since this image has no audio stack.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..decode import FlacSampleReader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-play")
    p.add_argument("input")
    p.add_argument("--stdout", action="store_true",
                   help="write f32 PCM to stdout instead of playing")
    args = p.parse_args(argv)

    r = FlacSampleReader(args.input)
    si = r.streaminfo
    scale = float(1 << (si.bits_per_sample - 1))

    def frames():
        while True:
            buf = r.fill_buf()
            if buf.size == 0:
                return
            r.consume(buf.size)
            yield (buf.astype(np.float32) / scale).reshape(-1, si.channels)

    if args.stdout:
        for chunk in frames():
            sys.stdout.buffer.write(chunk.tobytes())
        return 0

    try:
        import sounddevice as sd
    except ImportError:
        print("no audio backend available; use --stdout | aplay -f FLOAT_LE "
              f"-r {si.sample_rate} -c {si.channels}", file=sys.stderr)
        return 1

    with sd.OutputStream(samplerate=si.sample_rate, channels=si.channels,
                         dtype="float32") as stream:
        for chunk in frames():
            stream.write(chunk)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
