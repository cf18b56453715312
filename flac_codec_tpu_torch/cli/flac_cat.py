"""flac-cat — concatenate FLAC files (reference: examples/flac-cat.rs).
Inputs must share sample rate / channels / bits per sample.
"""

from __future__ import annotations

import argparse

from ..decode import FlacSampleReader
from ..encode import FlacSampleWriter, Options
from ..errors import FlacError


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-cat")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    readers = [FlacSampleReader(path) for path in args.inputs]
    first = readers[0].streaminfo
    for r, path in zip(readers, args.inputs):
        si = r.streaminfo
        if (si.sample_rate, si.channels, si.bits_per_sample) != (
                first.sample_rate, first.channels, first.bits_per_sample):
            raise FlacError(f"parameter mismatch in {path}")

    total = None
    if all(r.streaminfo.total_samples is not None for r in readers):
        total = sum(r.streaminfo.total_samples for r in readers)

    w = FlacSampleWriter(args.output, Options(), first.sample_rate,
                         first.bits_per_sample, first.channels,
                         total_samples=total)
    for r in readers:
        while True:
            buf = r.fill_buf()
            if buf.size == 0:
                break
            r.consume(buf.size)
            w.write(buf)
        r.close()
    w.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
