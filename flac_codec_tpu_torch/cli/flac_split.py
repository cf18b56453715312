"""flac-split — split a FLAC by its embedded CUESHEET
(reference: examples/flac-split.rs; parallel per track via cloned readers).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os

from .. import metadata as meta
from ..decode import FlacByteReader, FlacSampleReader
from ..encode import FlacByteWriter, FlacSampleWriter, Options
from ..errors import FlacError


def _split_one(path: str, out_dir: str, index: int, start: int, end) -> str:
    r = FlacSampleReader(path)
    si = r.streaminfo
    end = end if end is not None else si.total_samples
    r.seek(start)
    out_path = os.path.join(out_dir, f"track{index:02d}.flac")
    # end can be unknown (no lead-out track AND no STREAMINFO total):
    # stream to end of input with an unknown output total
    w = FlacSampleWriter(out_path, Options(), si.sample_rate,
                         si.bits_per_sample, si.channels,
                         total_samples=(end - start) if end is not None
                         else None)
    remaining = ((end - start) * si.channels if end is not None
                 else None)
    while remaining is None or remaining > 0:
        want = min(remaining, 1 << 20) if remaining is not None else 1 << 20
        buf = r.read(want)
        if buf.size == 0:
            break
        w.write(buf)
        if remaining is not None:
            remaining -= buf.size
    w.finalize()
    r.close()
    return out_path


def _split_one_bytes(path: str, out_dir: str, index: int,
                     start: int, end) -> str:
    """Byte-range split via Cuesheet.track_byte_ranges + FlacByteReader
    (reference API: src/metadata/mod.rs:3390-3411)."""
    r = FlacByteReader.open(path)
    si = r.streaminfo
    width = (si.bits_per_sample + 7) // 8
    if end is None and si.total_samples is not None:
        end = si.total_samples * si.channels * width
    r.seek(start)
    out_path = os.path.join(out_dir, f"track{index:02d}.flac")
    w = FlacByteWriter(out_path, Options(), si.sample_rate,
                       si.bits_per_sample, si.channels,
                       total_bytes=(end - start) if end is not None else None)
    remaining = (end - start) if end is not None else None
    while remaining is None or remaining > 0:
        want = min(remaining, 1 << 20) if remaining is not None else 1 << 20
        buf = r.read(want)
        if not buf:
            break
        w.write(buf)
        if remaining is not None:
            remaining -= len(buf)
    w.finalize()
    r.close()
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-split")
    p.add_argument("input")
    p.add_argument("-d", "--output-dir", default=".")
    p.add_argument("-j", "--jobs", type=int, default=os.cpu_count())
    p.add_argument("--bytes", action="store_true",
                   help="split by PCM byte ranges (track_byte_ranges) "
                        "instead of sample ranges")
    args = p.parse_args(argv)

    cs = meta.read_block(args.input, meta.Cuesheet)
    if cs is None:
        raise FlacError("no CUESHEET block in input")
    os.makedirs(args.output_dir, exist_ok=True)
    if args.bytes:
        si = meta.read_info(args.input)
        ranges = cs.track_byte_ranges(si.channels, si.bits_per_sample)
        worker = _split_one_bytes
    else:
        ranges = cs.track_sample_ranges()
        worker = _split_one

    with concurrent.futures.ProcessPoolExecutor(args.jobs) as ex:
        futures = [
            ex.submit(worker, args.input, args.output_dir, i + 1, s, e)
            for i, (s, e) in enumerate(ranges)]
        for f in concurrent.futures.as_completed(futures):
            print(f.result())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
