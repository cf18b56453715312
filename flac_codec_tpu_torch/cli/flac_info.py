"""flac-info — metaflac --list equivalent (reference: examples/flac-info.rs).
Pretty-prints every metadata block of each input file.
"""

from __future__ import annotations

import argparse

from .. import metadata as meta


def _print_block(i: int, b, last: bool) -> None:
    names = {0: "STREAMINFO", 1: "PADDING", 2: "APPLICATION", 3: "SEEKTABLE",
             4: "VORBIS_COMMENT", 5: "CUESHEET", 6: "PICTURE"}
    size = len(b.to_bytes())
    print(f"METADATA block #{i}")
    print(f"  type: {b.TYPE} ({names.get(b.TYPE, '?')})")
    print(f"  is last: {str(last).lower()}")
    print(f"  length: {size}")
    if isinstance(b, meta.Streaminfo):
        print(f"  minimum blocksize: {b.minimum_block_size} samples")
        print(f"  maximum blocksize: {b.maximum_block_size} samples")
        print(f"  minimum framesize: {b.minimum_frame_size or 0} bytes")
        print(f"  maximum framesize: {b.maximum_frame_size or 0} bytes")
        print(f"  sample_rate: {b.sample_rate} Hz")
        print(f"  channels: {b.channels}")
        print(f"  bits-per-sample: {b.bits_per_sample}")
        print(f"  total samples: {b.total_samples or 0}")
        print(f"  MD5 signature: {(b.md5 or b'').hex() or '0' * 32}")
    elif isinstance(b, meta.SeekTable):
        print(f"  seek points: {len(b.points)}")
        for j, p in enumerate(b.points):
            if p.is_placeholder:
                print(f"    point {j}: PLACEHOLDER")
            else:
                print(f"    point {j}: sample_number={p.sample_offset}, "
                      f"stream_offset={p.byte_offset}, "
                      f"frame_samples={p.frame_samples}")
    elif isinstance(b, meta.VorbisComment):
        print(f"  vendor string: {b.vendor}")
        print(f"  comments: {len(b.fields)}")
        for j, f in enumerate(b.fields):
            print(f"    comment[{j}]: {f}")
    elif isinstance(b, meta.Picture):
        print(f"  type: {b.picture_type} ({b.type_name()})")
        print(f"  MIME type: {b.mime_type}")
        print(f"  description: {b.description}")
        print(f"  width: {b.width}")
        print(f"  height: {b.height}")
        print(f"  depth: {b.color_depth}")
        print(f"  colors: {b.colors_used}")
        print(f"  data length: {len(b.data)}")
    elif isinstance(b, meta.Application):
        print(f"  application ID: {b.id.hex()}")
        print(f"  data length: {len(b.data)}")
    elif isinstance(b, meta.Cuesheet):
        catalog = b.catalog.rstrip(b"\x00").decode("ascii", "replace")
        print(f"  media catalog number: {catalog}")
        print(f"  lead-in: {b.lead_in}")
        print(f"  is CD: {str(b.is_cdda).lower()}")
        print(f"  number of tracks: {len(b.tracks)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-info")
    p.add_argument("inputs", nargs="+")
    args = p.parse_args(argv)
    for path in args.inputs:
        if len(args.inputs) > 1:
            print(f"{path}:")
        with open(path, "rb") as fp:
            blocks = meta.read_blocks(fp)
        allb = blocks.all_blocks()
        for i, b in enumerate(allb):
            _print_block(i, b, i == len(allb) - 1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
