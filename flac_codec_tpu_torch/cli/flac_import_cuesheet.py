"""flac-import-cuesheet — embed .cue text as a CUESHEET block
(reference: examples/flac-import-cuesheet.rs).
"""

from __future__ import annotations

import argparse

from .. import metadata as meta
from ..metadata.cuesheet import parse_cuesheet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-import-cuesheet")
    p.add_argument("flac_file")
    p.add_argument("cue_file")
    args = p.parse_args(argv)

    info = meta.read_info(args.flac_file)
    cs = parse_cuesheet(open(args.cue_file).read(),
                        lead_out_offset=info.total_samples)

    def apply(blocks: meta.BlockList) -> None:
        blocks.remove(meta.Cuesheet)
        blocks.blocks.append(cs)

    meta.update(args.flac_file, apply)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
