"""flac-export-cuesheet — dump an embedded CUESHEET block as .cue text
(reference: examples/flac-export-cuesheet.rs).
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import metadata as meta
from ..metadata.cuesheet import render_cuesheet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-export-cuesheet")
    p.add_argument("flac_file")
    args = p.parse_args(argv)

    cs = meta.read_block(args.flac_file, meta.Cuesheet)
    if cs is None:
        print("no CUESHEET block", file=sys.stderr)
        return 1
    sys.stdout.write(render_cuesheet(
        cs, os.path.basename(args.flac_file)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
