"""flac-add-cover — embed a front cover image
(reference: examples/flac-add-cover.rs via Picture::open + update).
"""

from __future__ import annotations

import argparse

from .. import metadata as meta


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-add-cover")
    p.add_argument("flac_file")
    p.add_argument("image")
    p.add_argument("--description", default="")
    args = p.parse_args(argv)

    picture = meta.Picture.open(args.image, meta.Picture.FRONT_COVER,
                                args.description)

    def apply(blocks: meta.BlockList) -> None:
        blocks.blocks = [b for b in blocks.blocks
                         if not (isinstance(b, meta.Picture)
                                 and b.picture_type == meta.Picture.FRONT_COVER)]
        blocks.blocks.append(picture)

    meta.update(args.flac_file, apply)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
