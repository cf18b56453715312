"""flac-tag — metaflac --set-tag via metadata.update
(reference: examples/flac-tag.rs).
"""

from __future__ import annotations

import argparse

from .. import metadata as meta


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-tag")
    p.add_argument("file")
    p.add_argument("tags", nargs="+", help="KEY=value pairs")
    args = p.parse_args(argv)

    pairs = []
    for t in args.tags:
        key, sep, value = t.partition("=")
        if not sep:
            p.error(f"tag {t!r} is not KEY=value")
        pairs.append((key, value))

    def apply(blocks: meta.BlockList) -> None:
        def set_tags(vc: meta.VorbisComment) -> None:
            for key, value in pairs:
                vc.set(key, value)

        blocks.update(meta.VorbisComment, set_tags)

    meta.update(args.file, apply)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
