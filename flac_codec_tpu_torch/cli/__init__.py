"""CLI of the port: ``python -m flac_codec_tpu_torch.cli <tool> [args...]``.

The JAX package's 14 tools (reference: examples/*.rs).  ``wav2flac`` and
``flac2wav`` run through the port's batch encoder and decoder on
``--device`` (default ``cuda``); the other twelve run on the host and are
copies of the JAX package's.
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {
    "wav2flac": "wav2flac",
    "flac2wav": "flac2wav",
    "flac-info": "flac_info",
    "flac-analyze": "flac_analyze",
    "flac-verify": "flac_verify",
    "flac-tag": "flac_tag",
    "flac-cat": "flac_cat",
    "flac-split": "flac_split",
    "flac-play": "flac_play",
    "flac-resample": "flac_resample",
    "flac-add-cover": "flac_add_cover",
    "flac-view-artwork": "flac_view_artwork",
    "flac-import-cuesheet": "flac_import_cuesheet",
    "flac-export-cuesheet": "flac_export_cuesheet",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m flac_codec_tpu_torch.cli <tool> [args...]\n"
              "tools:\n" + "\n".join(f"  {name}" for name in TOOLS))
        return 0
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}", file=sys.stderr)
        return 2
    mod = importlib.import_module(f".{TOOLS[tool]}", __name__)
    try:
        return mod.main(argv[1:]) or 0
    except Exception as e:
        # expected failures (missing or unreadable files, invalid streams)
        # print one line, as the reference examples do; anything else is a
        # bug and keeps its traceback
        from ..errors import FlacError

        if isinstance(e, (OSError, FlacError, ValueError)):
            print(f"{tool}: {e}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    raise SystemExit(main())
