"""CLI of the port: ``python -m flac_codec_tpu_torch.cli <tool> [args...]``.

``wav2flac`` and ``flac2wav`` are ported; the other tools of the JAX
package's ``cli`` run on the host and need no port.
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {"wav2flac": "wav2flac", "flac2wav": "flac2wav"}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m flac_codec_tpu_torch.cli <tool> [args...]\n"
              "tools:\n" + "\n".join(f"  {name}" for name in TOOLS))
        return 0
    if argv[0] not in TOOLS:
        print(f"unknown tool {argv[0]!r}", file=sys.stderr)
        return 2
    mod = importlib.import_module(f".{TOOLS[argv[0]]}", __name__)
    return mod.main(argv[1:]) or 0
