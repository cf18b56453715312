"""wav2flac — RIFF/WAVE -> FLAC through the port's batch encoder.

The port's counterpart of ``python -m flac_codec_tpu.cli wav2flac --tpu``:
it always encodes through ``flac_codec_tpu_torch.parallel.batch.
BatchEncoder`` on ``--device`` (default ``cuda``), and takes the JAX
tool's flags (``add_common_args``; ``--tpu`` is accepted and changes
nothing).  ``build_options`` is a copy of the JAX package's, so presets
and flags mean the same.  ``--batch-frames`` defaults to 256, not 64.

    python -m flac_codec_tpu_torch.cli wav2flac [--tpu] --best in.wav out.flac
"""

from __future__ import annotations

import argparse

from .. import metadata as meta
from ..encode import Options
from ..utils.wav import read_wave_data, read_wave_header


def build_options(args) -> Options:
    opts = Options.fast() if args.fast else (
        Options.best() if args.best else Options())
    if args.block_size:
        opts = opts.with_block_size(args.block_size)
    if args.no_padding:
        opts = opts.no_padding()
    return opts


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The JAX package's flags, plus the port's ``--device`` and
    ``--analysis``.  ``--tpu`` is accepted and changes nothing: the port
    always encodes through ``BatchEncoder`` on ``--device``.
    ``--batch-frames`` defaults to 256 (the JAX package's to 64)."""
    p.add_argument("--fast", action="store_true", help="fast preset")
    p.add_argument("--best", action="store_true", help="max compression (-8)")
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--no-padding", action="store_true")
    p.add_argument("--tpu", action="store_true",
                   help="accepted for the JAX package's command lines; the "
                        "port always encodes on --device")
    p.add_argument("--batch-frames", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device of the encode planner (default cuda)")
    p.add_argument("--analysis", choices=("auto", "f32", "f64"),
                   default="auto",
                   help="LPC analysis precision; f64 (and auto) give bytes "
                        "identical to the host encoder")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wav2flac")
    p.add_argument("input")
    p.add_argument("output")
    add_common_args(p)
    args = p.parse_args(argv)

    from ..parallel.batch import BatchEncoder

    opts = build_options(args)
    with open(args.input, "rb") as fin:
        spec = read_wave_header(fin)
        width = (spec.bits_per_sample + 7) // 8
        total = spec.data_size // (width * spec.channels)
        if spec.channel_mask is not None:
            opts = opts.tag(meta.fields.WAVEFORMATEXTENSIBLE_CHANNEL_MASK,
                            f"0x{spec.channel_mask:04x}")
        writer = BatchEncoder(args.output, opts, spec.sample_rate,
                              spec.bits_per_sample, spec.channels,
                              total_samples=total,
                              batch_frames=args.batch_frames,
                              analysis=args.analysis, device=args.device)
        for chunk in read_wave_data(fin, spec):
            writer.write(chunk)
        writer.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
