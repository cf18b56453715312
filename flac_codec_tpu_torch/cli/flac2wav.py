"""flac2wav — FLAC -> RIFF/WAVE through the port's batch decoder.

The port's counterpart of ``python -m flac_codec_tpu.cli flac2wav --tpu``
(``convert_one_tpu``): it always decodes through ``flac_codec_tpu_torch.
parallel.batch_decode.BatchDecoder`` on ``--device`` (default ``cuda``),
one file after another on the one device whatever ``-j`` says, and writes
the same WAV bytes.  ``--tpu`` and ``-j`` are accepted for the JAX tool's
command lines.  ``--device-parse`` parses the frame bodies on the device
(the JAX package's ``FLAC_TPU_DEVICE_PARSE=1``).  ``convert_one(...,
tpu=False)`` decodes on the host, as the JAX ``convert_one`` does.

    python -m flac_codec_tpu_torch.cli flac2wav [--tpu] [-j N] [-o OUT]
        [--device cpu] [--device-parse] a.flac
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import metadata as meta
from ..decode import FlacSampleReader
from ..errors import FlacError
from ..utils.wav import pcm_to_wave_bytes, write_wave


def _channel_mask(blocks):
    """Validated WAVEFORMATEXTENSIBLE channel mask from the tags, or None."""
    vc = blocks.get(meta.VorbisComment)
    if vc is not None:
        raw = vc.get(meta.fields.WAVEFORMATEXTENSIBLE_CHANNEL_MASK)
        if raw:
            try:
                mask = int(raw, 16)
                if 0 <= mask < (1 << 18):  # defined WAVEFORMATEXTENSIBLE bits
                    return mask
            except ValueError:
                pass
    return None


def convert_one(path: str, out_path: str, tpu: bool = True, *,
                device="cuda", device_parse: bool = False) -> str:
    """Decode ``path`` to ``out_path`` as WAV: on ``device`` through
    ``convert_one_tpu`` (the default), or with ``tpu=False`` through the
    host ``FlacSampleReader``, an explicit request for the host."""
    if tpu:
        return convert_one_tpu(path, out_path, device=device,
                               device_parse=device_parse)
    r = FlacSampleReader(path)
    si = r.streaminfo
    mask = _channel_mask(r.metadata())
    with open(out_path, "wb") as fout:
        write_wave(fout, si.sample_rate, si.channels, si.bits_per_sample,
                   si.total_samples or 0, mask)
        while True:
            buf = r.fill_buf()
            if buf.size == 0:
                break
            r.consume(buf.size)
            fout.write(pcm_to_wave_bytes(buf, si.bits_per_sample))
    r.close()
    return out_path


def convert_one_tpu(path: str, out_path: str, *, device="cuda",
                    device_parse: bool = False) -> str:
    """Decode ``path`` on ``device`` (PCM copied to the host per batch),
    parsing on the device with ``device_parse``, and write it to
    ``out_path`` as WAV."""
    from ..parallel.batch_decode import BatchDecoder

    with BatchDecoder(path, device=device,
                      device_parse=device_parse) as dec, \
            open(out_path, "wb") as fout:
        si = dec.streaminfo
        write_wave(fout, si.sample_rate, si.channels, si.bits_per_sample,
                   si.total_samples or 0, _channel_mask(dec.decoder.blocks))
        while True:
            flat = dec.read_batch_interleaved()
            if flat is None:
                break
            fout.write(pcm_to_wave_bytes(flat.cpu().numpy().reshape(-1),
                                         si.bits_per_sample))
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac2wav")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", default=None,
                   help="output file (single input) or directory")
    p.add_argument("-j", "--jobs", type=int, default=os.cpu_count(),
                   help="accepted for the JAX package's command lines; the "
                        "files decode one after another on the one device")
    p.add_argument("--tpu", action="store_true",
                   help="accepted for the JAX package's command lines; the "
                        "port always decodes on --device")
    p.add_argument("--device", default="cuda",
                   help="torch device of the decoder (default cuda)")
    p.add_argument("--device-parse", action="store_true",
                   help="parse the frame bodies on the device")
    args = p.parse_args(argv)

    # surface per-file errors as clean diagnostics, not tracebacks (the
    # reference CLI prints "<path>: <error>" and continues; exit nonzero)
    failed = 0
    for path in args.inputs:
        if (args.output and len(args.inputs) == 1
                and not os.path.isdir(args.output)):
            out = args.output
        else:
            base = os.path.splitext(os.path.basename(path))[0] + ".wav"
            out = os.path.join(args.output or os.path.dirname(path) or ".",
                               base)
        try:
            print(convert_one_tpu(path, out, device=args.device,
                                  device_parse=args.device_parse))
        except (OSError, FlacError) as e:
            print(f"{path}: {e}", file=sys.stderr)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
