"""RIFF/WAVE container read/write (reference: examples/wav2flac.rs /
flac2wav.rs).

Handles standard PCM fmt chunks and WAVE_FORMAT_EXTENSIBLE (with channel
mask -> WAVEFORMATEXTENSIBLE_CHANNEL_MASK tag round-trip), the
unsigned->signed 8-bit shim (reference: examples/wav2flac.rs:133-146), and
valid-bits-in-wider-container layouts (e.g. 24 valid bits in 32-bit
containers, MSB-justified per WAVEFORMATEXTENSIBLE).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np

from ..byteorder import bytes_to_samples, samples_to_bytes
from ..errors import FlacError

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
_PCM_GUID = (b"\x01\x00\x00\x00\x00\x00\x10\x00"
             b"\x80\x00\x00\xaa\x00\x38\x9b\x71")


class WaveError(FlacError):
    pass


@dataclass
class WaveSpec:
    sample_rate: int
    channels: int
    bits_per_sample: int                # valid (audio) bits per sample
    channel_mask: Optional[int] = None  # WAVE_FORMAT_EXTENSIBLE only
    data_size: int = 0
    container_bits: int = 0             # storage width; 0 -> valid bits

    def __post_init__(self):
        if not self.container_bits:
            self.container_bits = (self.bits_per_sample + 7) // 8 * 8


def read_wave_header(fp: BinaryIO) -> WaveSpec:
    """Parse RIFF header up to (and positioned at) the data chunk."""
    riff = fp.read(12)
    if len(riff) != 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise WaveError("not a RIFF/WAVE file")
    spec: Optional[WaveSpec] = None
    while True:
        hdr = fp.read(8)
        if len(hdr) < 8:
            raise WaveError("no data chunk")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            body = fp.read(size)
            if len(body) < 16:
                raise WaveError("short fmt chunk")
            (fmt, channels, rate, _byte_rate, _align, container
             ) = struct.unpack_from("<HHIIHH", body, 0)
            mask = None
            valid = container
            if fmt == WAVE_FORMAT_EXTENSIBLE:
                if size < 40 or len(body) < 40:
                    raise WaveError("short extensible fmt chunk")
                (_ext_size, vb, mask) = struct.unpack_from("<HHI", body, 16)
                guid = body[24:40]
                if guid != _PCM_GUID:
                    raise WaveError("non-PCM extensible WAVE")
                valid = vb or container
            elif fmt != WAVE_FORMAT_PCM:
                raise WaveError(f"unsupported WAVE format {fmt:#x}")
            if channels < 1 or not 1 <= valid <= 32 or container < valid \
                    or container % 8 or container > 32:
                raise WaveError(
                    f"invalid fmt fields: channels={channels} "
                    f"valid_bits={valid} container_bits={container}")
            spec = WaveSpec(rate, channels, valid, mask,
                            container_bits=container)
            if size % 2:
                fp.read(1)
        elif cid == b"data":
            if spec is None:
                raise WaveError("data chunk before fmt chunk")
            spec.data_size = size
            return spec
        else:
            fp.seek(size + (size % 2), 1)


def read_wave_data(fp: BinaryIO, spec: WaveSpec,
                   chunk_bytes: int = 1 << 20) -> Iterator[np.ndarray]:
    """Yield interleaved int32 sample chunks (8-bit unsigned -> signed;
    valid bits are the high bits of wider containers, shifted down)."""
    remaining = spec.data_size
    width = spec.container_bits // 8
    shift = spec.container_bits - spec.bits_per_sample
    while remaining > 0:
        take = min(chunk_bytes, remaining)
        take -= take % (width * spec.channels)
        if take == 0:
            break
        data = fp.read(take)
        if not data:
            break
        if len(data) % (width * spec.channels):
            raise WaveError(
                f"truncated data chunk: got {len(data)} of {take} bytes")
        remaining -= len(data)
        if spec.container_bits <= 8:
            samples = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
            samples -= 128
        else:
            samples = bytes_to_samples(data, spec.container_bits)
        if shift:
            samples = samples >> shift  # MSB-justified valid bits
        yield samples


def write_wave(fp: BinaryIO, sample_rate: int, channels: int,
               bits_per_sample: int, total_samples: int,
               channel_mask: Optional[int] = None) -> None:
    """Write WAVE headers; caller then writes raw PCM data bytes (see
    :func:`pcm_to_wave_bytes` for the matching sample layout).

    Uses WAVE_FORMAT_EXTENSIBLE when channels > 2, bps > 16, bps is not a
    whole number of bytes, or an explicit channel mask is given
    (reference: examples/flac2wav.rs:140-151).
    """
    width = (bits_per_sample + 7) // 8
    data_size = total_samples * channels * width
    byte_rate = sample_rate * channels * width
    align = channels * width

    extensible = (channels > 2 or bits_per_sample > 16
                  or bits_per_sample % 8 != 0 or channel_mask is not None)
    if extensible:
        fmt = struct.pack("<HHIIHH", WAVE_FORMAT_EXTENSIBLE, channels,
                          sample_rate, byte_rate, align, width * 8)
        fmt += struct.pack("<HHI", 22, bits_per_sample, channel_mask or 0)
        fmt += _PCM_GUID
    else:
        fmt = struct.pack("<HHIIHH", WAVE_FORMAT_PCM, channels, sample_rate,
                          byte_rate, align, bits_per_sample)

    # data is the final chunk; no trailing pad byte is written for odd
    # sizes (and none is counted — counting an unwritten byte would make
    # the declared RIFF size wrong the other way)
    riff_size = 4 + (8 + len(fmt)) + (8 + data_size)
    if riff_size > 0xFFFFFFFF or data_size > 0xFFFFFFFF:
        raise WaveError(
            f"PCM payload of {data_size} bytes exceeds the 4 GiB RIFF "
            "limit (RF64 not supported)")
    fp.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
    fp.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
    fp.write(b"data" + struct.pack("<I", data_size))


def pcm_to_wave_bytes(samples: np.ndarray, bits_per_sample: int) -> bytes:
    """Interleaved samples -> WAVE data bytes (8-bit goes unsigned;
    non-byte-multiple depths are MSB-justified in their container to
    match the EXTENSIBLE header written by :func:`write_wave`)."""
    if bits_per_sample <= 8:
        shift = 8 - bits_per_sample
        out = (np.asarray(samples, dtype=np.int32) << shift) + 128
        return out.astype(np.uint8).tobytes()
    shift = (-bits_per_sample) % 8
    if shift:
        samples = np.asarray(samples, dtype=np.int64) << shift
    return samples_to_bytes(samples, bits_per_sample + shift)
