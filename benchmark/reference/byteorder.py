# Frozen copy of flac_codec_tpu_torch/byteorder.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""PCM sample <-> byte conversion for 8/16/24/32-bit widths, LE/BE.

Vectorized (numpy) equivalent of the reference's endianness engine
(reference: src/byteorder.rs:1-243): signed samples, ceil(bps/8)-byte
containers, with correct sign handling for the 24-bit case.
"""

from __future__ import annotations

import numpy as np


def bytes_per_sample(bits_per_sample: int) -> int:
    return (bits_per_sample + 7) // 8


def samples_to_bytes(samples: np.ndarray, bits_per_sample: int,
                     big_endian: bool = False) -> bytes:
    """Interleaved int samples -> packed signed PCM bytes."""
    width = bytes_per_sample(bits_per_sample)
    s = np.asarray(samples)
    if width == 1:
        out = s.astype(np.int8).view(np.uint8)
        return out.tobytes()
    if width == 2:
        dt = ">i2" if big_endian else "<i2"
        return s.astype(np.int16).astype(dt).tobytes()
    if width == 4:
        dt = ">i4" if big_endian else "<i4"
        return s.astype(np.int32).astype(dt).tobytes()
    # 24-bit: emit 3 of each sample's 4 little-endian bytes
    v = s.astype(np.int32).astype("<i4").view(np.uint8).reshape(-1, 4)
    three = v[:, :3]
    if big_endian:
        three = three[:, ::-1]
    return np.ascontiguousarray(three).tobytes()


def bytes_to_samples(data: bytes | memoryview, bits_per_sample: int,
                     big_endian: bool = False) -> np.ndarray:
    """Packed signed PCM bytes -> interleaved int32 samples."""
    width = bytes_per_sample(bits_per_sample)
    raw = np.frombuffer(data, dtype=np.uint8)
    if width == 1:
        return raw.view(np.int8).astype(np.int32)
    if width == 2:
        dt = ">i2" if big_endian else "<i2"
        return np.frombuffer(data, dtype=dt).astype(np.int32)
    if width == 4:
        dt = ">i4" if big_endian else "<i4"
        return np.frombuffer(data, dtype=dt).astype(np.int32)
    trip = raw.reshape(-1, 3)
    if big_endian:
        trip = trip[:, ::-1]
    v = (trip[:, 0].astype(np.uint32)
         | (trip[:, 1].astype(np.uint32) << 8)
         | (trip[:, 2].astype(np.uint32) << 16))
    # sign-extend 24 -> 32
    v = np.where(v & 0x800000, v | 0xFF000000, v)
    return v.astype(np.uint32).view(np.int32).astype(np.int32)


def interleave(channels: np.ndarray) -> np.ndarray:
    """(C, N) channel-major -> (C*N,) interleaved (reference: src/audio.rs
    MultiZip iteration)."""
    return np.asarray(channels).T.reshape(-1)


def deinterleave(samples: np.ndarray, channel_count: int) -> np.ndarray:
    """(C*N,) interleaved -> (C, N) channel-major."""
    s = np.asarray(samples)
    return s.reshape(-1, channel_count).T
