# Frozen copy of flac_codec_tpu_torch/crc.py at commit be3fb28, with the
# native byte loop replaced by numpy (the table loop of
# flac_codec_tpu/crc.py, and a tree of table lookups for long buffers).
"""CRC-8 (poly 0x07) and CRC-16 (poly 0x8005) engines.

Both CRCs use initial value 0, no reflection and no final XOR, and a
stream that *includes* its trailing CRC bytes hashes to residue 0
(``valid()``).

A CRC with initial value 0 is linear over GF(2), so the CRC of ``A || B``
is the CRC of ``A`` advanced over ``len(B)`` zero bytes, XOR the CRC of
``B``; and leading zero bytes leave it 0.  Long buffers are therefore
reduced as a tree: each byte's CRC from the table, then pairs of
neighbouring blocks joined level by level, advancing the left block's CRC
over ``2**level`` zero bytes with a table over every 16-bit state.
"""

from __future__ import annotations

import numpy as np


def _make_table(poly: int, width: int) -> np.ndarray:
    """The 256-entry table of an MSB-first CRC of ``width`` bits."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table[i] = crc
    return table


CRC8_TABLE = _make_table(0x07, 8).astype(np.uint8)
CRC16_TABLE = _make_table(0x8005, 16).astype(np.uint16)

# below this many bytes the scalar loop is faster than the tree
_TREE_MIN = 64


def _advance(level: int) -> np.ndarray:
    """The table (by CRC-16 state) that advances a state over
    ``2**level`` zero bytes."""
    while len(_ADVANCE) <= level:
        if not _ADVANCE:
            s = np.arange(1 << 16, dtype=np.uint32)
            _ADVANCE.append((((s << 8) & 0xFFFF)
                             ^ CRC16_TABLE[s >> 8]).astype(np.uint16))
        else:
            last = _ADVANCE[-1]
            _ADVANCE.append(last[last])
    return _ADVANCE[level]


_ADVANCE: list = []


def _crc16_tree(data: np.ndarray) -> int:
    n = len(data)
    levels = max(int(n - 1).bit_length(), 0)
    padded = np.zeros(1 << levels, dtype=np.uint8)
    padded[(1 << levels) - n:] = data  # leading zeros change nothing
    crcs = CRC16_TABLE[padded]
    for level in range(levels):
        crcs = _advance(level)[crcs[0::2]] ^ crcs[1::2]
    return int(crcs[0])


def crc8(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """CRC-8 of ``data``, continuing from ``crc``."""
    table = CRC8_TABLE
    for b in bytes(data):
        crc = int(table[crc ^ b])
    return crc


def crc16(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """CRC-16 of ``data``, continuing from ``crc``."""
    data = bytes(data)
    if len(data) < _TREE_MIN:
        table = CRC16_TABLE
        for b in data:
            crc = ((crc << 8) & 0xFFFF) ^ int(table[(crc >> 8) ^ b])
        return crc
    value = _crc16_tree(np.frombuffer(data, dtype=np.uint8))
    # continuing from crc: crc(P || D) = crc(P) advanced over len(D) zero
    # bytes, XOR crc(D)
    level = 0
    n = len(data)
    while crc and n:
        if n & 1:
            crc = int(_advance(level)[crc])
        n >>= 1
        level += 1
    return value ^ crc


class Crc8:
    """Streaming CRC-8 accumulator (reference: src/crc.rs Crc8)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def update(self, data: bytes) -> None:
        self.value = crc8(data, self.value)

    def valid(self) -> bool:
        return self.value == 0


class Crc16:
    """Streaming CRC-16 accumulator (reference: src/crc.rs Crc16)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def update(self, data: bytes) -> None:
        self.value = crc16(data, self.value)

    def valid(self) -> bool:
        return self.value == 0
