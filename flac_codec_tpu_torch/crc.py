"""CRC-8 (poly 0x07) and CRC-16 (poly 0x8005) engines.

Behavioral parity with the reference CRC engine (reference: src/crc.rs:1-188):
both CRCs use initial value 0, no reflection, no final XOR, and a stream that
*includes* its trailing CRC bytes hashes to residue 0 (``valid()``).

The byte loop runs in the native engine (``flac_codec_tpu_torch.native``),
which the port requires.
"""

from __future__ import annotations


def _native():
    from . import native

    return native.load()


def crc8(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """CRC-8 of ``data``, continuing from ``crc``."""
    return _native().crc8(bytes(data), crc)


def crc16(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """CRC-16 of ``data``, continuing from ``crc``."""
    return _native().crc16(bytes(data), crc)


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
