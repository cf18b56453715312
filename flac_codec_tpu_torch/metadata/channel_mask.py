"""WAVEFORMATEXTENSIBLE channel mask (reference:
src/metadata/mod.rs:4877-5106).

18-channel bitmask with the standard speaker positions, ``0x%04x``
parse/format, and the default masks FLAC assumes for 1-8 channels
(reference: src/metadata/mod.rs:4935-4991).
"""

from __future__ import annotations

from typing import List, Tuple

from ..errors import InvalidMetadata

CHANNELS: List[Tuple[str, int]] = [
    ("front_left", 0x0001),
    ("front_right", 0x0002),
    ("front_center", 0x0004),
    ("lfe", 0x0008),
    ("back_left", 0x0010),
    ("back_right", 0x0020),
    ("front_left_of_center", 0x0040),
    ("front_right_of_center", 0x0080),
    ("back_center", 0x0100),
    ("side_left", 0x0200),
    ("side_right", 0x0400),
    ("top_center", 0x0800),
    ("top_front_left", 0x1000),
    ("top_front_center", 0x2000),
    ("top_front_right", 0x4000),
    ("top_back_left", 0x8000),
    ("top_back_center", 0x10000),
    ("top_back_right", 0x20000),
]

_BY_NAME = dict(CHANNELS)

# default masks for 1-8 channels (reference: src/metadata/mod.rs:4935-4991)
_DEFAULTS = {
    1: 0x0004,                      # FC
    2: 0x0003,                      # FL FR
    3: 0x0007,                      # FL FR FC
    4: 0x0033,                      # FL FR BL BR
    5: 0x0607,                      # FL FR FC SL SR
    6: 0x060F,                      # FL FR FC LFE SL SR
    7: 0x070F,                      # FL FR FC LFE BC SL SR
    8: 0x063F,                      # FL FR FC LFE BL BR SL SR
}


class ChannelMask:
    """Bitmask of speaker positions."""

    def __init__(self, mask: int = 0):
        if mask >= (1 << 18):
            raise InvalidMetadata(f"channel mask {mask:#x}")
        self.mask = mask

    @classmethod
    def default_for(cls, channels: int) -> "ChannelMask":
        return cls(_DEFAULTS.get(channels, 0))

    @classmethod
    def parse(cls, text: str) -> "ChannelMask":
        """Parse the 0x%04x VorbisComment representation."""
        try:
            return cls(int(text, 16))
        except ValueError:
            raise InvalidMetadata(f"channel mask {text!r}")

    def __str__(self) -> str:
        return f"0x{self.mask:04x}"

    def __eq__(self, other):
        return isinstance(other, ChannelMask) and self.mask == other.mask

    def channels(self) -> List[str]:
        return [name for name, bit in CHANNELS if self.mask & bit]

    def count(self) -> int:
        return bin(self.mask).count("1")

    def with_channel(self, name: str) -> "ChannelMask":
        bit = _BY_NAME.get(name)
        if bit is None:
            raise InvalidMetadata(f"unknown channel {name!r}")
        return ChannelMask(self.mask | bit)
