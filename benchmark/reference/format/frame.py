# Frozen copy of flac_codec_tpu_torch/format/frame.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Frame header field codecs (reference: src/stream.rs:84-1356).

All values are plain ints; the 4-bit/3-bit code tables and escape rules are
RFC 9639's.  Densest-encoding choices mirror the reference's TryFrom impls
(src/stream.rs:768-802 for sample rate, :666-695 for block size) so that
streams are bit-identical at matched parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import crc as crcmod
from ..bitio import BitReader, BitWriter
from ..errors import (
    BitsPerSampleMismatch,
    BlockSizeMismatch,
    ChannelsMismatch,
    Crc8Mismatch,
    ExcessiveFrameNumber,
    InvalidBitsPerSample,
    InvalidBlockSize,
    InvalidChannels,
    InvalidFrameNumber,
    InvalidSampleRate,
    InvalidSyncCode,
    SampleRateMismatch,
)

SYNC_CODE = 0b111111111111100  # 15 bits (reference: src/stream.rs:148)

# 4-bit block size code -> samples (None = escape/reserved)
BLOCK_SIZE_CODES = {
    0b0001: 192, 0b0010: 576, 0b0011: 1152, 0b0100: 2304, 0b0101: 4608,
    0b1000: 256, 0b1001: 512, 0b1010: 1024, 0b1011: 2048, 0b1100: 4096,
    0b1101: 8192, 0b1110: 16384, 0b1111: 32768,
}
BLOCK_SIZE_TO_CODE = {v: k for k, v in BLOCK_SIZE_CODES.items()}

# 4-bit sample rate code -> Hz
SAMPLE_RATE_CODES = {
    0b0001: 88200, 0b0010: 176400, 0b0011: 192000, 0b0100: 8000,
    0b0101: 16000, 0b0110: 22050, 0b0111: 24000, 0b1000: 32000,
    0b1001: 44100, 0b1010: 48000, 0b1011: 96000,
}
SAMPLE_RATE_TO_CODE = {v: k for k, v in SAMPLE_RATE_CODES.items()}

# 3-bit bits-per-sample code -> bits (0b000 = streaminfo, 0b011 invalid)
BPS_CODES = {0b001: 8, 0b010: 12, 0b100: 16, 0b101: 20, 0b110: 24, 0b111: 32}
BPS_TO_CODE = {v: k for k, v in BPS_CODES.items()}

MAX_FRAME_NUMBER = (1 << 36) - 1  # reference: src/stream.rs:1223


class ChannelAssignment:
    """4-bit channel assignment code (reference: src/stream.rs:810-1010).

    Codes 0-7 are 1-8 independent channels; 8/9/10 are the stereo
    decorrelation modes.  The side channel (bps+1 bits) is channel 1 for
    LEFT_SIDE and MID_SIDE, channel 0 for SIDE_RIGHT.
    """

    LEFT_SIDE = 0b1000
    SIDE_RIGHT = 0b1001
    MID_SIDE = 0b1010

    @staticmethod
    def independent(channels: int) -> int:
        if not 1 <= channels <= 8:
            raise InvalidChannels(f"channel count {channels}")
        return channels - 1

    @staticmethod
    def count(code: int) -> int:
        if code <= 0b0111:
            return code + 1
        if code <= 0b1010:
            return 2
        raise InvalidChannels(f"channel assignment code {code:#06b}")

    @staticmethod
    def is_correlated(code: int) -> bool:
        return 0b1000 <= code <= 0b1010

    @staticmethod
    def side_channel(code: int) -> Optional[int]:
        """Index of the bps+1-bit side channel for this assignment."""
        if code in (ChannelAssignment.LEFT_SIDE, ChannelAssignment.MID_SIDE):
            return 1
        if code == ChannelAssignment.SIDE_RIGHT:
            return 0
        return None


def encode_frame_number(w: BitWriter, num: int) -> None:
    """UTF-8-style frame/sample number varint (reference:
    src/stream.rs:1266-1326)."""
    if num < 0 or num > MAX_FRAME_NUMBER:
        raise InvalidFrameNumber(str(num))
    if num < 0x80:
        w.write(num, 8)
        return
    for prefix_bytes, top_bits in ((2, 5), (3, 4), (4, 3), (5, 2), (6, 1), (7, 0)):
        payload_bits = top_bits + 6 * (prefix_bytes - 1)
        if num < (1 << payload_bits):
            lead = (0xFF >> (8 - prefix_bytes)) << (8 - prefix_bytes)
            w.write(lead | ((num >> (6 * (prefix_bytes - 1))) & ((1 << top_bits) - 1)), 8)
            for i in range(prefix_bytes - 2, -1, -1):
                w.write(0b10 << 6 | ((num >> (6 * i)) & 0x3F), 8)
            return
    raise InvalidFrameNumber(str(num))


def read_frame_number(r: BitReader) -> int:
    """Parse the UTF-8-style varint (reference: src/stream.rs:1246-1264)."""
    # count leading one bits before a zero
    lead_ones = 0
    while r.read_bit():
        lead_ones += 1
        if lead_ones > 7:
            raise InvalidFrameNumber("prefix too long")
    if lead_ones == 0:
        return r.read(7)
    if lead_ones == 1:
        raise InvalidFrameNumber("continuation byte as prefix")
    num = r.read(7 - lead_ones)
    for _ in range(lead_ones - 1):
        if r.read(2) != 0b10:
            raise InvalidFrameNumber("bad continuation byte")
        num = (num << 6) | r.read(6)
    return num


def increment_frame_number(num: int) -> int:
    """reference: src/stream.rs:1230-1237 (try_increment)."""
    if num >= MAX_FRAME_NUMBER:
        raise ExcessiveFrameNumber(str(num))
    return num + 1


@dataclass
class FrameHeader:
    """Parsed FLAC frame header (reference: src/stream.rs:131-145)."""

    blocking_strategy: bool
    block_size: int          # in samples
    sample_rate: int         # in Hz
    channel_assignment: int  # 4-bit code
    bits_per_sample: int
    frame_number: int

    @property
    def channel_count(self) -> int:
        return ChannelAssignment.count(self.channel_assignment)

    # -- parse --------------------------------------------------------------

    @classmethod
    def read(cls, r: BitReader, streaminfo=None) -> "FrameHeader":
        """Parse a frame header, CRC-8-check it, and (non-subset) validate
        against STREAMINFO (reference: src/stream.rs:151-165, 279-313).

        The reader must be byte-aligned at the header's first byte.
        """
        start = r.abs_byte_pos
        hdr = cls._parse_fields(
            r,
            None if streaminfo is None else streaminfo.sample_rate,
            None if streaminfo is None else streaminfo.bits_per_sample,
        )
        crc_start = r.abs_byte_pos
        expected = r.read(8)
        actual = crcmod.crc8(r.buffer_slice(start, crc_start))
        if actual != expected:
            raise Crc8Mismatch(f"header crc {actual:#x} != {expected:#x}")
        if streaminfo is not None:
            if hdr.block_size > streaminfo.maximum_block_size:
                raise BlockSizeMismatch()
            if hdr.sample_rate != streaminfo.sample_rate:
                raise SampleRateMismatch()
            if hdr.channel_count != streaminfo.channels:
                raise ChannelsMismatch()
            if hdr.bits_per_sample != streaminfo.bits_per_sample:
                raise BitsPerSampleMismatch()
        return hdr

    @classmethod
    def _parse_fields(cls, r: BitReader, non_subset_rate, non_subset_bps):
        if r.read(15) != SYNC_CODE:
            raise InvalidSyncCode()
        blocking_strategy = r.read_bit()
        bs_code = r.read(4)
        sr_code = r.read(4)
        ca_code = r.read(4)
        bps_code = r.read(3)
        r.skip(1)  # pad
        frame_number = read_frame_number(r)

        # block size
        if bs_code == 0:
            raise InvalidBlockSize("reserved code 0b0000")
        elif bs_code == 0b0110:
            block_size = r.read(8) + 1
        elif bs_code == 0b0111:
            block_size = r.read(16) + 1
        else:
            block_size = BLOCK_SIZE_CODES[bs_code]

        # sample rate
        if sr_code == 0b0000:
            if non_subset_rate is None:
                raise InvalidSampleRate("streaminfo rate in subset stream")
            sample_rate = non_subset_rate
        elif sr_code == 0b1100:
            sample_rate = r.read(8) * 1000
        elif sr_code == 0b1101:
            sample_rate = r.read(16)
        elif sr_code == 0b1110:
            sample_rate = r.read(16) * 10
        elif sr_code == 0b1111:
            raise InvalidSampleRate("invalid code 0b1111")
        else:
            sample_rate = SAMPLE_RATE_CODES[sr_code]

        if ca_code > 0b1010:
            raise InvalidChannels(f"code {ca_code:#06b}")

        # bits per sample
        if bps_code == 0b000:
            if non_subset_bps is None:
                raise InvalidBitsPerSample("streaminfo bps in subset stream")
            bits_per_sample = non_subset_bps
        elif bps_code == 0b011:
            raise InvalidBitsPerSample("reserved code 0b011")
        else:
            bits_per_sample = BPS_CODES[bps_code]

        return cls(
            blocking_strategy=blocking_strategy,
            block_size=block_size,
            sample_rate=sample_rate,
            channel_assignment=ca_code,
            bits_per_sample=bits_per_sample,
            frame_number=frame_number,
        )

    # -- build --------------------------------------------------------------

    def write(self, out: BitWriter) -> None:
        """Serialize the header + CRC-8 into ``out`` (must be byte-aligned;
        reference: src/stream.rs:185-212, 242-276)."""
        w = BitWriter()
        w.write(SYNC_CODE, 15)
        w.write_bit(self.blocking_strategy)

        # block size code selection (reference: src/stream.rs:666-695)
        bs_code = BLOCK_SIZE_TO_CODE.get(self.block_size)
        if bs_code is not None:
            bs_extra = None
        elif self.block_size <= 0:
            raise InvalidBlockSize(str(self.block_size))
        elif self.block_size <= 256:
            bs_code, bs_extra = 0b0110, (self.block_size - 1, 8)
        elif self.block_size <= 65535:  # u16-bounded like the reference
            bs_code, bs_extra = 0b0111, (self.block_size - 1, 16)
        else:
            raise InvalidBlockSize(str(self.block_size))
        w.write(bs_code, 4)

        # sample rate code selection (reference: src/stream.rs:779-802)
        rate = self.sample_rate
        sr_code = SAMPLE_RATE_TO_CODE.get(rate)
        sr_extra = None
        if sr_code is None:
            if rate % 1000 == 0 and rate // 1000 < 255:
                sr_code, sr_extra = 0b1100, (rate // 1000, 8)
            elif rate % 10 == 0 and rate // 10 < 65535:
                sr_code, sr_extra = 0b1110, (rate // 10, 16)
            elif rate < 65535:
                sr_code, sr_extra = 0b1101, (rate, 16)
            elif rate < (1 << 20):
                sr_code = 0b0000  # streaminfo escape
            else:
                raise InvalidSampleRate(str(rate))
        w.write(sr_code, 4)

        w.write(self.channel_assignment, 4)

        bps_code = BPS_TO_CODE.get(self.bits_per_sample, 0b000)
        w.write(bps_code, 3)
        w.write(0, 1)  # pad
        encode_frame_number(w, self.frame_number)
        if bs_extra is not None:
            w.write(bs_extra[0], bs_extra[1])
        if sr_extra is not None:
            w.write(sr_extra[0], sr_extra[1])
        w.byte_align()
        data = w.getvalue()
        out.write_bytes(data)
        out.write(crcmod.crc8(data), 8)
