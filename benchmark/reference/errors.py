# Frozen copy of flac_codec_tpu_torch/errors.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Error taxonomy for the TPU-native FLAC framework.

Mirrors the variant set of the reference implementation's unified error enum
(reference: src/lib.rs:56-311) as a Python exception hierarchy.  Every
malformed-stream condition the reference distinguishes gets its own class so
callers (and tests) can match on precise failure modes.
"""

from __future__ import annotations


class FlacError(Exception):
    """Base class for all FLAC codec errors (reference: src/lib.rs:59)."""


class IoError(FlacError):
    """Wrapped I/O error (reference: src/lib.rs Io variant)."""


# ---------------------------------------------------------------------------
# Stream-level errors
# ---------------------------------------------------------------------------

class MissingFlacTag(FlacError):
    """Stream does not begin with the b"fLaC" tag."""


class InvalidSyncCode(FlacError):
    """Frame header does not begin with the 15-bit sync code."""


class Crc8Mismatch(FlacError):
    """Frame header CRC-8 check failed."""


class Crc16Mismatch(FlacError):
    """Whole-frame CRC-16 check failed."""


class Md5Mismatch(FlacError):
    """Decoded stream MD5 differs from STREAMINFO MD5."""


class InvalidBlockSize(FlacError):
    """Block size code or value is invalid (0, or reserved code)."""


class BlockSizeMismatch(FlacError):
    """Frame block size exceeds STREAMINFO maximum block size."""


class InvalidSampleRate(FlacError):
    """Sample rate code or value is invalid."""


class SampleRateMismatch(FlacError):
    """Frame sample rate disagrees with STREAMINFO."""


class InvalidChannels(FlacError):
    """Channel count/assignment code is invalid."""


class ChannelsMismatch(FlacError):
    """Frame channel count disagrees with STREAMINFO."""


class InvalidBitsPerSample(FlacError):
    """Bits-per-sample code is invalid/reserved."""


class BitsPerSampleMismatch(FlacError):
    """Frame bits-per-sample disagrees with STREAMINFO."""


class InvalidFrameNumber(FlacError):
    """Frame number varint is malformed or exceeds 2**36 - 1."""


class ExcessiveFrameNumber(FlacError):
    """Frame number cannot be incremented past its maximum."""


class InvalidSubframeHeader(FlacError):
    """Subframe header pad bit set or type code reserved."""


class InvalidFixedOrder(FlacError):
    """FIXED subframe order outside 0-4."""


class InvalidLpcOrder(FlacError):
    """LPC subframe order outside 1-32 or exceeding block size."""


class InvalidQlpPrecision(FlacError):
    """QLP precision code 0b1111 (invalid) or zero."""


class NegativeLpcShift(FlacError):
    """LPC shift is negative on decode (invalid per RFC 9639)."""


class InvalidPartitionOrder(FlacError):
    """Residual partition count does not divide the block size."""


class InvalidCodingMethod(FlacError):
    """Residual coding method code is reserved (0b10 / 0b11)."""


class ShortBlock(FlacError):
    """Block of <= 14 samples encountered before the final frame
    (reference: src/decode.rs:1405-1410)."""


class NotSeekable(FlacError):
    """Seek requested on a reader constructed without seek support."""


class InvalidSeek(FlacError):
    """Seek target outside the stream bounds."""


class EndOfStream(FlacError):
    """Unexpected end of stream mid-structure."""


# ---------------------------------------------------------------------------
# Metadata errors
# ---------------------------------------------------------------------------

class InvalidMetadata(FlacError):
    """Generic malformed metadata block."""


class MissingStreaminfo(FlacError):
    """First metadata block is not STREAMINFO, or none present."""


class MultipleStreaminfo(FlacError):
    """More than one STREAMINFO block."""


class MultipleSeekTable(FlacError):
    """More than one SEEKTABLE block."""


class MultipleVorbisComment(FlacError):
    """More than one VORBIS_COMMENT block."""


class DuplicateIcon(FlacError):
    """More than one 32x32 PNG icon / general file icon picture block."""


class InvalidBlockType(FlacError):
    """Reserved (7-126) or invalid (127) metadata block type."""


class InvalidBlockLength(FlacError):
    """Metadata block size over/underflows its 24-bit field."""


class InvalidSeekTable(FlacError):
    """Seek points not in ascending sample-offset order."""


class InvalidVorbisComment(FlacError):
    """Malformed vorbis comment (bad UTF-8, missing separator, ...)."""


class InvalidPicture(FlacError):
    """Malformed PICTURE block or unsupported image format."""


class CuesheetError(FlacError):
    """Malformed CUESHEET block or .cue text (reference:
    src/metadata/mod.rs:3742-3826 defines 23 variants; we carry the
    variant name in args[0])."""

    def __init__(self, variant: str, msg: str | None = None):
        super().__init__(msg or variant)
        self.variant = variant


# ---------------------------------------------------------------------------
# Encoder-side errors
# ---------------------------------------------------------------------------

class OptionsError(FlacError):
    """Invalid encoder option (reference: src/encode.rs:1676-1698)."""


class InsufficientLpcSamples(FlacError):
    """Not enough samples in channel to compute LPC parameters
    (reference: src/encode.rs:3300-3303)."""


class ZeroLpCoefficients(FlacError):
    """All LP coefficients are zero; LPC subframe impossible
    (reference: src/encode.rs:3357)."""


class LpNegativeShiftError(FlacError):
    """Quantization shift below -16 (reference: src/encode.rs:3398)."""


class NoBestLpcOrder(FlacError):
    """No LPC order produced a finite expected-bits estimate."""


class ResidualOverflow(FlacError):
    """Residual does not fit in i32 (reference: src/encode.rs:3186-3195)."""


class SamplesNotDivisibleByChannels(FlacError):
    """Interleaved sample count not a multiple of the channel count
    (reference: src/lib.rs:180-192)."""


class ExcessiveTotalSamples(FlacError):
    """Total samples exceed the 36-bit STREAMINFO field."""


class TotalSamplesMismatch(FlacError):
    """Finalized sample count differs from the declared total."""


class ExcessiveWastedBits(FlacError):
    """Wasted bits >= subframe bits-per-sample (reference: decode.rs
    ExcessiveWastedBits)."""


# ---------------------------------------------------------------------------
# Precise reference variant names (reference: src/lib.rs:59-311) layered on
# the broader classes above, so callers can match either granularity.
# ---------------------------------------------------------------------------

class AccumulatorOverflow(FlacError):
    """Predictor accumulator overflow (reference AccumulatorOverflow)."""


class ChannelCountMismatch(ChannelsMismatch):
    """Written channel count differs from the stream's channel count."""


class ChannelLengthMismatch(ChannelsMismatch):
    """Per-channel buffers have differing lengths."""


class ExcessiveBlockSize(InvalidBlockSize):
    """Block size exceeds the format maximum (65535)."""


class ExcessiveBps(InvalidBitsPerSample):
    """Bits-per-sample exceeds the format maximum (32)."""


class ExcessiveChannels(InvalidChannels):
    """More than 8 channels."""


class ExcessivePictureSize(InvalidPicture):
    """PICTURE block field exceeds its 32-bit size limit."""


class ExcessiveStringLength(InvalidVorbisComment):
    """Vorbis comment string exceeds its 32-bit length prefix."""


class ExcessiveVorbisEntries(InvalidVorbisComment):
    """More Vorbis comment entries than the 32-bit count field allows."""


class InsufficientApplicationBlock(InvalidMetadata):
    """APPLICATION block shorter than its 4-byte id."""


class InvalidMetadataBlock(InvalidMetadata):
    """Invalid metadata block type 127 (reference: mod.rs:305-317)."""


class InvalidMetadataBlockSize(InvalidMetadata):
    """Metadata block size exceeds / disagrees with its 24-bit header."""


class ReservedMetadataBlock(InvalidMetadata):
    """Reserved metadata block type 7-126."""


class InvalidPictureType(InvalidPicture):
    """PICTURE type code outside the 21 defined types."""


class InvalidSeekTablePoint(InvalidSeekTable):
    """SEEKTABLE points not in ascending sample-offset order."""


class InvalidSeekTableSize(InvalidSeekTable):
    """SEEKTABLE size not a multiple of 18 bytes."""


class InvalidSubframeHeaderType(InvalidSubframeHeader):
    """Subframe type code is reserved."""


class InvalidTotalBytes(FlacError):
    """Declared byte total disagrees with the written amount."""


class InvalidTotalSamples(ExcessiveTotalSamples):
    """Declared total samples outside the 36-bit field."""


class MissingResiduals(FlacError):
    """Predicted subframe shorter than its predictor order."""


class MultiplePngIcon(DuplicateIcon):
    """More than one 32x32 PNG icon PICTURE block."""


class MultipleGeneralIcon(DuplicateIcon):
    """More than one general file-icon PICTURE block."""


class NoSamples(FlacError):
    """Encoder asked to finalize a stream with no samples."""


class NonSubsetSampleRate(InvalidSampleRate):
    """Sample rate not representable in a subset stream header."""


class NonSubsetBitsPerSample(InvalidBitsPerSample):
    """Bits-per-sample not representable in a subset stream header."""


class SampleCountMismatch(FlacError):
    """Written sample count differs from the declared total."""


class TooManySamples(ExcessiveTotalSamples):
    """More than 2**36 total samples written."""
