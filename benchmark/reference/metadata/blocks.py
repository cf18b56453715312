# Frozen copy of flac_codec_tpu_torch/metadata/blocks.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Metadata block types (reference: src/metadata/mod.rs).

Each block knows its 7-bit type code and how to (de)serialize its body.
Serialization is byte-exact with the reference at matched contents — the
byte-for-byte metadata roundtrip test in the reference's tests/metadata.rs
is the parity bar.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..bitio import BitReader, BitWriter
from ..errors import (
    InvalidBlockLength,
    InvalidMetadata,
    InvalidPicture,
    InvalidSeekTable,
    InvalidVorbisComment,
)

STREAMINFO = 0
PADDING = 1
APPLICATION = 2
SEEKTABLE = 3
VORBIS_COMMENT = 4
CUESHEET = 5
PICTURE = 6

MAX_BLOCK_SIZE = (1 << 24) - 1

PLACEHOLDER_OFFSET = (1 << 64) - 1  # seekpoint placeholder (reference:
# src/metadata/mod.rs SeekPoint; u64::MAX sample offset)


@dataclass
class Streaminfo:
    """STREAMINFO — 34-byte fixed block (reference:
    src/metadata/mod.rs:1573-1760)."""

    minimum_block_size: int = 0
    maximum_block_size: int = 0
    minimum_frame_size: Optional[int] = None   # None = unknown (0 on disk)
    maximum_frame_size: Optional[int] = None
    sample_rate: int = 44100                   # 20 bits
    channels: int = 2                          # 3 bits, stored -1
    bits_per_sample: int = 16                  # 5 bits, stored -1
    total_samples: Optional[int] = None        # 36 bits, 0 = unknown
    md5: Optional[bytes] = None                # 16 bytes, all-0 = unknown

    TYPE = STREAMINFO
    MAX_FRAME_SIZE = MAX_BLOCK_SIZE
    MAX_SAMPLE_RATE = (1 << 20) - 1
    MAX_CHANNELS = 8
    MAX_TOTAL_SAMPLES = (1 << 36) - 1

    def to_bytes(self) -> bytes:
        w = BitWriter()
        w.write(self.minimum_block_size, 16)
        w.write(self.maximum_block_size, 16)
        w.write(self.minimum_frame_size or 0, 24)
        w.write(self.maximum_frame_size or 0, 24)
        w.write(self.sample_rate, 20)
        w.write(self.channels - 1, 3)
        w.write(self.bits_per_sample - 1, 5)
        w.write(self.total_samples or 0, 36)
        w.byte_align()
        return w.getvalue() + (self.md5 or b"\x00" * 16)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Streaminfo":
        if len(data) != 34:
            raise InvalidBlockLength(f"STREAMINFO length {len(data)}")
        r = BitReader(data)
        min_bs = r.read(16)
        max_bs = r.read(16)
        min_fs = r.read(24) or None
        max_fs = r.read(24) or None
        rate = r.read(20)
        channels = r.read(3) + 1
        bps = r.read(5) + 1
        total = r.read(36) or None
        md5 = data[18:34]
        return cls(min_bs, max_bs, min_fs, max_fs, rate, channels, bps, total,
                   None if md5 == b"\x00" * 16 else md5)

    # Metadata trait surface (reference: src/metadata/mod.rs:48-105)
    def decoded_len(self) -> Optional[int]:
        if self.total_samples is None:
            return None
        return self.total_samples * self.channels * ((self.bits_per_sample + 7) // 8)

    def duration(self) -> Optional[float]:
        if self.total_samples is None or not self.sample_rate:
            return None
        return self.total_samples / self.sample_rate


@dataclass
class Padding:
    """PADDING — size-only zero block (reference: src/metadata/mod.rs:1762)."""

    size: int = 0
    TYPE = PADDING

    def to_bytes(self) -> bytes:
        return b"\x00" * self.size

    @classmethod
    def from_bytes(cls, data: bytes) -> "Padding":
        return cls(len(data))


@dataclass
class Application:
    """APPLICATION — 32-bit id + data (reference: src/metadata/mod.rs:1834)."""

    id: bytes = b"\x00\x00\x00\x00"
    data: bytes = b""
    TYPE = APPLICATION

    RIFF = b"riff"
    AIFF = b"aiff"

    def to_bytes(self) -> bytes:
        if len(self.id) != 4:
            raise InvalidMetadata("application id must be 4 bytes")
        return self.id + self.data

    @classmethod
    def from_bytes(cls, data: bytes) -> "Application":
        if len(data) < 4:
            raise InvalidBlockLength("APPLICATION too short")
        return cls(data[:4], data[4:])


@dataclass
class SeekPoint:
    sample_offset: int
    byte_offset: int
    frame_samples: int

    @property
    def is_placeholder(self) -> bool:
        return self.sample_offset == PLACEHOLDER_OFFSET

    @classmethod
    def placeholder(cls) -> "SeekPoint":
        return cls(PLACEHOLDER_OFFSET, 0, 0)


@dataclass
class SeekTable:
    """SEEKTABLE — 18-byte points in ascending order (reference:
    src/metadata/mod.rs:1892-2139)."""

    points: List[SeekPoint] = field(default_factory=list)
    TYPE = SEEKTABLE
    # as many 18-byte points as fit a 24-bit block length
    # (reference: src/metadata/mod.rs:1989)
    MAX_POINTS = (1 << 24) // 18

    def to_bytes(self) -> bytes:
        self._validate()
        return b"".join(
            struct.pack(">QQH", p.sample_offset, p.byte_offset, p.frame_samples)
            for p in self.points)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SeekTable":
        if len(data) % 18:
            raise InvalidBlockLength(f"SEEKTABLE length {len(data)}")
        points = [SeekPoint(*struct.unpack(">QQH", data[i:i + 18]))
                  for i in range(0, len(data), 18)]
        table = cls(points)
        table._validate()
        return table

    def _validate(self) -> None:
        if len(self.points) > self.MAX_POINTS:
            raise InvalidSeekTable(
                f"{len(self.points)} seek points exceed MAX_POINTS")
        # ascending sample offsets among non-placeholder points
        prev = -1
        for p in self.points:
            if p.is_placeholder:
                continue
            if p.sample_offset <= prev:
                raise InvalidSeekTable("seek points not in ascending order")
            prev = p.sample_offset


class VorbisComment:
    """VORBIS_COMMENT — vendor + KEY=value fields, case-insensitive keys
    (reference: src/metadata/mod.rs:2141-2601)."""

    TYPE = VORBIS_COMMENT

    def __init__(self, vendor: str = "", fields: Optional[List[str]] = None):
        self.vendor = vendor
        self.fields: List[str] = list(fields or [])

    def __eq__(self, other):
        return (isinstance(other, VorbisComment)
                and self.vendor == other.vendor and self.fields == other.fields)

    def __repr__(self):
        return f"VorbisComment(vendor={self.vendor!r}, fields={self.fields!r})"

    def to_bytes(self) -> bytes:
        out = bytearray()
        v = self.vendor.encode("utf-8")
        out += struct.pack("<I", len(v)) + v
        out += struct.pack("<I", len(self.fields))
        for f in self.fields:
            b = f.encode("utf-8")
            out += struct.pack("<I", len(b)) + b
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "VorbisComment":
        try:
            pos = 0
            (vlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if pos + vlen > len(data):
                raise InvalidVorbisComment("vendor string overruns block")
            vendor = data[pos:pos + vlen].decode("utf-8")
            pos += vlen
            (count,) = struct.unpack_from("<I", data, pos)
            pos += 4
            fields = []
            for _ in range(count):
                (flen,) = struct.unpack_from("<I", data, pos)
                pos += 4
                if pos + flen > len(data):
                    raise InvalidVorbisComment("field string overruns block")
                fields.append(data[pos:pos + flen].decode("utf-8"))
                pos += flen
            return cls(vendor, fields)
        except (struct.error, UnicodeDecodeError) as e:
            raise InvalidVorbisComment(str(e))

    # -- field access (case-insensitive keys) -------------------------------

    def get(self, key: str) -> Optional[str]:
        key = key.upper()
        for f in self.fields:
            k, _, v = f.partition("=")
            if k.upper() == key:
                return v
        return None

    def all(self, key: str) -> List[str]:
        key = key.upper()
        return [f.partition("=")[2] for f in self.fields
                if f.partition("=")[0].upper() == key]

    def set(self, key: str, value: str) -> None:
        """Replace all instances of ``key`` with a single field."""
        self.remove(key)
        self.fields.append(f"{key}={value}")

    replace = set

    def insert(self, key: str, value: str) -> None:
        """Append without removing existing instances."""
        self.fields.append(f"{key}={value}")

    def remove(self, key: str) -> None:
        key = key.upper()
        self.fields = [f for f in self.fields
                       if f.partition("=")[0].upper() != key]

    def replace_with(self, key: str, fn) -> None:
        """Rewrite every value of ``key`` in place with ``fn(value)``,
        preserving field order and the original key spelling
        (reference: src/metadata/mod.rs:2474-2488)."""
        if "=" in key:
            raise ValueError("field must not contain '='")
        for i, f in enumerate(self.fields):
            k, sep, v = f.partition("=")
            if sep and k.upper() == key.upper():
                self.fields[i] = f"{k}={fn(v)}"


# Standard field name constants (reference: src/metadata/mod.rs:2547-2601).
class fields:
    TITLE = "TITLE"
    VERSION = "VERSION"
    ALBUM = "ALBUM"
    TRACKNUMBER = "TRACKNUMBER"
    ARTIST = "ARTIST"
    PERFORMER = "PERFORMER"
    COPYRIGHT = "COPYRIGHT"
    LICENSE = "LICENSE"
    ORGANIZATION = "ORGANIZATION"
    DESCRIPTION = "DESCRIPTION"
    GENRE = "GENRE"
    DATE = "DATE"
    LOCATION = "LOCATION"
    CONTACT = "CONTACT"
    ISRC = "ISRC"
    REPLAYGAIN_TRACK_GAIN = "REPLAYGAIN_TRACK_GAIN"
    REPLAYGAIN_TRACK_PEAK = "REPLAYGAIN_TRACK_PEAK"
    REPLAYGAIN_ALBUM_GAIN = "REPLAYGAIN_ALBUM_GAIN"
    REPLAYGAIN_ALBUM_PEAK = "REPLAYGAIN_ALBUM_PEAK"
    WAVEFORMATEXTENSIBLE_CHANNEL_MASK = "WAVEFORMATEXTENSIBLE_CHANNEL_MASK"


@dataclass
class Picture:
    """PICTURE block (reference: src/metadata/mod.rs:3828-4345)."""

    picture_type: int = 0      # 0-20 (3 = front cover)
    mime_type: str = ""
    description: str = ""
    width: int = 0
    height: int = 0
    color_depth: int = 0
    colors_used: int = 0
    data: bytes = b""
    TYPE = PICTURE

    # picture type codes — all 21 defined values
    # (reference: src/metadata/mod.rs:4035-4078)
    OTHER = 0
    PNG_ICON = 1
    GENERAL_ICON = 2
    FRONT_COVER = 3
    BACK_COVER = 4
    LINER_NOTES = 5
    MEDIA_LABEL = 6
    LEAD_ARTIST = 7
    ARTIST = 8
    CONDUCTOR = 9
    BAND = 10
    COMPOSER = 11
    LYRICIST = 12
    RECORDING_LOCATION = 13
    DURING_RECORDING = 14
    DURING_PERFORMANCE = 15
    SCREEN_CAPTURE = 16
    FISH = 17
    ILLUSTRATION = 18
    BAND_LOGO = 19
    PUBLISHER_LOGO = 20

    # display strings (reference: src/metadata/mod.rs:4080-4106)
    TYPE_NAMES = (
        "Other", "32×32 PNG Icon", "General File Icon",
        "Cover (front)", "Cover (back)", "Liner Notes", "Media Label",
        "Lead Artist", "Artist", "Conductor", "Band or Orchestra",
        "Composer", "lyricist or Text Writer", "Recording Location",
        "During Recording", "During Performance",
        "Movie or Video Screen Capture", "A Bright Colored Fish",
        "Illustration", "Band or Artist Logotype",
        "Publisher or Studio Logotype")

    def type_name(self) -> str:
        return (self.TYPE_NAMES[self.picture_type]
                if 0 <= self.picture_type < len(self.TYPE_NAMES)
                else f"invalid ({self.picture_type})")

    def __post_init__(self):
        from ..errors import InvalidPictureType

        if not 0 <= self.picture_type <= 20:
            # reference parse rejects codes past PublisherLogo
            # (src/metadata/mod.rs:4108-4137)
            raise InvalidPictureType(
                f"picture type {self.picture_type} outside 0-20")

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += struct.pack(">I", self.picture_type)
        m = self.mime_type.encode("ascii")
        out += struct.pack(">I", len(m)) + m
        d = self.description.encode("utf-8")
        out += struct.pack(">I", len(d)) + d
        out += struct.pack(">IIII", self.width, self.height,
                           self.color_depth, self.colors_used)
        out += struct.pack(">I", len(self.data)) + self.data
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Picture":
        try:
            pos = 0
            (ptype,) = struct.unpack_from(">I", data, pos); pos += 4
            (mlen,) = struct.unpack_from(">I", data, pos); pos += 4
            mime = data[pos:pos + mlen].decode("ascii"); pos += mlen
            (dlen,) = struct.unpack_from(">I", data, pos); pos += 4
            desc = data[pos:pos + dlen].decode("utf-8"); pos += dlen
            width, height, depth, colors = struct.unpack_from(">IIII", data, pos)
            pos += 16
            (plen,) = struct.unpack_from(">I", data, pos); pos += 4
            payload = data[pos:pos + plen]
            if len(payload) != plen:
                raise InvalidPicture("truncated picture data")
            return cls(ptype, mime, desc, width, height, depth, colors, payload)
        except (struct.error, UnicodeDecodeError) as e:
            raise InvalidPicture(str(e))

    @classmethod
    def new(cls, picture_type: int, description: str, data: bytes) -> "Picture":
        """Build a picture block, sniffing metrics from the image data
        (reference: src/metadata/mod.rs:4168-4225 + mini-parsers)."""
        from .picture import sniff_metrics

        mime, width, height, depth, colors = sniff_metrics(data)
        return cls(picture_type, mime, description, width, height, depth,
                   colors, data)

    @classmethod
    def open(cls, path: str, picture_type: int = 3, description: str = "") -> "Picture":
        with open(path, "rb") as fp:
            return cls.new(picture_type, description, fp.read())


def _validate_isrc(isrc: bytes) -> None:
    """All-zero = absent; otherwise 2 alpha + 3 alnum + 7 digits
    (reference: src/metadata/cuesheet.rs:259-318)."""
    from ..errors import CuesheetError

    if not any(isrc):
        return
    try:
        s = isrc.decode("ascii")
    except UnicodeDecodeError:
        raise CuesheetError("InvalidISRC")
    if not (len(s) == 12 and s[:2].isalpha() and s[2:5].isalnum()
            and s[5:].isdigit() and s.isascii()):
        raise CuesheetError("InvalidISRC")


@dataclass
class Cuesheet:
    """CUESHEET block; binary layout per RFC 9639 §8.7 (reference:
    src/metadata/mod.rs:2771-3533).  Text .cue parse/render lives in
    metadata/cuesheet.py."""

    catalog: bytes = b"\x00" * 128
    lead_in: int = 0
    is_cdda: bool = False
    tracks: List["CuesheetTrack"] = field(default_factory=list)
    TYPE = CUESHEET

    def to_bytes(self) -> bytes:
        out = bytearray()
        cat = self.catalog.ljust(128, b"\x00")[:128]
        out += cat
        out += struct.pack(">Q", self.lead_in)
        out += bytes([0x80 if self.is_cdda else 0x00]) + b"\x00" * 258
        out += bytes([len(self.tracks)])
        for t in self.tracks:
            out += t.to_bytes()
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Cuesheet":
        """Parse + validate per the reference's typestate rules
        (src/metadata/mod.rs:3416-3475, cuesheet.rs:1-833): ordered
        tracks/indices (``Contiguous``), CDDA 588-multiple offsets,
        exactly-13-digit CDDA catalog, ISRC charset, track-count caps,
        mandatory INDEX 01, index-free lead-out as the final track."""
        from ..errors import CuesheetError, InvalidMetadata

        try:
            pos = 0
            catalog = data[pos:pos + 128]; pos += 128
            (lead_in,) = struct.unpack_from(">Q", data, pos); pos += 8
            is_cdda = bool(data[pos] & 0x80); pos += 1 + 258
            ntracks = data[pos]; pos += 1
            tracks = []
            for _ in range(ntracks):
                t, pos = CuesheetTrack.parse(data, pos)
                tracks.append(t)
        except (struct.error, IndexError) as e:
            raise InvalidMetadata(f"truncated CUESHEET block: {e}")

        # catalog number (cuesheet::Digit; CDDA needs exactly 13 digits)
        trimmed = catalog.rstrip(b"\x00")
        if trimmed and not trimmed.isdigit():
            raise CuesheetError("InvalidCatalogNumber")
        if is_cdda and trimmed and len(trimmed) != 13:
            raise CuesheetError("InvalidCatalogNumber")

        # track-count envelope (reference: mod.rs:3446-3451)
        if ntracks == 0:
            raise CuesheetError("NoTracks")
        if is_cdda and ntracks - 1 > 99:
            raise CuesheetError("NoTracks")
        ordinary, lead_out = tracks[:-1], tracks[-1]

        max_indices = 100 if is_cdda else 256
        for t in ordinary:
            if t.number == 0:
                raise CuesheetError("InvalidIndexPoint")
            _validate_isrc(t.isrc)
            if is_cdda and t.offset % 588:
                raise CuesheetError("InvalidCDDAOffset")
            if not t.indices:
                raise CuesheetError("NoIndexPoints")
            if len(t.indices) > max_indices:
                raise CuesheetError("IndexPointsOutOfSequence")
            # Contiguous<Index>: first index at relative offset 0 with
            # number 0 or 1; then strictly ascending offsets, +1 numbers;
            # IndexVec: a 00 pre-gap must be followed by INDEX 01
            off0, num0 = t.indices[0]
            if off0 != 0 or num0 not in (0, 1):
                raise CuesheetError("IndexPointsOutOfSequence")
            if num0 == 0 and (len(t.indices) < 2 or t.indices[1][1] != 1):
                raise CuesheetError("IndexPointsOutOfSequence")
            for (po, pn), (o, n) in zip(t.indices, t.indices[1:]):
                if not (o > po and n == pn + 1):
                    raise CuesheetError("IndexPointsOutOfSequence")
            if is_cdda and any(o % 588 for o, _ in t.indices):
                raise CuesheetError("InvalidCDDAOffset")

        # Contiguous<Track>: first track at offset 0 numbered 1; numbers
        # ascend by one; offsets pass the previous track's last index
        if ordinary:
            if ordinary[0].offset != 0 or ordinary[0].number != 1:
                raise CuesheetError("TracksOutOfSequence")
            for prev, t in zip(ordinary, ordinary[1:]):
                if t.number != prev.number + 1:
                    raise CuesheetError("TracksOutOfSequence")
                if t.offset <= prev.indices[-1][0]:
                    raise CuesheetError("TracksOutOfSequence")

        # lead-out: fixed number, no index points (reference:
        # cuesheet.rs:528-564)
        if lead_out.number != (170 if is_cdda else 255):
            raise CuesheetError("TracksOutOfSequence")
        _validate_isrc(lead_out.isrc)
        if lead_out.indices:
            raise CuesheetError("IndexPointsInLeadout")
        if is_cdda and lead_out.offset % 588:
            raise CuesheetError("InvalidCDDAOffset")

        return cls(catalog, lead_in, is_cdda, tracks)

    def track_sample_ranges(self) -> List[Tuple[int, Optional[int]]]:
        """(start, end) sample ranges per non-lead-out track (reference:
        src/metadata/mod.rs:3383-3388)."""
        ranges = []
        lo = 170 if self.is_cdda else 255  # non-CDDA allows a track 170
        ordinary = [t for t in self.tracks if t.number != lo]
        lead_out = next((t for t in self.tracks if t.number == lo), None)
        for i, t in enumerate(ordinary):
            start = t.offset
            if i + 1 < len(ordinary):
                end = ordinary[i + 1].offset
            elif lead_out is not None:
                end = lead_out.offset
            else:
                end = None
            ranges.append((start, end))
        return ranges

    def track_byte_ranges(self, channel_count: int, bits_per_sample: int
                          ) -> List[Tuple[int, Optional[int]]]:
        """Track ranges in PCM bytes — ``track_sample_ranges`` scaled by
        channels x ceil(bps/8); CD-DA uses (2, 16)
        (reference: src/metadata/mod.rs:3390-3411)."""
        if channel_count <= 0:
            raise ValueError("channel_count must be > 0")
        if bits_per_sample <= 0:
            raise ValueError("bits_per_sample must be > 0")
        mult = channel_count * ((bits_per_sample + 7) // 8)
        return [(s * mult, None if e is None else e * mult)
                for s, e in self.track_sample_ranges()]


@dataclass
class CuesheetTrack:
    offset: int = 0
    number: int = 0
    isrc: bytes = b"\x00" * 12
    is_audio: bool = True
    pre_emphasis: bool = False
    indices: List[Tuple[int, int]] = field(default_factory=list)  # (offset, number)

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += struct.pack(">Q", self.offset)
        out += bytes([self.number])
        out += self.isrc.ljust(12, b"\x00")[:12]
        flags = (0x00 if self.is_audio else 0x80) | (0x40 if self.pre_emphasis else 0x00)
        out += bytes([flags]) + b"\x00" * 13
        out += bytes([len(self.indices)])
        for off, num in self.indices:
            out += struct.pack(">Q", off) + bytes([num]) + b"\x00" * 3
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes, pos: int) -> Tuple["CuesheetTrack", int]:
        (offset,) = struct.unpack_from(">Q", data, pos); pos += 8
        number = data[pos]; pos += 1
        isrc = data[pos:pos + 12]; pos += 12
        flags = data[pos]; pos += 1 + 13
        nidx = data[pos]; pos += 1
        indices = []
        for _ in range(nidx):
            (ioff,) = struct.unpack_from(">Q", data, pos); pos += 8
            inum = data[pos]; pos += 1 + 3
            indices.append((ioff, inum))
        return cls(offset, number, isrc, not (flags & 0x80),
                   bool(flags & 0x40), indices), pos


BLOCK_CLASSES = {
    STREAMINFO: Streaminfo,
    PADDING: Padding,
    APPLICATION: Application,
    SEEKTABLE: SeekTable,
    VORBIS_COMMENT: VorbisComment,
    CUESHEET: Cuesheet,
    PICTURE: Picture,
}
