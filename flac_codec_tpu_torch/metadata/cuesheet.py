"""Cuesheet text (.cue) parsing and rendering (reference:
src/metadata/mod.rs:3241-3297 Cuesheet::parse, :3543-3740 ParsedCuesheet
state machine, :2972-3078 display renderer; cuesheet types in
src/metadata/cuesheet.rs).

The parser enforces the reference's validation rules; each failure raises
:class:`~flac_codec_tpu_torch.errors.CuesheetError` carrying the variant name the
reference would report (the BAD-*.cue fixture corpus pins these).
"""

from __future__ import annotations

import re
import shlex
from typing import List, Optional, Tuple

from ..errors import CuesheetError
from .blocks import Cuesheet, CuesheetTrack

SAMPLES_PER_FRAME = 588  # 44100 / 75
FRAMES_PER_SECOND = 75
LEAD_OUT_CDDA = 170
LEAD_OUT_NON_CDDA = 255

_ISRC_RE = re.compile(r"^[A-Z0-9]{5}[0-9]{7}$")


def _parse_timestamp(text: str) -> int:
    """MM:SS:FF -> sample offset (CDDA: 588 samples per frame)."""
    parts = text.split(":")
    if len(parts) != 3:
        raise CuesheetError("InvalidIndexPoint", f"bad timestamp {text!r}")
    try:
        mm, ss, ff = (int(p) for p in parts)
    except ValueError:
        raise CuesheetError("InvalidIndexPoint", f"bad timestamp {text!r}")
    if mm < 0 or ss < 0 or ff < 0:
        raise CuesheetError("InvalidIndexPoint", f"bad timestamp {text!r}")
    return ((mm * 60 + ss) * FRAMES_PER_SECOND + ff) * SAMPLES_PER_FRAME


def _timestamp(offset: int) -> str:
    total_frames = offset // SAMPLES_PER_FRAME
    mm = (total_frames // FRAMES_PER_SECOND) // 60
    ss = (total_frames // FRAMES_PER_SECOND) % 60
    ff = total_frames % FRAMES_PER_SECOND
    return f"{mm:02}:{ss:02}:{ff:02}"


class _TrackInProgress:
    def __init__(self, number: int):
        self.number = number
        self.isrc: Optional[str] = None
        self.pre_emphasis = False
        self.flags_seen = False
        self.non_audio = False
        self.indices: List[Tuple[int, int]] = []  # (abs offset, number)


def parse_cuesheet(text: str, lead_out_offset: Optional[int] = None) -> Cuesheet:
    """Parse .cue text into a CUESHEET block (reference:
    src/metadata/mod.rs:3543-3740).

    ``lead_out_offset`` supplies the stream length in samples when no
    ``REM FLAC__lead-out`` line is present.
    """
    catalog: Optional[str] = None
    lead_in: Optional[int] = None
    lead_out: Optional[Tuple[int, int]] = None  # (track number, offset)
    tracks: List[_TrackInProgress] = []

    def finish_track():
        # every finished track needs a mandatory INDEX 01 (an optional
        # INDEX 00 pre-gap alone is not enough)
        if tracks and not any(n == 1 for _, n in tracks[-1].indices):
            raise CuesheetError("InvalidTrack",
                                f"track {tracks[-1].number} lacks INDEX 01")

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        try:
            fields = shlex.split(line)
        except ValueError:
            raise CuesheetError("InvalidLine", raw)
        cmd = fields[0].upper()

        if cmd == "REM":
            try:
                if len(fields) >= 3 and fields[1] == "FLAC__lead-in":
                    lead_in = int(fields[2])
                elif len(fields) >= 4 and fields[1] == "FLAC__lead-out":
                    lead_out = (int(fields[2]), int(fields[3]))
            except ValueError:
                raise CuesheetError("InvalidLine", raw)
            continue
        if cmd == "CATALOG":
            if catalog is not None:
                raise CuesheetError("MultipleCatalogNumber", raw)
            if len(fields) < 2:
                raise CuesheetError("CatalogMissingNumber", raw)
            value = fields[1]
            if not (len(value) == 13 and value.isdigit()):
                raise CuesheetError("InvalidCatalogNumber", raw)
            catalog = value
            continue
        if cmd == "FILE":
            finish_track()
            continue
        if cmd == "TRACK":
            finish_track()
            if len(fields) < 3:
                raise CuesheetError("InvalidTrack", raw)
            try:
                number = int(fields[1])
            except ValueError:
                raise CuesheetError("InvalidTrack", raw)
            if number < 1 or number > 99:
                raise CuesheetError("InvalidTrack", raw)
            if tracks and number <= tracks[-1].number:
                raise CuesheetError("TracksOutOfSequence", raw)
            t = _TrackInProgress(number)
            t.non_audio = fields[2].upper() != "AUDIO"
            tracks.append(t)
            continue
        if cmd == "FLAGS":
            if not tracks:
                raise CuesheetError("PrematureFlags", raw)
            t = tracks[-1]
            if t.indices:
                raise CuesheetError("LateFlags", raw)
            if t.flags_seen:
                raise CuesheetError("MultipleFlags", raw)
            t.flags_seen = True
            if "PRE" in (f.upper() for f in fields[1:]):
                t.pre_emphasis = True
            continue
        if cmd == "ISRC":
            if not tracks:
                raise CuesheetError("PrematureISRC", raw)
            t = tracks[-1]
            if t.indices:
                raise CuesheetError("LateISRC", raw)
            if t.isrc is not None:
                raise CuesheetError("MultipleISRC", raw)
            value = fields[1].replace("-", "") if len(fields) >= 2 else ""
            if not _ISRC_RE.match(value):
                raise CuesheetError("InvalidISRC", raw)
            t.isrc = value
            continue
        if cmd == "INDEX":
            if not tracks:
                raise CuesheetError("PrematureIndex", raw)
            t = tracks[-1]
            if len(fields) < 3:
                raise CuesheetError("InvalidIndexPoint", raw)
            try:
                number = int(fields[1])
            except ValueError:
                raise CuesheetError("InvalidIndexPoint", raw)
            if number > 99:
                raise CuesheetError("IndexPointsOutOfSequence", raw)
            offset = _parse_timestamp(fields[2])
            if t.indices:
                if number != t.indices[-1][1] + 1:
                    raise CuesheetError("IndexPointsOutOfSequence", raw)
                if offset <= t.indices[-1][0]:
                    raise CuesheetError("IndexPointsOutOfSequence", raw)
            else:
                if number not in (0, 1):
                    raise CuesheetError("IndexPointsOutOfSequence", raw)
                if len(tracks) == 1:
                    if offset != 0:
                        raise CuesheetError("NonZeroFirstIndex", raw)
                elif tracks[-2].indices and offset <= tracks[-2].indices[-1][0]:
                    # regression vs the previous track's last index point
                    raise CuesheetError("TracksOutOfSequence", raw)
            t.indices.append((offset, number))
            continue
        # TITLE / PERFORMER / SONGWRITER / PREGAP etc. are ignored

    finish_track()
    if not tracks:
        raise CuesheetError("NoTracks")

    out_tracks = []
    for t in tracks:
        # track offset = first index point's offset; index offsets are
        # stored relative to it and must be unsigned (so an INDEX 00
        # pre-gap anchors the track offset)
        base = t.indices[0][0]
        out_tracks.append(CuesheetTrack(
            offset=base,
            number=t.number,
            isrc=(t.isrc or "").encode("ascii").ljust(12, b"\x00"),
            is_audio=not t.non_audio,
            pre_emphasis=t.pre_emphasis,
            indices=[(o - base, n) for o, n in t.indices],
        ))

    # lead-out track; CDDA only when the stream length lands on a CD
    # frame boundary (reference: src/metadata/mod.rs:3266-3292 parses a
    # CDDA cuesheet iff total samples is divisible by 588)
    if lead_out is not None:
        lo_number, lo_offset = lead_out
    elif lead_out_offset is not None:
        lo_number = (LEAD_OUT_CDDA if lead_out_offset % 588 == 0
                     else LEAD_OUT_NON_CDDA)
        lo_offset = lead_out_offset
    else:
        lo_offset = out_tracks[-1].offset
        lo_number = (LEAD_OUT_CDDA if lo_offset % 588 == 0
                     else LEAD_OUT_NON_CDDA)
    out_tracks.append(CuesheetTrack(
        offset=lo_offset, number=lo_number, isrc=b"\x00" * 12,
        is_audio=True, pre_emphasis=False, indices=[]))

    is_cdda = lo_number != LEAD_OUT_NON_CDDA
    if lead_in is None:
        # CD-DA lead-in is typically exactly two seconds
        # (reference: src/metadata/mod.rs:2845 LEAD_IN = 44100 * 2)
        lead_in = 88200 if is_cdda else 0
    return Cuesheet(
        catalog=(catalog or "").encode("ascii").ljust(128, b"\x00"),
        lead_in=lead_in,
        # a 255-numbered lead-out declares a non-CD-DA cuesheet
        # (reference cuesheet::LeadOut semantics)
        is_cdda=lo_number != LEAD_OUT_NON_CDDA,
        tracks=out_tracks,
    )


def render_cuesheet(cs: Cuesheet, filename: str = "CDImage.flac") -> str:
    """Render a CUESHEET block as .cue text (reference display format:
    src/metadata/mod.rs:2972-3078)."""
    lines = [f'FILE "{filename}" FLAC']
    for t in cs.tracks:
        if t.number in (LEAD_OUT_CDDA, LEAD_OUT_NON_CDDA):
            continue
        lines.append(f"  TRACK {t.number} "
                     f"{'AUDIO' if t.is_audio else 'NON_AUDIO'}")
        for off, num in t.indices:
            lines.append(f"    INDEX {num:02} {_timestamp(off + t.offset)}")
    return "\n".join(lines) + "\n"
