# Frozen copy of flac_codec_tpu_torch/encode.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Encode layer: Options, frame encoder core, and writer API surfaces
(reference: src/encode.rs:55-2439).

``FlacByteWriter`` / ``FlacSampleWriter`` / ``FlacChannelWriter`` /
``FlacStreamWriter`` mirror the reference's four writer surfaces; the frame
encoder mirrors its candidate-search structure (fixed-vs-LPC race, fast and
exhaustive stereo correlation, wasted bits, Rice partition search).  On CPU
the candidates are evaluated with numpy; the batched TPU path in
``parallel.batch`` evaluates all candidates for thousands of frames at once.
"""

from __future__ import annotations

import hashlib
import io
from dataclasses import dataclass, field, replace
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

from . import crc as crcmod
from . import metadata as meta
from .bitio import BitRecorder, BitWriter
from .byteorder import bytes_to_samples, deinterleave, samples_to_bytes
from .errors import (
    ExcessiveTotalSamples,
    FlacError,
    InsufficientLpcSamples,
    InvalidChannels,
    NoBestLpcOrder,
    OptionsError,
    ResidualOverflow,
    SamplesNotDivisibleByChannels,
    TotalSamplesMismatch,
    ZeroLpCoefficients,
)
from .format.frame import ChannelAssignment, FrameHeader, increment_frame_number
from .format.subframe import SubframeHeader, write_residuals_verbatim
from .models import fixed as fixedmod
from .models import lpc as lpcmod
from .rice import best_partitions, choose_rice_coding

MAX_SAMPLES = 1 << 36  # reference: src/encode.rs:1880


# ---------------------------------------------------------------------------
# Options (reference: src/encode.rs:1320-1709)
# ---------------------------------------------------------------------------

@dataclass
class Options:
    """Encoder options; defaults mirror the reference's
    (reference: src/encode.rs:1376-1408).

    Example (chained setters; ``fast``/``best`` match src/encode.rs
    :1635-1657):

    >>> from benchmark.reference.encode import Options
    >>> o = Options.best().with_block_size(1024).no_seektable()
    >>> (o.block_size, o.max_lpc_order, o.max_partition_order)
    (1024, 12, 6)
    >>> Options.fast().max_lpc_order is None
    True
    """

    block_size: int = 4096
    max_lpc_order: Optional[int] = 8        # None = fixed predictors only
    max_partition_order: int = 5
    mid_side: bool = True
    window: object = ("tukey", 0.5)
    exhaustive_channel_correlation: bool = True
    padding: Optional[int] = 4096
    seektable_interval: Optional[Tuple[str, int]] = ("seconds", 10)
    metadata_blocks: List = field(default_factory=list)
    clobber: bool = False

    def __post_init__(self):
        if self.block_size < 16 or self.block_size > 65535:
            raise OptionsError(f"block size {self.block_size}")
        if self.max_lpc_order is not None and not 1 <= self.max_lpc_order <= 32:
            raise OptionsError(f"max LPC order {self.max_lpc_order}")
        if not 0 <= self.max_partition_order <= 15:
            raise OptionsError(f"max partition order {self.max_partition_order}")

    # chained setters mirroring the reference surface
    def with_block_size(self, n: int) -> "Options":
        return replace(self, block_size=n)

    def with_max_lpc_order(self, n: Optional[int]) -> "Options":
        return replace(self, max_lpc_order=n)

    def with_max_partition_order(self, n: int) -> "Options":
        return replace(self, max_partition_order=n)

    def with_mid_side(self, enabled: bool = True) -> "Options":
        return replace(self, mid_side=enabled)

    def with_window(self, w) -> "Options":
        return replace(self, window=w)

    def fast_channel_correlation(self, enabled: bool = True) -> "Options":
        return replace(self, exhaustive_channel_correlation=not enabled)

    def with_padding(self, size: Optional[int]) -> "Options":
        return replace(self, padding=size)

    def no_padding(self) -> "Options":
        return replace(self, padding=None)

    def seektable_seconds(self, n: int) -> "Options":
        return replace(self, seektable_interval=("seconds", n))

    def seektable_frames(self, n: int) -> "Options":
        return replace(self, seektable_interval=("frames", n))

    def no_seektable(self) -> "Options":
        return replace(self, seektable_interval=None)

    def overwrite(self) -> "Options":
        """Allow path-opening writers to clobber existing files; the
        default refuses (reference: src/encode.rs:1620-1631)."""
        return replace(self, clobber=True)

    def tag(self, key: str, value: str) -> "Options":
        # deep-copy the VorbisComment before mutating: the block object is
        # shared with the parent Options (and any BlockList holding it)
        import copy

        o = replace(self, metadata_blocks=list(self.metadata_blocks))
        idx = next((i for i, b in enumerate(o.metadata_blocks)
                    if isinstance(b, meta.VorbisComment)), None)
        if idx is None:
            vc = meta.VorbisComment(vendor="flac-codec-tpu")
            o.metadata_blocks.append(vc)
        else:
            vc = copy.deepcopy(o.metadata_blocks[idx])
            o.metadata_blocks[idx] = vc
        vc.insert(key, value)
        return o

    def comment(self, vc: meta.VorbisComment) -> "Options":
        return self.add_block(vc)

    def picture(self, p: meta.Picture) -> "Options":
        return self.add_block(p)

    def cuesheet(self, c: meta.Cuesheet) -> "Options":
        return self.add_block(c)

    def application(self, a: meta.Application) -> "Options":
        return self.add_block(a)

    def add_block(self, b) -> "Options":
        o = replace(self, metadata_blocks=list(self.metadata_blocks))
        o.metadata_blocks.append(b)
        return o

    def add_blocks(self, bs) -> "Options":
        o = replace(self, metadata_blocks=list(self.metadata_blocks))
        o.metadata_blocks.extend(bs)
        return o

    # presets
    @classmethod
    def fast(cls) -> "Options":
        """reference: src/encode.rs:1635-1644."""
        return cls(block_size=1152, max_lpc_order=None, max_partition_order=3,
                   mid_side=False, exhaustive_channel_correlation=False)

    @classmethod
    def best(cls) -> "Options":
        """reference: src/encode.rs:1649-1657."""
        return cls(block_size=4096, max_lpc_order=12, max_partition_order=6)


@dataclass
class EncoderOptions:
    """Cut-down per-stream options (reference: src/encode.rs:1700-1709)."""

    block_size: int
    max_lpc_order: Optional[int]
    max_partition_order: int
    mid_side: bool
    window: object
    exhaustive_channel_correlation: bool
    use_rice2: bool

    @classmethod
    def from_options(cls, o: Options, bits_per_sample: int) -> "EncoderOptions":
        return cls(
            block_size=o.block_size,
            max_lpc_order=o.max_lpc_order,
            max_partition_order=o.max_partition_order,
            mid_side=o.mid_side,
            window=o.window,
            exhaustive_channel_correlation=o.exhaustive_channel_correlation,
            use_rice2=bits_per_sample > 16,
        )


# ---------------------------------------------------------------------------
# Subframe encoders (reference: src/encode.rs:2849-3272)
# ---------------------------------------------------------------------------

def _trailing_zeros_min(channel: np.ndarray) -> int:
    """Minimum trailing-zero count over samples; 0 if any sample has none;
    32 if all samples are zero (mirrors the try_fold at
    src/encode.rs:2877-2898)."""
    x = np.asarray(channel, dtype=np.int64)
    if np.all(x == 0):
        return 32
    u = (x & 0xFFFFFFFF).astype(np.uint64)
    tz = np.where(
        u == 0, 32,
        np.log2(((u & (~u + 1)) | 1).astype(np.float64)).astype(np.int64))
    return int(tz.min())


def encode_constant_subframe(w: BitRecorder, sample: int,
                             bits_per_sample: int, wasted: int) -> None:
    SubframeHeader("constant", 0, wasted).write(w)
    w.write_signed(sample, bits_per_sample)


def encode_verbatim_subframe(w: BitRecorder, channel: np.ndarray,
                             bits_per_sample: int, wasted: int) -> None:
    SubframeHeader("verbatim", 0, wasted).write(w)
    w.write_signed_array(channel, bits_per_sample)


def _write_residual_section(w: BitRecorder, options: EncoderOptions,
                            predictor_order: int, residuals: np.ndarray) -> None:
    rice_max = 31 if options.use_rice2 else 15
    partitions = best_partitions(residuals, predictor_order,
                                 options.max_partition_order, rice_max)
    rice_bits, partitions = choose_rice_coding(partitions, options.use_rice2)
    write_residuals_verbatim(w, partitions, rice_bits)


def encode_fixed_subframe(w: BitRecorder, options: EncoderOptions,
                          channel: np.ndarray, bits_per_sample: int,
                          wasted: int) -> None:
    order, residuals = fixedmod.best_fixed_order(channel)
    SubframeHeader("fixed", order, wasted).write(w)
    w.write_signed_array(channel[:order], bits_per_sample)
    _write_residual_section(w, options, order, residuals)


def encode_lpc_subframe(w: BitRecorder, options: EncoderOptions,
                        channel: np.ndarray, bits_per_sample: int,
                        wasted: int) -> None:
    params = lpcmod.best_parameters(
        options.window, bits_per_sample, options.max_lpc_order, channel)
    residuals = lpcmod.lpc_residuals(channel, params)
    if residuals is None:
        raise ResidualOverflow()
    SubframeHeader("lpc", params.order, wasted).write(w)
    w.write_signed_array(channel[:params.order], bits_per_sample)
    w.write(params.precision - 1, 4)
    w.write_signed(params.shift, 5)
    w.write_signed_array(params.coefficients, params.precision)
    _write_residual_section(w, options, params.order, residuals)


def encode_subframe(options: EncoderOptions, channel: np.ndarray,
                    bits_per_sample: int, all_0: Optional[bool] = None
                    ) -> BitRecorder:
    """Encode one channel, racing fixed vs LPC and falling back to
    verbatim/constant (reference: src/encode.rs:2849-2980)."""
    channel = np.asarray(channel, dtype=np.int64)
    if all_0 is None:
        all_0 = bool(np.all(channel == 0))
    if all_0:
        w = BitRecorder()
        encode_constant_subframe(w, int(channel[0]), bits_per_sample, 0)
        return w

    wasted = _trailing_zeros_min(channel)
    if wasted == 32:
        w = BitRecorder()
        encode_constant_subframe(w, int(channel[0]), bits_per_sample, 0)
        return w
    if wasted:
        channel = channel >> wasted
        bits_per_sample -= wasted

    candidates: List[BitRecorder] = []
    fixed_out = BitRecorder()
    try:
        encode_fixed_subframe(fixed_out, options, channel, bits_per_sample, wasted)
        candidates.append(fixed_out)
    except (FlacError, OverflowError):
        pass
    if options.max_lpc_order is not None:
        lpc_out = BitRecorder()
        try:
            encode_lpc_subframe(lpc_out, options, channel, bits_per_sample, wasted)
            candidates.append(lpc_out)
        except (InsufficientLpcSamples, ZeroLpCoefficients, NoBestLpcOrder,
                ResidualOverflow, FlacError, OverflowError):
            pass

    verbatim_len = len(channel) * bits_per_sample
    if candidates:
        best = min(candidates, key=lambda c: c.written())
        if best.written() < verbatim_len:
            return best
    w = BitRecorder()
    encode_verbatim_subframe(w, channel, bits_per_sample, wasted)
    return w


# ---------------------------------------------------------------------------
# Channel correlation (reference: src/encode.rs:2463-2847)
# ---------------------------------------------------------------------------

def correlate_channels(options: EncoderOptions, left: np.ndarray,
                       right: np.ndarray, bits_per_sample: int):
    """Fast abs-sum-based assignment choice (reference:
    src/encode.rs:2463-2674).  Returns (assignment, [(samples, bps, all0),
    (samples, bps, all0)])."""
    left = np.asarray(left, dtype=np.int64)
    right = np.asarray(right, dtype=np.int64)
    if bits_per_sample >= 32:
        # forego difference channels entirely
        return (ChannelAssignment.independent(2),
                [(left, bits_per_sample, None), (right, bits_per_sample, None)])

    diff_bps = bits_per_sample + 1
    left_sum = int(np.abs(left).sum())
    right_sum = int(np.abs(right).sum())
    difference = left - right
    side_sum = int(np.abs(difference).sum())

    if options.mid_side:
        average = (left + right) >> 1
        mid_sum = int(np.abs(average).sum())
        candidates = [
            (ChannelAssignment.independent(2), left_sum + right_sum),
            (ChannelAssignment.LEFT_SIDE, left_sum + side_sum),
            (ChannelAssignment.SIDE_RIGHT, side_sum + right_sum),
            (ChannelAssignment.MID_SIDE, mid_sum + side_sum),
        ]
    else:
        candidates = [
            (ChannelAssignment.LEFT_SIDE, left_sum + side_sum),
            (ChannelAssignment.SIDE_RIGHT, side_sum + right_sum),
            (ChannelAssignment.independent(2), left_sum + right_sum),
        ]

    assignment = min(candidates, key=lambda t: t[1])[0]
    if assignment == ChannelAssignment.LEFT_SIDE:
        chans = [(left, bits_per_sample, left_sum == 0),
                 (difference, diff_bps, side_sum == 0)]
    elif assignment == ChannelAssignment.SIDE_RIGHT:
        chans = [(difference, diff_bps, side_sum == 0),
                 (right, bits_per_sample, right_sum == 0)]
    elif assignment == ChannelAssignment.MID_SIDE:
        chans = [(average, bits_per_sample, mid_sum == 0),
                 (difference, diff_bps, side_sum == 0)]
    else:
        chans = [(left, bits_per_sample, left_sum == 0),
                 (right, bits_per_sample, right_sum == 0)]
    return assignment, chans


def correlate_channels_exhaustive(options: EncoderOptions, left: np.ndarray,
                                  right: np.ndarray, bits_per_sample: int):
    """Fully encode all four candidate channels and pick the pair with the
    fewest recorded bits (reference: src/encode.rs:2676-2847).

    Returns (assignment, [recorder0, recorder1]).
    """
    left = np.asarray(left, dtype=np.int64)
    right = np.asarray(right, dtype=np.int64)
    left_rec = encode_subframe(options, left, bits_per_sample, all_0=False)
    right_rec = encode_subframe(options, right, bits_per_sample, all_0=False)

    if bits_per_sample >= 32:
        return ChannelAssignment.independent(2), [left_rec, right_rec]

    diff_bps = bits_per_sample + 1
    difference = left - right
    diff_rec = encode_subframe(options, difference, diff_bps, all_0=False)

    if options.mid_side:
        average = (left + right) >> 1
        avg_rec = encode_subframe(options, average, bits_per_sample, all_0=False)
        candidates = [
            (ChannelAssignment.independent(2),
             left_rec.written() + right_rec.written()),
            (ChannelAssignment.LEFT_SIDE,
             left_rec.written() + diff_rec.written()),
            (ChannelAssignment.SIDE_RIGHT,
             diff_rec.written() + right_rec.written()),
            (ChannelAssignment.MID_SIDE,
             avg_rec.written() + diff_rec.written()),
        ]
    else:
        candidates = [
            (ChannelAssignment.independent(2),
             left_rec.written() + right_rec.written()),
            (ChannelAssignment.LEFT_SIDE,
             left_rec.written() + diff_rec.written()),
            (ChannelAssignment.SIDE_RIGHT,
             diff_rec.written() + right_rec.written()),
        ]

    assignment = min(candidates, key=lambda t: t[1])[0]
    if assignment == ChannelAssignment.LEFT_SIDE:
        recs = [left_rec, diff_rec]
    elif assignment == ChannelAssignment.SIDE_RIGHT:
        recs = [diff_rec, right_rec]
    elif assignment == ChannelAssignment.MID_SIDE:
        recs = [avg_rec, diff_rec]
    else:
        recs = [left_rec, right_rec]
    return assignment, recs


# ---------------------------------------------------------------------------
# Frame encoder (reference: src/encode.rs:2259-2439)
# ---------------------------------------------------------------------------

def encode_frame(options: EncoderOptions, streaminfo: meta.Streaminfo,
                 frame_number: int, channels: List[np.ndarray]) -> bytes:
    """Encode one FLAC frame to bytes (header + subframes + CRC-16)."""
    bps = streaminfo.bits_per_sample
    n = len(channels[0])

    if len(channels) == 2 and options.exhaustive_channel_correlation:
        assignment, recs = correlate_channels_exhaustive(
            options, channels[0], channels[1], bps)
    elif len(channels) == 2:
        assignment, corr = correlate_channels(
            options, channels[0], channels[1], bps)
        recs = [encode_subframe(options, s, b, all_0=a) for s, b, a in corr]
    else:
        assignment = ChannelAssignment.independent(len(channels))
        recs = [encode_subframe(options, ch, bps) for ch in channels]

    w = BitWriter()
    FrameHeader(
        blocking_strategy=False,
        block_size=n,
        sample_rate=streaminfo.sample_rate,
        channel_assignment=assignment,
        bits_per_sample=bps,
        frame_number=frame_number,
    ).write(w)
    for rec in recs:
        w.append_recorder(rec)
    w.byte_align()
    body = w.getvalue()
    return body + crcmod.crc16(body).to_bytes(2, "big")


# ---------------------------------------------------------------------------
# Seektable helpers (reference: src/encode.rs:1320-1359, 2131-2146)
# ---------------------------------------------------------------------------

@dataclass
class EncoderSeekPoint:
    sample_offset: int
    byte_offset: Optional[int]
    frame_samples: int


def _filter_seekpoints(interval, sample_rate: int,
                       points: List[EncoderSeekPoint]) -> List[EncoderSeekPoint]:
    kind, value = interval
    if kind == "frames":
        return points[::max(1, value)]
    nth_sample = max(1, value * sample_rate)
    out = []
    offset = 0
    for p in points:
        if p.sample_offset <= offset < p.sample_offset + p.frame_samples:
            out.append(p)
            offset += nth_sample
            # an interval shorter than a frame would leave the target
            # inside the frame just kept, stalling forever: snap to the
            # next frame (densest = one point per frame)
            if offset < p.sample_offset + p.frame_samples:
                offset = p.sample_offset + p.frame_samples
    return out


def _placeholder_points(total_samples: int, block_size: int
                        ) -> List[EncoderSeekPoint]:
    out = []
    for sample_offset in range(0, total_samples, block_size):
        out.append(EncoderSeekPoint(
            sample_offset, None,
            min(total_samples - sample_offset, block_size)))
    return out


MAX_SEEKTABLE_POINTS = (1 << 24) // 18  # reference: src/metadata/mod.rs:1989


# ---------------------------------------------------------------------------
# Encoder core (reference: src/encode.rs:1853-2117)
# ---------------------------------------------------------------------------

class Encoder:
    def __init__(self, fp: BinaryIO, options: Options, sample_rate: int,
                 bits_per_sample: int, channels: int,
                 total_samples: Optional[int]):
        if not 1 <= channels <= 8:
            raise InvalidChannels(str(channels))
        if total_samples is not None and total_samples >= MAX_SAMPLES:
            raise ExcessiveTotalSamples(str(total_samples))
        if not 0 <= sample_rate < (1 << 20):
            raise OptionsError(f"sample rate {sample_rate}")

        streaminfo = meta.Streaminfo(
            minimum_block_size=options.block_size,
            maximum_block_size=options.block_size,
            minimum_frame_size=None,
            maximum_frame_size=None,
            sample_rate=sample_rate,
            channels=channels,
            bits_per_sample=bits_per_sample,
            total_samples=total_samples,
            md5=None,
        )
        blocks = meta.BlockList(streaminfo, list(options.metadata_blocks))

        # dummy SEEKTABLE to be populated at finalize
        if total_samples is not None and options.seektable_interval is not None:
            placeholders = _filter_seekpoints(
                options.seektable_interval, sample_rate,
                _placeholder_points(total_samples, options.block_size))
            placeholders = placeholders[:MAX_SEEKTABLE_POINTS]
            if placeholders:
                blocks.insert(meta.SeekTable(
                    [meta.SeekPoint.placeholder() for _ in placeholders]))

        if options.padding is not None:
            blocks.insert(meta.Padding(options.padding))

        # sort blocks: VorbisComment, SeekTable, Picture, Application,
        # Cuesheet, Padding (reference: src/encode.rs:1944-1951)
        order = {meta.VORBIS_COMMENT: 0, meta.SEEKTABLE: 1, meta.PICTURE: 2,
                 meta.APPLICATION: 3, meta.CUESHEET: 4, meta.PADDING: 5}
        blocks.sort_by(lambda b: order.get(b.TYPE, 9))

        self.fp = fp
        self.start = fp.tell() if fp.seekable() else 0
        meta.write_blocks(fp, blocks)

        self.blocks = blocks
        self.options = EncoderOptions.from_options(options, bits_per_sample)
        self.seektable_interval = options.seektable_interval
        self.sample_rate = sample_rate
        self.frame_number = 0
        self.samples_written = 0
        self.frame_bytes_written = 0
        self.seekpoints: List[EncoderSeekPoint] = []
        self.md5 = hashlib.md5()
        self.finalized = False

    @property
    def streaminfo(self) -> meta.Streaminfo:
        return self.blocks.streaminfo

    @property
    def channel_count(self) -> int:
        return self.streaminfo.channels

    def encode(self, channels: List[np.ndarray]) -> None:
        """Encode one audio frame given channel-major samples
        (reference: src/encode.rs:1997-2022)."""
        n = len(channels[0])
        self._check_total(n)
        self.write_frame(encode_frame(self.options, self.streaminfo,
                                      self.frame_number, channels), n)

    def _check_total(self, n: int) -> None:
        total = self.streaminfo.total_samples
        if total is not None and self.samples_written + n > total:
            raise TotalSamplesMismatch(
                f"{self.samples_written + n} > declared {total}")

    def write_frame(self, data: bytes, n: int) -> None:
        """Write one encoded frame of ``n`` samples a channel: the part of
        :meth:`encode` after the frame is encoded, so that frames encoded
        elsewhere (in worker processes) make the same stream."""
        self._check_total(n)
        self.seekpoints.append(EncoderSeekPoint(
            self.samples_written, self.frame_bytes_written, n))
        self.fp.write(data)
        self.frame_bytes_written += len(data)
        self.samples_written += n
        self.frame_number = increment_frame_number(self.frame_number)

        # min/max frame size stats (reference: src/encode.rs:2413-2436)
        size = len(data)
        if 0 < size < meta.Streaminfo.MAX_FRAME_SIZE:
            si = self.streaminfo
            si.minimum_frame_size = (size if si.minimum_frame_size is None
                                     else min(si.minimum_frame_size, size))
            si.maximum_frame_size = (size if si.maximum_frame_size is None
                                     else max(si.maximum_frame_size, size))

    def finalize(self) -> None:
        """Fill the SEEKTABLE, verify/set totals + MD5, rewrite metadata
        in place (reference: src/encode.rs:2024-2110)."""
        if self.finalized:
            return
        self.finalized = True

        if self.seektable_interval is not None:
            final_points = _filter_seekpoints(
                self.seektable_interval, self.sample_rate, self.seekpoints)
            table = self.blocks.get(meta.SeekTable)
            if table is not None:
                count = len(table.points)
                pts = [meta.SeekPoint(p.sample_offset, p.byte_offset,
                                      p.frame_samples)
                       for p in final_points[:count]]
                while len(pts) < count:
                    pts.append(meta.SeekPoint.placeholder())
                table.points = pts
            else:
                pad = self.blocks.get(meta.Padding)
                if pad is not None:
                    new_table = meta.SeekTable([
                        meta.SeekPoint(p.sample_offset, p.byte_offset,
                                       p.frame_samples)
                        for p in final_points[:MAX_SEEKTABLE_POINTS]])
                    needed = 4 + len(new_table.to_bytes())
                    if pad.size >= needed:
                        pad.size -= needed
                        self.blocks.insert(new_table)
                        order = {meta.VORBIS_COMMENT: 0, meta.SEEKTABLE: 1,
                                 meta.PICTURE: 2, meta.APPLICATION: 3,
                                 meta.CUESHEET: 4, meta.PADDING: 5}
                        self.blocks.sort_by(lambda b: order.get(b.TYPE, 9))

        si = self.streaminfo
        if si.total_samples is not None:
            if si.total_samples != self.samples_written:
                raise TotalSamplesMismatch(
                    f"wrote {self.samples_written}, declared {si.total_samples}")
        else:
            if self.samples_written >= MAX_SAMPLES:
                raise ExcessiveTotalSamples(str(self.samples_written))
            si.total_samples = self.samples_written

        si.md5 = self.md5.digest()

        if self.fp.seekable():
            pos = self.fp.tell()
            self.fp.seek(self.start)
            meta.write_blocks(self.fp, self.blocks)
            self.fp.seek(pos)

    def update_md5(self, interleaved: np.ndarray) -> None:
        """reference: src/encode.rs:1292-1318."""
        self.md5.update(samples_to_bytes(
            interleaved, self.streaminfo.bits_per_sample))


# ---------------------------------------------------------------------------
# Writer surfaces
# ---------------------------------------------------------------------------

def _create_file(path, options: Options):
    """Open an output path for writing, refusing to clobber an existing
    file unless ``Options.overwrite()`` was chosen (reference:
    src/encode.rs:1659-1672 — ``create_new`` vs ``File::create``).
    Raises :class:`FileExistsError` (an ``OSError``, matching the
    reference's ``io::Error``) when the path exists and clobber is off."""
    return open(path, "wb+" if options.clobber else "xb+")


class FlacSampleWriter:
    """Interleaved i32 sample writer (reference: src/encode.rs:407-689).

    Example (encode -> decode roundtrip, mirrors the reference's
    FlacSampleWriter doc example):

    >>> import io
    >>> from benchmark.reference.encode import FlacSampleWriter, Options
    >>> from benchmark.reference.decode import FlacSampleReader
    >>> buf = io.BytesIO()
    >>> opts = Options().with_block_size(16).no_seektable()
    >>> with FlacSampleWriter(buf, opts, 44100, 16, 2,
    ...                       total_samples=4) as w:
    ...     w.write([0, 0, -1, 1, 100, -100, 32767, -32768])
    >>> with FlacSampleReader(io.BytesIO(buf.getvalue())) as r:
    ...     r.read(8).tolist()
    [0, 0, -1, 1, 100, -100, 32767, -32768]
    """

    def __init__(self, fp_or_path, options: Options, sample_rate: int,
                 bits_per_sample: int, channels: int,
                 total_samples: Optional[int] = None):
        if isinstance(fp_or_path, (str, bytes)):
            fp_or_path = _create_file(fp_or_path, options)
            self._owns_fp = True
        else:
            self._owns_fp = False
        self.encoder = Encoder(fp_or_path, options, sample_rate,
                               bits_per_sample, channels, total_samples)
        self._chunks: list = []
        self._buffered = 0
        self._frame_len = options.block_size * channels

    @property
    def _buf(self) -> np.ndarray:
        if len(self._chunks) != 1:
            merged = (np.concatenate(self._chunks) if self._chunks
                      else np.empty(0, dtype=np.int64))
            self._chunks = [merged]
        return self._chunks[0]

    @_buf.setter
    def _buf(self, value) -> None:
        self._chunks = [value] if len(value) else []
        self._buffered = len(value)

    def write(self, samples) -> None:
        # accumulate chunks; merge only when a whole frame is buffered so
        # many small writes stay O(n) instead of re-copying the remainder
        samples = np.asarray(samples, dtype=np.int64)
        if len(samples):
            self._chunks.append(samples)
            self._buffered += len(samples)
        if self._buffered < self._frame_len:
            return
        buf = self._buf
        ch = self.encoder.channel_count
        pos = 0
        while len(buf) - pos >= self._frame_len:
            chunk = buf[pos:pos + self._frame_len]
            pos += self._frame_len
            self.encoder.update_md5(chunk)
            self.encoder.encode(list(deinterleave(chunk, ch)))
        self._buf = buf[pos:]

    def finalize(self) -> None:
        if len(self._buf):
            ch = self.encoder.channel_count
            if len(self._buf) % ch:
                raise SamplesNotDivisibleByChannels(
                    f"{len(self._buf)} % {ch}")
            self.encoder.update_md5(self._buf)
            self.encoder.encode(list(deinterleave(self._buf, ch)))
            self._buf = np.empty(0, dtype=np.int64)
        self.encoder.finalize()
        if self._owns_fp:
            self.encoder.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finalize()
            return
        # Error path: mirror the reference's finalize-on-Drop
        # (src/encode.rs:399-405, 2113-2117) so an interrupted encode
        # still leaves valid STREAMINFO/SEEKTABLE, without masking the
        # in-flight exception.
        try:
            self.finalize()
        except Exception:
            if self._owns_fp:
                try:
                    self.encoder.fp.close()
                except Exception:
                    pass


class FlacChannelWriter:
    """Channel-major writer (reference: src/encode.rs:691-1004).

    Example:

    >>> import io
    >>> from benchmark.reference.encode import FlacChannelWriter, Options
    >>> from benchmark.reference.decode import FlacChannelReader
    >>> buf = io.BytesIO()
    >>> opts = Options().with_block_size(16).no_seektable()
    >>> with FlacChannelWriter(buf, opts, 44100, 16, 2,
    ...                        total_samples=3) as w:
    ...     w.write([[1, 2, 3], [-1, -2, -3]])
    >>> with FlacChannelReader(io.BytesIO(buf.getvalue())) as r:
    ...     [c.tolist() for c in r.fill_buf()]
    [[1, 2, 3], [-1, -2, -3]]
    """

    def __init__(self, fp_or_path, options: Options, sample_rate: int,
                 bits_per_sample: int, channels: int,
                 total_samples: Optional[int] = None):
        if isinstance(fp_or_path, (str, bytes)):
            fp_or_path = _create_file(fp_or_path, options)
            self._owns_fp = True
        else:
            self._owns_fp = False
        self.encoder = Encoder(fp_or_path, options, sample_rate,
                               bits_per_sample, channels, total_samples)
        self._chans = channels
        self._buf = [np.empty(0, dtype=np.int64) for _ in range(channels)]
        self._block = options.block_size

    def write(self, channels: List[np.ndarray]) -> None:
        if len(channels) != self._chans:
            raise InvalidChannels(
                f"got {len(channels)} channels, expected {self._chans}")
        lens = {len(c) for c in channels}
        if len(lens) != 1:
            raise SamplesNotDivisibleByChannels("unequal channel lengths")
        self._buf = [np.concatenate([b, np.asarray(c, dtype=np.int64)])
                     for b, c in zip(self._buf, channels)]
        while len(self._buf[0]) >= self._block:
            frame = [b[:self._block] for b in self._buf]
            self._buf = [b[self._block:] for b in self._buf]
            self.encoder.update_md5(np.stack(frame).T.reshape(-1))
            self.encoder.encode(frame)

    def finalize(self) -> None:
        if len(self._buf[0]):
            self.encoder.update_md5(np.stack(self._buf).T.reshape(-1))
            self.encoder.encode(self._buf)
            self._buf = [np.empty(0, dtype=np.int64) for _ in range(self._chans)]
        self.encoder.finalize()
        if self._owns_fp:
            self.encoder.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finalize()
            return
        # Error path: finalize-on-Drop mirror (src/encode.rs:2113-2117);
        # never mask the in-flight exception.
        try:
            self.finalize()
        except Exception:
            if self._owns_fp:
                try:
                    self.encoder.fp.close()
                except Exception:
                    pass


class FlacByteWriter:
    """PCM-bytes writer (reference: src/encode.rs:103-405).

    Example (little-endian 16-bit PCM bytes in, identical bytes back):

    >>> import io
    >>> from benchmark.reference.encode import FlacByteWriter, Options
    >>> from benchmark.reference.decode import FlacByteReader
    >>> pcm = (1000).to_bytes(2, "little", signed=True) * 4
    >>> buf = io.BytesIO()
    >>> opts = Options().with_block_size(16).no_seektable()
    >>> with FlacByteWriter(buf, opts, 44100, 16, 2,
    ...                     total_bytes=len(pcm)) as w:
    ...     w.write(pcm)
    >>> FlacByteReader(io.BytesIO(buf.getvalue())).read() == pcm
    True
    """

    def __init__(self, fp_or_path, options: Options, sample_rate: int,
                 bits_per_sample: int, channels: int,
                 total_bytes: Optional[int] = None,
                 big_endian: bool = False):
        width = (bits_per_sample + 7) // 8
        total_samples = None
        if total_bytes is not None:
            if total_bytes % (width * channels):
                raise SamplesNotDivisibleByChannels(str(total_bytes))
            total_samples = total_bytes // (width * channels)
        self._inner = FlacSampleWriter(fp_or_path, options, sample_rate,
                                       bits_per_sample, channels, total_samples)
        self.big_endian = big_endian
        self._bps = bits_per_sample
        self._pending = b""

    @classmethod
    def create(cls, path: str, options: Options, sample_rate: int,
               bits_per_sample: int, channels: int,
               total_bytes: Optional[int] = None) -> "FlacByteWriter":
        return cls(path, options, sample_rate, bits_per_sample, channels,
                   total_bytes)

    @classmethod
    def create_cdda(cls, path: str, options: Options,
                    total_bytes: Optional[int] = None) -> "FlacByteWriter":
        return cls(path, options, 44100, 16, 2, total_bytes)

    def write(self, data: bytes) -> None:
        data = self._pending + data
        width = (self._bps + 7) // 8
        usable = len(data) - len(data) % width
        self._pending = data[usable:]
        if usable:
            self._inner.write(bytes_to_samples(
                data[:usable], self._bps, self.big_endian))

    def finalize(self) -> None:
        if self._pending:
            raise SamplesNotDivisibleByChannels("trailing partial sample bytes")
        self._inner.finalize()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finalize()
            return
        # Error path: drop the partial trailing sample bytes (finalize
        # would reject them) and delegate to the inner writer's
        # finalize-on-Drop mirror.  Regression guard: this previously
        # referenced self._owns_fp / self.encoder, which only exist on
        # the inner FlacSampleWriter, raising AttributeError and masking
        # the in-flight exception.
        self._pending = b""
        self._inner.__exit__(exc_type, *exc)


class FlacStreamWriter:
    """Metadata-less per-call frame writer (reference:
    src/encode.rs:1006-1290).  Subset streams only; parameters may change
    per call; rice2 iff bps > 16; frame number wraps at max.

    Example (mirrors the reference's FlacStreamWriter doc example):

    >>> import io
    >>> from benchmark.reference.encode import FlacStreamWriter
    >>> from benchmark.reference.decode import FlacStreamReader
    >>> raw = io.BytesIO()
    >>> w = FlacStreamWriter(raw)
    >>> w.write(list(range(32)), 44100, 16, 1)
    >>> _ = raw.seek(0)
    >>> frame = FlacStreamReader(raw).read_frame()
    >>> (frame.sample_rate, frame.channels, frame.samples[:4].tolist())
    (44100, 1, [0, 1, 2, 3])
    """

    def __init__(self, fp: BinaryIO, options: Optional[Options] = None):
        self.fp = fp
        self.options = options or Options()
        self.frame_number = 0

    def write(self, samples: np.ndarray, sample_rate: int,
              bits_per_sample: int, channels: int) -> None:
        samples = np.asarray(samples, dtype=np.int64)
        if len(samples) % channels:
            raise SamplesNotDivisibleByChannels(str(len(samples)))
        opts = EncoderOptions.from_options(self.options, bits_per_sample)
        streaminfo = meta.Streaminfo(
            sample_rate=sample_rate, channels=channels,
            bits_per_sample=bits_per_sample,
            minimum_block_size=0, maximum_block_size=65535)
        chans = list(deinterleave(samples, channels))
        data = encode_frame(opts, streaminfo, self.frame_number, chans)
        self.fp.write(data)
        self.frame_number = (self.frame_number + 1) & ((1 << 36) - 1)


def generate_seektable(fp: BinaryIO, interval: Tuple[str, int] = ("seconds", 10)
                       ) -> meta.SeekTable:
    """Rebuild a seektable by walking frame offsets (reference:
    src/encode.rs:2223-2257)."""
    from .decode import Decoder

    dec = Decoder(fp)
    metadata_start = dec.frames_start
    points: List[EncoderSeekPoint] = []
    sample_offset = 0
    while True:
        dec.r.discard_consumed()
        byte_offset = dec.r.abs_byte_pos
        frame = dec.read_frame()
        if frame is None:
            break
        points.append(EncoderSeekPoint(
            sample_offset, byte_offset, frame.shape[1]))
        sample_offset += frame.shape[1]
    filtered = _filter_seekpoints(interval, dec.sample_rate, points)
    return meta.SeekTable([
        meta.SeekPoint(p.sample_offset, p.byte_offset, p.frame_samples)
        for p in filtered[:MAX_SEEKTABLE_POINTS]])
