"""ctypes loader for the native host engine (flacnat.cpp).

Compiles the C++ source on first use with g++ (no pybind11 — pure C ABI via
ctypes) into ``flac_codec_tpu_torch/build/native/<hash>/``, keyed by a hash
of the source and flags, so a checkout builds from its own files and an
edited source rebuilds.  The port needs the engine (frame parse, bulk
decode, frame assembly): :func:`load` raises, with the compiler's output,
when it cannot build or load it.  It never returns ``None``.

Flavors, on the JAX package's rule: :func:`load` always builds the
portable library first.  On an x86-64-v3 host (:func:`_cpu_is_v3`) with
``FLAC_TPU_PORTABLE_SO`` unset it then builds and loads a
``-march=x86-64-v3`` flavor (``lzcnt`` and ``shlx`` in the Rice chain),
and loads the portable library, with a ``RuntimeWarning``, when that
build fails.  ``FLAVOR`` names the flavor that loaded and ``V3_ERROR``
holds the failed v3 build's message.  No flavor changes a byte or a
sample: the engine has no floating point, and its SIMD paths dispatch on
``__builtin_cpu_supports``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import warnings

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "flacnat.cpp")
BUILD = os.path.join(os.path.dirname(_HERE), "build", "native")
# portable -O3 on purpose: the SIMD fast paths carry per-function target
# attributes with runtime cpuid dispatch
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# added to GXX_FLAGS for the "v3" flavor
V3_FLAGS = ("-march=x86-64-v3",)

_lock = threading.Lock()
_lib = None
# the flavor load() loaded ("v3" or "portable"), and the v3 build's error
# when it failed and the portable library loaded instead
FLAVOR = None
V3_ERROR = None


class Native:
    """Typed wrapper over the C ABI in flacnat.cpp."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)

        lib.nat_crc8.restype = ctypes.c_uint32
        lib.nat_crc8.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        lib.nat_crc16.restype = ctypes.c_uint32
        lib.nat_crc16.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        lib.nat_pack_symbols.restype = ctypes.c_uint64
        lib.nat_pack_symbols.argtypes = [u8p, ctypes.c_uint64, u64p, u32p, ctypes.c_size_t]
        lib.nat_pack_rice.restype = ctypes.c_uint64
        lib.nat_pack_rice.argtypes = [u8p, ctypes.c_uint64, i32p, ctypes.c_size_t, ctypes.c_uint32]
        lib.nat_unpack_rice.restype = ctypes.c_uint64
        lib.nat_unpack_rice.argtypes = [u8p, ctypes.c_uint64, i64p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint64]
        lib.nat_unpack_signed.restype = ctypes.c_uint64
        lib.nat_unpack_signed.argtypes = [u8p, ctypes.c_uint64, i64p, ctypes.c_size_t, ctypes.c_uint32]
        lib.nat_pack_signed.restype = ctypes.c_uint64
        lib.nat_pack_signed.argtypes = [u8p, ctypes.c_uint64, i64p, ctypes.c_size_t, ctypes.c_uint32]
        lib.nat_append_bits.restype = ctypes.c_uint64
        lib.nat_append_bits.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64]
        lib.nat_lpc_predict64.restype = None
        lib.nat_lpc_predict64.argtypes = [i64p, ctypes.c_size_t, i32p, ctypes.c_uint32, ctypes.c_uint32]
        lib.nat_lpc_predict32.restype = None
        lib.nat_lpc_predict32.argtypes = [i32p, ctypes.c_size_t, i32p, ctypes.c_uint32, ctypes.c_uint32]
        lib.nat_lpc_residuals.restype = ctypes.c_int32
        lib.nat_lpc_residuals.argtypes = [i64p, ctypes.c_size_t, i32p, ctypes.c_uint32, ctypes.c_uint32, i32p]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.nat_parse_frames_raw.restype = ctypes.c_int64
        lib.nat_parse_frames_raw.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint64,
            i32p, u8p, i8p, u8p, i32p, u8p, u32p,
            ctypes.POINTER(ctypes.c_uint64), u32p, ctypes.c_uint32, u32p]
        for scan in (lib.nat_scan_frames, lib.nat_scan_frames_portable):
            scan.restype = ctypes.c_int64
            scan.argtypes = [
                u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint64,
                u64p, u32p, u8p, u32p,
                ctypes.POINTER(ctypes.c_uint64), u32p]
        lib.nat_scan_simd.restype = ctypes.c_int32
        lib.nat_scan_simd.argtypes = []
        # whether scan_frames takes the one-pass AVX2 and PCLMUL scan here
        self.scan_simd = bool(lib.nat_scan_simd())
        lib.nat_decode_frames.restype = ctypes.c_int64
        lib.nat_decode_frames.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint64,
            i32p, u32p, ctypes.POINTER(ctypes.c_uint64), u32p]
        lib.nat_decode_frames_mt.restype = ctypes.c_int64
        lib.nat_decode_frames_mt.argtypes = (
            list(lib.nat_decode_frames.argtypes) + [ctypes.c_uint32])
        lib.nat_decode_frames_ilv.restype = ctypes.c_int64
        lib.nat_decode_frames_ilv.argtypes = lib.nat_decode_frames.argtypes
        lib.nat_assemble_batch.restype = ctypes.c_int64
        lib.nat_assemble_batch.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint64,
            u8p,                       # assignment
            u8p, u8p, u8p, u8p, i8p,   # sub_type, wasted, order, precision, shift
            i32p,                      # qcoeffs
            u8p, u8p, u8p,             # po, rice_bits, kinds
            i32p, i32p, i32p,          # params, residuals, channels
            u8p, ctypes.c_uint32, u32p, ctypes.c_uint32,
            u8p, u64p, u64p,           # blobs, blob_start_bits, blob_bits
            ctypes.c_uint32]           # chan_stride
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.nat_assemble_packed.restype = ctypes.c_int64
        lib.nat_assemble_packed.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint64,
            u8p,                       # assignment
            u8p, ctypes.c_uint64,      # blob, slot_bytes
            u64p, u16p, u8p,           # body_bits, inner_crc, fallback
            u8p, ctypes.c_uint32, u32p, ctypes.c_uint32]

    @staticmethod
    def _u8(buf) -> "ctypes.POINTER(ctypes.c_uint8)":
        return (ctypes.c_uint8 * len(buf)).from_buffer(buf) if isinstance(buf, bytearray) else \
            ctypes.cast(ctypes.c_char_p(bytes(buf)), ctypes.POINTER(ctypes.c_uint8))

    def crc8(self, data: bytes, crc: int = 0) -> int:
        return self._lib.nat_crc8(
            ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8)), len(data), crc)

    def crc16(self, data: bytes, crc: int = 0) -> int:
        return self._lib.nat_crc16(
            ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8)), len(data), crc)

    def pack_rice(self, out: np.ndarray, bitpos: int, res: np.ndarray, k: int) -> int:
        res = np.ascontiguousarray(res, dtype=np.int32)
        return self._lib.nat_pack_rice(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bitpos,
            res.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(res), k)

    def unpack_rice(self, buf: np.ndarray, bitpos: int, n: int, k: int,
                    limit_bits: int = None):
        """limit_bits bounds every read (defaults to the buffer size);
        returns end > limit_bits on truncation (callers raise)."""
        if limit_bits is None:
            limit_bits = len(buf) * 8
        res = np.empty(n, dtype=np.int64)
        end = self._lib.nat_unpack_rice(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bitpos,
            res.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, k,
            limit_bits)
        return res, end

    def unpack_signed(self, buf: np.ndarray, bitpos: int, n: int, width: int):
        res = np.empty(n, dtype=np.int64)
        end = self._lib.nat_unpack_signed(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bitpos,
            res.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, width)
        return res, end

    def pack_signed(self, out: np.ndarray, bitpos: int, vals: np.ndarray, width: int) -> int:
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        return self._lib.nat_pack_signed(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bitpos,
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(vals), width)

    def pack_symbols(self, out: np.ndarray, bitpos: int,
                     values: np.ndarray, nbits: np.ndarray) -> int:
        values = np.ascontiguousarray(values, dtype=np.uint64)
        nbits = np.ascontiguousarray(nbits, dtype=np.uint32)
        return self._lib.nat_pack_symbols(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bitpos,
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            nbits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(values))

    def append_bits(self, out: np.ndarray, bitpos: int, src: np.ndarray, nbits: int) -> int:
        return self._lib.nat_append_bits(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bitpos,
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbits)

    def lpc_predict64(self, x: np.ndarray, q: np.ndarray, shift: int) -> None:
        qa = np.ascontiguousarray(q, dtype=np.int32)
        self._lib.nat_lpc_predict64(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(x),
            qa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(qa), shift)

    def lpc_predict32(self, x: np.ndarray, q: np.ndarray, shift: int) -> None:
        qa = np.ascontiguousarray(q, dtype=np.int32)
        self._lib.nat_lpc_predict32(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(x),
            qa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(qa), shift)

    def assemble_batch(self, *, N: int, bps_base: int, sample_rate: int,
                       first_frame_number: int, assignment: np.ndarray,
                       sub_type: np.ndarray, wasted: np.ndarray,
                       order: np.ndarray, precision: np.ndarray,
                       shift: np.ndarray, qcoeffs: np.ndarray,
                       po: np.ndarray, rice_bits: np.ndarray,
                       kinds: np.ndarray, params: np.ndarray,
                       residuals: np.ndarray, channels: np.ndarray,
                       nthreads: int = 0, blobs: np.ndarray = None,
                       blob_start_bits: np.ndarray = None,
                       blob_bits: np.ndarray = None,
                       chan_stride: int = None):
        """Assemble a whole batch of frames; returns list of per-frame bytes
        (an entry is ``None`` when the native core skipped the frame — a
        verbatim subframe met warm-up-only channel data).

        All plan arrays are (S, B, ...) contiguous; ``channels`` holds the
        wasted-shifted subframe samples: (S, B, N), or (S, B, chan_stride)
        warm-ups only when residual blobs are supplied.
        """
        import os

        S, B = sub_type.shape
        max_bytes = 64 + S * (N * 34 // 8 + 300)
        out = np.zeros((B, max_bytes), dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.uint32)
        if nthreads <= 0:
            nthreads = min(8, os.cpu_count() or 1)

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        u8, i8, i32, u32 = (ctypes.c_uint8, ctypes.c_int8, ctypes.c_int32,
                            ctypes.c_uint32)
        u64 = ctypes.c_uint64
        if blobs is not None:
            blob_args = (p(blobs, u8), p(blob_start_bits, u64),
                         p(blob_bits, u64))
        else:
            blob_args = (ctypes.POINTER(ctypes.c_uint8)(),
                         ctypes.POINTER(ctypes.c_uint64)(),
                         ctypes.POINTER(ctypes.c_uint64)())
        if chan_stride is None:
            chan_stride = channels.shape[-1]
        total = self._lib.nat_assemble_batch(
            B, N, S, bps_base, sample_rate, first_frame_number,
            p(assignment, u8),
            p(sub_type, u8), p(wasted, u8), p(order, u8), p(precision, u8),
            p(shift, i8), p(qcoeffs, i32),
            p(po, u8), p(rice_bits, u8), p(kinds, u8),
            p(params, i32), p(residuals, i32), p(channels, i32),
            p(out, u8), max_bytes, p(lengths, u32), nthreads, *blob_args,
            chan_stride)
        assert total >= 0
        return [out[b, :lengths[b]].tobytes() if lengths[b] else None
                for b in range(B)]

    def assemble_packed(self, *, N: int, bps_base: int, sample_rate: int,
                        first_frame_number: int, assignment: np.ndarray,
                        blob: np.ndarray, slot_bytes: int,
                        body_bits: np.ndarray, inner_crc: np.ndarray,
                        fallback: np.ndarray, nthreads: int = 0):
        """Splice device-packed frame bodies (ops/framepack.py) into
        finished frames: ~10 header bytes + one memcpy + an O(log L)
        GF(2) multiply to finish the CRC-16 per frame.  Returns a list of
        per-frame bytes (``None`` = host fallback needed)."""
        import os

        B = len(assignment)
        max_bytes = int(slot_bytes) + 32
        out = np.zeros((B, max_bytes), dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.uint32)
        if nthreads <= 0:
            nthreads = min(8, os.cpu_count() or 1)

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        u8, u32 = ctypes.c_uint8, ctypes.c_uint32
        u64, u16 = ctypes.c_uint64, ctypes.c_uint16
        total = self._lib.nat_assemble_packed(
            B, N, bps_base, sample_rate, first_frame_number,
            p(assignment, u8), p(blob, u8), slot_bytes,
            p(body_bits, u64), p(inner_crc, u16), p(fallback, u8),
            p(out, u8), max_bytes, p(lengths, u32), nthreads)
        assert total >= 0
        return [out[b, :lengths[b]].tobytes() if lengths[b] else None
                for b in range(B)]

    def parse_frames_raw(self, buf: np.ndarray, start_bitpos: int,
                         n_frames: int, sample_rate: int, channels: int,
                         bps: int, block_size: int, remaining_samples,
                         nthreads: int = 0):
        """Parse frames for the device decode pipeline; returns a dict of
        raw-subframe arrays (buffers pre-predict) + end bitpos + error.
        The uniform-block prefix is parsed in contiguous spans, one thread
        each: ``nthreads`` 0 takes min(usable CPUs, frames // 16), another
        value at most that many spans (1 = the one-thread pump).  The
        arrays are the same whatever the spans; ``spans`` says how many
        parsed the prefix (0: the sequential parser, 1: the one-thread
        pump)."""
        out = np.zeros((n_frames, channels, block_size), dtype=np.int32)
        order = np.zeros((n_frames, channels), dtype=np.uint8)
        shift = np.zeros((n_frames, channels), dtype=np.int8)
        wasted = np.zeros((n_frames, channels), dtype=np.uint8)
        qcoeffs = np.zeros((n_frames, channels, 32), dtype=np.int32)
        assignment = np.zeros(n_frames, dtype=np.uint8)
        blocks = np.zeros(n_frames, dtype=np.uint32)
        end = ctypes.c_uint64(0)
        err = np.zeros(1, dtype=np.uint32)
        spans = np.zeros(1, dtype=np.uint32)
        rem = (1 << 64) - 1 if remaining_samples is None else remaining_samples

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        u8, i8, i32, u32 = (ctypes.c_uint8, ctypes.c_int8, ctypes.c_int32,
                            ctypes.c_uint32)
        n = self._lib.nat_parse_frames_raw(
            p(buf, u8), len(buf), start_bitpos, n_frames, sample_rate,
            channels, bps, block_size, rem,
            p(out, i32), p(order, u8), p(shift, i8), p(wasted, u8),
            p(qcoeffs, i32), p(assignment, u8), p(blocks, u32),
            ctypes.byref(end), p(err, u32), nthreads, p(spans, u32))
        n = int(n)
        return {
            "n": n, "buf": out[:n], "order": order[:n], "shift": shift[:n],
            "wasted": wasted[:n], "qcoeffs": qcoeffs[:n],
            "assignment": assignment[:n], "blocks": blocks[:n],
            "end_bitpos": int(end.value), "error": int(err[0]),
            "spans": int(spans[0]),
        }

    def scan_frames(self, buf: np.ndarray, start_bitpos: int,
                    n_frames: int, sample_rate: int, channels: int,
                    bps: int, block_size: int, remaining_samples):
        """Frame-boundary scan for the device-parse pipeline: per-frame
        body byte ranges + assignment, CRC-8/16 validated, residuals NOT
        decoded (the device does that).  Returns a dict; ``n`` frames
        found, ``error`` the DEC_* stop reason.  ``scan_simd`` says whether
        it takes the one-pass AVX2 and PCLMUL search."""
        return self._scan(self._lib.nat_scan_frames, buf,
                          start_bitpos, n_frames, sample_rate, channels, bps,
                          block_size, remaining_samples)

    def scan_frames_portable(self, buf: np.ndarray, start_bitpos: int,
                             n_frames: int, sample_rate: int, channels: int,
                             bps: int, block_size: int, remaining_samples):
        """:meth:`scan_frames` through the portable loop on any host (a
        ``memchr`` for every 0xFF, each CRC-16 from the frame's start),
        to hold the SIMD scan against."""
        return self._scan(self._lib.nat_scan_frames_portable, buf,
                          start_bitpos, n_frames, sample_rate, channels, bps,
                          block_size, remaining_samples)

    @staticmethod
    def _scan(fn, buf, start_bitpos, n_frames, sample_rate,
              channels, bps, block_size, remaining_samples):
        body_off = np.zeros(n_frames, dtype=np.uint64)
        body_bytes = np.zeros(n_frames, dtype=np.uint32)
        assignment = np.zeros(n_frames, dtype=np.uint8)
        blocks = np.zeros(n_frames, dtype=np.uint32)
        end = ctypes.c_uint64(0)
        err = np.zeros(1, dtype=np.uint32)
        rem = (1 << 64) - 1 if remaining_samples is None else remaining_samples

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        n = fn(
            p(buf, ctypes.c_uint8), len(buf), start_bitpos, n_frames,
            sample_rate, channels, bps, block_size, rem,
            p(body_off, ctypes.c_uint64), p(body_bytes, ctypes.c_uint32),
            p(assignment, ctypes.c_uint8), p(blocks, ctypes.c_uint32),
            ctypes.byref(end), p(err, ctypes.c_uint32))
        n = int(n)
        return {
            "n": n, "body_off": body_off[:n], "body_bytes": body_bytes[:n],
            "assignment": assignment[:n], "blocks": blocks[:n],
            "end_bitpos": int(end.value), "error": int(err[0]),
        }

    def decode_frames(self, buf: np.ndarray, start_bitpos: int,
                      n_frames: int, sample_rate: int, channels: int,
                      bps: int, max_block: int, remaining_samples,
                      nthreads: int = 0, out: np.ndarray = None):
        """Decode up to n_frames; returns (interleaved int32 array,
        block_sizes, end_bitpos, error_code).  nthreads > 1 engages the
        speculative frame-parallel decoder (identical semantics: any
        inconsistency falls back to the sequential path in C); 0 = use
        all cores, 1 = sequential.  Pass a preallocated int32 ``out`` to
        skip the per-call allocation (pipelines reuse one buffer)."""
        import os

        cap = n_frames * max_block
        if remaining_samples is not None:
            # frames cover at most remaining_samples; cap the output
            # allocation (and frame count) so huge n_frames requests do
            # not fault in pages that are never written
            cap = min(cap, remaining_samples)
            n_frames = min(n_frames, remaining_samples // 16 + 2)
        if out is None:
            out = np.empty(cap * channels, dtype=np.int32)
        else:
            assert out.dtype == np.int32 and len(out) >= cap * channels
        sizes = np.zeros(n_frames, dtype=np.uint32)
        end = ctypes.c_uint64(0)
        err = np.zeros(1, dtype=np.uint32)
        rem = (1 << 64) - 1 if remaining_samples is None else remaining_samples
        if nthreads == 0:
            # the speculative frame-parallel decoder pays a serial
            # candidate pre-scan + reconciliation; below 4 cores that
            # overhead outweighs the parallel span decode (measured:
            # 2 threads on a 1-core host decode ~5% SLOWER than 1), so
            # auto mode stays sequential on small hosts
            ncores = os.cpu_count() or 1
            nthreads = min(16, ncores) if ncores >= 4 else 1
        args = (
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            start_bitpos, n_frames, sample_rate, channels, bps, max_block,
            rem,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.byref(end),
            err.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        if nthreads <= 1 and not os.environ.get("FLAC_TPU_NO_ILV"):
            # single-core: the lockstep pump overlaps four frames' Rice
            # dependency chains on one thread (same speculative scan and
            # fallback semantics as the thread-pool path)
            n = self._lib.nat_decode_frames_ilv(*args)
        else:
            n = self._lib.nat_decode_frames_mt(*args, nthreads)
        total = int(sizes[:n].sum()) * channels
        return out[:total], sizes[:n], int(end.value), int(err[0])

    def lpc_residuals(self, x: np.ndarray, q: np.ndarray, shift: int):
        x = np.ascontiguousarray(x, dtype=np.int64)
        qa = np.ascontiguousarray(q, dtype=np.int32)
        n = len(x) - len(qa)
        res = np.empty(max(n, 0), dtype=np.int32)
        overflow = self._lib.nat_lpc_residuals(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(x),
            qa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(qa), shift,
            res.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return (None if overflow else res)


def _build(flags: tuple) -> str:
    """Compile flacnat.cpp with ``flags`` (once per source and flags hash)
    and return the library path.  Concurrent processes serialize on a lock
    file; a failed build raises with the compiler's output."""
    h = hashlib.sha256(" ".join(flags).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libflacnat.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", *flags, _SRC, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build the native engine: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native engine failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def _open(so: str) -> Native:
    try:
        return Native(ctypes.CDLL(so))
    except OSError as e:
        raise RuntimeError(f"loading the native engine {so} failed: "
                           f"{e}") from e


def open_flavor(flavor: str) -> Native:
    """Build (if needed) and open one flavor, ``"portable"`` or ``"v3"``,
    apart from the library :func:`load` chose; for holding the two
    flavors against each other in one process.  Raises if it cannot."""
    if flavor not in ("portable", "v3"):
        raise ValueError(f"unknown native flavor {flavor!r}")
    return _open(_build(GXX_FLAGS + (V3_FLAGS if flavor == "v3" else ())))


def load() -> Native:
    """Build (if needed) and load the native library; raises if the
    portable build fails.  Loads the v3 flavor where the module docstring
    says, and the portable library when the v3 build fails."""
    global _lib, FLAVOR, V3_ERROR
    with _lock:
        if _lib is None:
            so, flavor, V3_ERROR = _build(GXX_FLAGS), "portable", None
            if _cpu_is_v3() and not os.environ.get("FLAC_TPU_PORTABLE_SO"):
                try:
                    so, flavor = _build(GXX_FLAGS + V3_FLAGS), "v3"
                except RuntimeError as e:
                    V3_ERROR = str(e)
                    warnings.warn("the x86-64-v3 native build failed; "
                                  f"loading the portable one: {e}",
                                  RuntimeWarning, stacklevel=2)
            _lib = _open(so)
            FLAVOR = flavor
        return _lib


def _cpu_is_v3() -> bool:
    """True iff this CPU meets the x86-64-v3 feature level (the flags the
    v3 build may emit anywhere, not just in dispatch-guarded functions)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = set(line.split(":", 1)[1].split())
                    return {"avx2", "bmi1", "bmi2", "fma", "movbe",
                            "abm", "f16c"} <= flags
    except OSError:
        pass
    return False
