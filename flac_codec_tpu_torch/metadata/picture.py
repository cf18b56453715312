"""Image metric sniffers for PICTURE blocks (reference:
src/metadata/mod.rs:4227-4345 — mini-parsers for PNG, JPEG SOFn, GIF).
"""

from __future__ import annotations

import struct

from ..errors import InvalidPicture

PNG_SIG = b"\x89PNG\r\n\x1a\n"
GIF_SIGS = (b"GIF87a", b"GIF89a")

_JPEG_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                     0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def sniff_metrics(data: bytes):
    """Return (mime, width, height, depth, colors_used) for PNG/JPEG/GIF."""
    try:
        if data.startswith(PNG_SIG):
            return _png(data)
        if data[:2] == b"\xff\xd8":
            return _jpeg(data)
        if data[:6] in GIF_SIGS:
            return _gif(data)
    except (struct.error, IndexError) as e:
        raise InvalidPicture(f"truncated image: {e}")
    raise InvalidPicture("unsupported image format")


def _png(data: bytes):
    # IHDR must be the first chunk (reference: src/metadata/mod.rs:4227-4289)
    pos = 8
    colors = 0
    width = height = depth = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            if length < 13:
                raise InvalidPicture("short IHDR")
            width, height = struct.unpack_from(">II", body, 0)
            bit_depth = body[8]
            color_type = body[9]
            channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color_type)
            if channels is None:
                raise InvalidPicture("bad PNG color type")
            depth = bit_depth * channels
        elif ctype == b"PLTE":
            colors = length // 3
        elif ctype == b"IDAT":
            break
        pos += 8 + length + 4
    if width is None:
        raise InvalidPicture("missing IHDR")
    return "image/png", width, height, depth, colors


def _jpeg(data: bytes):
    # scan markers for SOFn (reference: src/metadata/mod.rs:4291-4327)
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (seglen,) = struct.unpack_from(">H", data, pos + 2)
        if marker in _JPEG_SOF_MARKERS:
            precision = data[pos + 4]
            height, width = struct.unpack_from(">HH", data, pos + 5)
            ncomp = data[pos + 9]
            return "image/jpeg", width, height, precision * ncomp, 0
        pos += 2 + seglen
    raise InvalidPicture("no JPEG SOF marker")


def _gif(data: bytes):
    # logical screen descriptor (reference: src/metadata/mod.rs:4329-4345)
    if len(data) < 13:
        raise InvalidPicture("short GIF")
    width, height = struct.unpack_from("<HH", data, 6)
    packed = data[10]
    gct_size = 2 << (packed & 0x07)
    has_gct = bool(packed & 0x80)
    depth = ((packed >> 4) & 0x07) + 1
    return "image/gif", width, height, depth, gct_size if has_gct else 0
