"""flac-view-artwork — render embedded artwork in the terminal
(reference: examples/flac-view-artwork.rs, viuer-based).

Renders with ANSI truecolor half-blocks; decodes PNG via zlib (stdlib) and
falls back to dumping the image to a file for other formats.
"""

from __future__ import annotations

import argparse
import struct
import sys
import zlib

from .. import metadata as meta
from ..errors import FlacError


def _decode_png(data: bytes):
    """Minimal PNG decoder (8-bit RGB/RGBA/gray, non-interlaced)."""
    import numpy as np

    pos = 8
    idat = b""
    width = height = None
    bit_depth = color_type = None
    palette = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            width, height = struct.unpack_from(">II", body)
            bit_depth, color_type, _, _, interlace = body[8:13]
            if interlace:
                raise FlacError("interlaced PNG unsupported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat += body
        elif ctype == b"IEND":
            break
        pos += 8 + length + 4
    if bit_depth != 8:
        raise FlacError(f"PNG bit depth {bit_depth} unsupported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = width * channels
    img = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for y in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride], dtype=np.uint8
                             ).astype(np.int32)
        off += 1 + stride
        out = np.zeros(stride, dtype=np.int32)
        for i in range(stride):
            a = out[i - channels] if i >= channels else 0
            b = int(prev[i])
            c = int(prev[i - channels]) if i >= channels else 0
            if ftype == 0:
                val = line[i]
            elif ftype == 1:
                val = line[i] + a
            elif ftype == 2:
                val = line[i] + b
            elif ftype == 3:
                val = line[i] + (a + b) // 2
            else:
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                val = line[i] + pred
            out[i] = val & 0xFF
        img[y] = out
        prev = img[y]
    img = img.reshape(height, width, channels)
    if color_type == 3 and palette is not None:
        img = palette[img[:, :, 0]]
    elif channels == 1:
        img = np.repeat(img, 3, axis=2)
    elif channels == 2:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    elif channels == 4:
        img = img[:, :, :3]
    return img


def render_ansi(img, max_width: int = 80) -> str:
    """Half-block truecolor terminal rendering."""
    import numpy as np

    h, w, _ = img.shape
    if w > max_width:
        step = (w + max_width - 1) // max_width
        img = img[::step, ::step]
        h, w, _ = img.shape
    if h % 2:
        img = np.vstack([img, np.zeros((1, w, 3), dtype=img.dtype)])
        h += 1
    lines = []
    for y in range(0, h, 2):
        row = []
        for x in range(w):
            tr, tg, tb = img[y, x]
            br, bg, bb = img[y + 1, x]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                       f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-view-artwork")
    p.add_argument("input")
    p.add_argument("--save", default=None, help="write image to file instead")
    p.add_argument("--width", type=int, default=80)
    args = p.parse_args(argv)

    pic = meta.read_block(args.input, meta.Picture)
    if pic is None:
        print("no PICTURE block", file=sys.stderr)
        return 1
    if args.save:
        with open(args.save, "wb") as fp:
            fp.write(pic.data)
        print(f"wrote {args.save} ({pic.mime_type}, "
              f"{pic.width}x{pic.height})")
        return 0
    if pic.mime_type == "image/png":
        print(render_ansi(_decode_png(pic.data), args.width))
        return 0
    print(f"{pic.mime_type} artwork {pic.width}x{pic.height} "
          f"({len(pic.data)} bytes); use --save FILE to extract",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
