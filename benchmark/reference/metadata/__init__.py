# Frozen copy of flac_codec_tpu_torch/metadata/__init__.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Metadata layer: block list IO + in-place update machinery
(reference: src/metadata/mod.rs:481-1494).
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Callable, Iterable, List, Optional, Type

from ..errors import (
    DuplicateIcon,
    InvalidBlockLength,
    InvalidBlockType,
    MissingFlacTag,
    MissingStreaminfo,
    MultipleSeekTable,
    MultipleStreaminfo,
    MultipleVorbisComment,
)
from .blocks import (  # noqa: F401
    APPLICATION,
    BLOCK_CLASSES,
    CUESHEET,
    MAX_BLOCK_SIZE,
    PADDING,
    PICTURE,
    SEEKTABLE,
    STREAMINFO,
    VORBIS_COMMENT,
    Application,
    Cuesheet,
    CuesheetTrack,
    Padding,
    Picture,
    SeekPoint,
    SeekTable,
    Streaminfo,
    VorbisComment,
    fields,
)

FLAC_TAG = b"fLaC"

# Block types that may appear at most once (reference BlockIterator
# invariants: src/metadata/mod.rs:513-552).
_UNIQUE_TYPES = {STREAMINFO, SEEKTABLE, VORBIS_COMMENT}


class BlockList:
    """STREAMINFO + ordered optional blocks (reference:
    src/metadata/mod.rs:4348-4762)."""

    def __init__(self, streaminfo: Streaminfo,
                 blocks: Optional[Iterable] = None):
        self.streaminfo = streaminfo
        self.blocks: List = list(blocks or [])

    # -- typed access -------------------------------------------------------

    def get(self, cls: Type):
        if cls is Streaminfo:
            return self.streaminfo
        for b in self.blocks:
            if isinstance(b, cls):
                return b
        return None

    def get_all(self, cls: Type) -> List:
        if cls is Streaminfo:
            return [self.streaminfo]
        return [b for b in self.blocks if isinstance(b, cls)]

    def insert(self, block) -> None:
        """Insert; replaces in place if the type must be unique
        (reference: BlockList::insert)."""
        if isinstance(block, Streaminfo):
            self.streaminfo = block
            return
        if block.TYPE in _UNIQUE_TYPES:
            for i, b in enumerate(self.blocks):
                if b.TYPE == block.TYPE:
                    self.blocks[i] = block
                    return
        self.blocks.append(block)

    def remove(self, cls: Type) -> None:
        self.blocks = [b for b in self.blocks if not isinstance(b, cls)]

    def extract(self, cls: Type):
        """Remove and return the first block of the given type."""
        for i, b in enumerate(self.blocks):
            if isinstance(b, cls):
                return self.blocks.pop(i)
        return None

    def update(self, cls: Type, f: Callable) -> None:
        """Apply ``f`` to the first block of type ``cls``, creating a
        default one if absent (reference: BlockList::update)."""
        b = self.get(cls)
        if b is None:
            b = cls()
            self.insert(b)
        f(b)

    def sort_by(self, key) -> None:
        self.blocks.sort(key=key)

    def all_blocks(self) -> List:
        return [self.streaminfo, *self.blocks]

    def __eq__(self, other):
        return (isinstance(other, BlockList)
                and self.all_blocks() == other.all_blocks())


def _validate_sequence(blocks: List) -> None:
    seen_types = set()
    seen_png_icon = False
    seen_general_icon = False
    for b in blocks:
        t = b.TYPE
        if t in _UNIQUE_TYPES and t in seen_types:
            raise {STREAMINFO: MultipleStreaminfo,
                   SEEKTABLE: MultipleSeekTable,
                   VORBIS_COMMENT: MultipleVorbisComment}[t]()
        seen_types.add(t)
        if isinstance(b, Picture):
            if b.picture_type == Picture.PNG_ICON:
                if seen_png_icon:
                    raise DuplicateIcon("32x32 PNG icon")
                seen_png_icon = True
            elif b.picture_type == Picture.GENERAL_ICON:
                if seen_general_icon:
                    raise DuplicateIcon("general file icon")
                seen_general_icon = True


def read_blocks(fp: BinaryIO) -> BlockList:
    """Read the fLaC tag + all metadata blocks, enforcing ordering
    invariants (reference: src/metadata/mod.rs:554-700 free functions)."""
    if fp.read(4) != FLAC_TAG:
        raise MissingFlacTag()
    blocks = []
    last = False
    first = True
    while not last:
        header = fp.read(4)
        if len(header) != 4:
            raise InvalidBlockLength("truncated block header")
        last = bool(header[0] & 0x80)
        btype = header[0] & 0x7F
        size = int.from_bytes(header[1:4], "big")
        body = fp.read(size)
        if len(body) != size:
            raise InvalidBlockLength("truncated block body")
        if first and btype != STREAMINFO:
            raise MissingStreaminfo()
        if not first and btype == STREAMINFO:
            raise MultipleStreaminfo()
        first = False
        if btype == 127:
            raise InvalidBlockType("invalid type 127")
        cls = BLOCK_CLASSES.get(btype)
        if cls is None:
            raise InvalidBlockType(f"reserved type {btype}")
        blocks.append(cls.from_bytes(body))
    _validate_sequence(blocks)
    if not blocks:
        raise MissingStreaminfo()
    return BlockList(blocks[0], blocks[1:])


def write_blocks(fp: BinaryIO, blocklist: BlockList) -> int:
    """Write fLaC tag + blocks; returns bytes written (reference:
    src/metadata/mod.rs:904-976 re-validates the same invariants)."""
    blocks = blocklist.all_blocks()
    _validate_sequence(blocks)
    out = bytearray(FLAC_TAG)
    for i, b in enumerate(blocks):
        body = b.to_bytes()
        if len(body) > MAX_BLOCK_SIZE:
            raise InvalidBlockLength(f"block size {len(body)}")
        flag = 0x80 if i == len(blocks) - 1 else 0
        out += bytes([flag | b.TYPE]) + len(body).to_bytes(3, "big")
        out += body
    fp.write(bytes(out))
    return len(out)


def serialized_len(blocklist: BlockList) -> int:
    buf = io.BytesIO()
    return write_blocks(buf, blocklist)


def read_info(path: str) -> Streaminfo:
    with open(path, "rb") as fp:
        return read_blocks(fp).streaminfo


def info(fp: BinaryIO) -> Streaminfo:
    return read_blocks(fp).streaminfo


def blocks_of(path: str, cls: Type) -> List:
    with open(path, "rb") as fp:
        return read_blocks(fp).get_all(cls)


def block(fp: BinaryIO, cls: Type):
    return read_blocks(fp).get(cls)


def read_block(path: str, cls: Type):
    with open(path, "rb") as fp:
        return read_blocks(fp).get(cls)


# ---------------------------------------------------------------------------
# In-place update machinery (reference: src/metadata/mod.rs:978-1297)
# ---------------------------------------------------------------------------

def update(path: str, f: Callable[[BlockList], None]) -> None:
    """Read blocks from ``path``, apply ``f``, and write back — in place
    when PADDING can absorb the size change, else rebuilding the file.

    Example (mirrors the reference's metadata::update doc,
    src/metadata/mod.rs:988-1006):

    >>> import io, tempfile, os
    >>> from benchmark.reference import metadata as meta
    >>> from benchmark.reference.encode import FlacSampleWriter, Options
    >>> fd, path = tempfile.mkstemp(suffix=".flac"); os.close(fd)
    >>> with FlacSampleWriter(path, Options().with_block_size(16)
    ...                       .no_seektable().overwrite(), 44100, 16, 1,
    ...                       total_samples=16) as w:
    ...     w.write(list(range(16)))
    >>> def set_title(blocks):
    ...     blocks.update(meta.VorbisComment,
    ...                   lambda vc: vc.set("TITLE", "doctest"))
    >>> meta.update(path, set_title)
    >>> meta.read_block(path, meta.VorbisComment).get("TITLE")
    'doctest'
    >>> os.unlink(path)
    """

    def rebuilt(blocklist: BlockList, old_metadata_len: int) -> None:
        tmp = path + ".flac-tmp"
        with open(path, "rb") as src, open(tmp, "wb") as dst:
            write_blocks(dst, blocklist)
            src.seek(old_metadata_len)
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                dst.write(chunk)
        os.replace(tmp, path)

    update_file(path, rebuilt, f)


def update_file(path: str,
                rebuilt: Callable[[BlockList, int], None],
                f: Callable[[BlockList], None]) -> None:
    with open(path, "rb") as fp:
        blocklist = read_blocks(fp)
        old_len = fp.tell()

    f(blocklist)

    new_len = serialized_len(blocklist)

    if new_len < old_len:
        # grow first PADDING (or add one) to keep frame offsets unchanged;
        # a padding body is capped at 2^24-1 bytes, past that rebuild
        delta = old_len - new_len
        pad = blocklist.get(Padding)
        if pad is not None and pad.size + delta < (1 << 24):
            pad.size += delta
            new_len = old_len
        elif pad is None and 4 <= delta and delta - 4 < (1 << 24):
            blocklist.blocks.append(Padding(delta - 4))
            new_len = old_len

    if new_len == old_len:
        with open(path, "r+b") as fp:
            write_blocks(fp, blocklist)
        return

    if new_len > old_len:
        # try shrinking PADDING to fit
        delta = new_len - old_len
        pad = blocklist.get(Padding)
        if pad is not None and pad.size >= delta:
            pad.size -= delta
            with open(path, "r+b") as fp:
                write_blocks(fp, blocklist)
            return

    rebuilt(blocklist, old_len)
