"""Sources a port's reader fills from in its own ways, for the port's
tests: ``from torch_sources import open_as`` brings the fixture."""

import io

import pytest


class Unseekable(io.RawIOBase):
    """A pipe-like source: reads, and neither seeks nor tells."""

    def __init__(self, data: bytes):
        self._src = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, b):
        return self._src.readinto(b)


@pytest.fixture
def open_as(tmp_path):
    """``open_as(kind, data)``: ``data`` as a source of ``kind``:
    "bytesio" (an ``io.BytesIO``), "file" (a file on disk, opened to
    read) or "unseekable" (a buffered pipe-like reader).  The files are
    closed after the test."""
    opened = []

    def open_as(kind, data):
        if kind == "file":
            path = tmp_path / f"source{len(opened)}.bin"
            path.write_bytes(data)
            src = open(path, "rb")
        elif kind == "unseekable":
            src = io.BufferedReader(Unseekable(data))
        else:
            assert kind == "bytesio", kind
            src = io.BytesIO(data)
        opened.append(src)
        return src

    yield open_as
    for src in opened:
        src.close()
