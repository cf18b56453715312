"""Host ms a stream takes to open in a multi-stream decode: its metadata
and the rest of it as one buffer, the mean of the window's
``decode.open`` spans (``FLAC_TPU_TRACE``; ``MultiStreamDecoder``, one a
stream)."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "decode.open")
