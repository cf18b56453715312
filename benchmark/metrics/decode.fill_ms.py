"""Host ms a track takes to pull its stream into the reader's buffer:
the mean of the window's ``decode.fill`` spans (``FLAC_TPU_TRACE``;
``BitReader.fill_to_eof``, once a track)."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "decode.fill")
