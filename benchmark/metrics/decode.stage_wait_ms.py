"""Host ms a batch blocks on the last copies out of the decoder's pinned
upload buffer before it reuses it: the mean of the window's
``decode.stage_wait`` spans (``FLAC_TPU_TRACE``), one a staged batch."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "decode.stage_wait")
