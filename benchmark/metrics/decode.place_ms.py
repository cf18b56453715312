"""Host ms a multi-stream decode takes to place its streams' tails and
lengths: the mean of the window's ``decode.place`` spans
(``FLAC_TPU_TRACE``; ``MultiStreamDecoder``, one a call: the upload of
the tails and lengths in one copy, and the tails' index copy)."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "decode.place")
