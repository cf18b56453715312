"""Host ms a batch of the program's ``encode.assemble`` stage span
(``FLAC_TPU_TRACE``): the sum of the window's spans over the batches
that emitted them."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "encode.assemble")
