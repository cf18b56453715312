"""Host ms a ``BatchDecoder.read_batch_device`` call spends outside its
child spans: the mean of the window's ``decode.read.self`` records
(``FLAC_TPU_TRACE``), one a call, the call that returns None at the end
of each track included."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "decode.read.self")
