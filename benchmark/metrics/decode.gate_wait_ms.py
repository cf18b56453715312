"""Host ms a device-parse batch blocks on the parse gate's download
(K4's result): the mean of the window's ``decode.gate_wait`` spans
(``FLAC_TPU_TRACE``), one a batch the device parse took up."""

from benchmark.harness.readers import stage_ms


def read(data):
    return stage_ms(data, "decode.gate_wait")
