"""Device ms a replay of the parse graph (``ParseGraph.replay``: K4 and
the parse gate), from the profiled stretch."""

from benchmark.harness.readers import graph_ms

RANGES = {"graph.parse": "flac_codec_tpu_torch.ops.framescan:ParseGraph.replay"}


def read(data):
    return graph_ms(data, "graph.parse")
