"""Device ms a replay of the reconstruct graph (``ReconstructGraph.replay``:
K3 or the FIXED path, the wasted-bits shift and the stereo
decorrelation), from the profiled stretch."""

from benchmark.harness.readers import graph_ms

RANGES = {"graph.reconstruct":
          "flac_codec_tpu_torch.parallel.batch_decode:ReconstructGraph.replay"}


def read(data):
    return graph_ms(data, "graph.reconstruct")
