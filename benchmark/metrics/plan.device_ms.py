"""Device ms a replay of the plan graph (``PlanGraph.replay``: the PCM
copy in, the planner and the packer), from the profiled stretch.  The
card replays graphs in a fast or a slow state, ~0.35 us a kernel apart
(PERF.md); the traced run prints the null graph's us a kernel beside
it."""

from benchmark.harness.readers import graph_ms

RANGES = {"graph.plan": "flac_codec_tpu_torch.ops.encode_batch:PlanGraph.replay"}


def read(data):
    return graph_ms(data, "graph.plan")


def explain(data):
    if data.get("null_us") is None:
        return None
    return f"null graph {data['null_us']:.4f} us a kernel in this run"
