"""The plan layer's least time as a share (%) of its device time over
the profiled stretch.  Bytes by the layer's work, for the real frames
only: the PCM read once at the dtype the batch is handed over (int16 up
to 16 bits, int32 above) and the FLAC frame bytes written once.  The
least time is the bytes at the HBM rate; the operation count (the FP64
autocorrelation of each analysed channel, order + 1 lags) and the time
it would take at the FP64 peak are printed beside it."""

from benchmark.harness.readers import (FP64_FLOPS, HBM_BYTES_PER_S,
                                       roofline_pct)

RANGES = {"graph.plan": "flac_codec_tpu_torch.ops.encode_batch:PlanGraph.replay"}


def nbytes(data):
    w = data["work"]
    return w.get("plan_bytes_in", 0) + w.get("plan_bytes_out", 0)


def flops(data):
    cfg = data["cfg"]
    # stereo analyses left, right, mid and side; other widths each channel
    analysed = 4 if cfg["channels"] == 2 else cfg["channels"]
    return (2.0 * data["work"].get("plan_frames", 0) * analysed
            * cfg["block_size"] * (cfg["max_lpc_order"] + 1))


def read(data):
    return roofline_pct(data, "graph.plan", nbytes(data))


def explain(data):
    if not data["work"].get("plan_frames"):
        return None
    return (f"{nbytes(data):.0f} bytes ({nbytes(data) / HBM_BYTES_PER_S * 1e6:.3f} us "
            f"at 3.35 TB/s, the bound used); {flops(data):.0f} FP64 flops "
            f"({flops(data) / FP64_FLOPS * 1e6:.3f} us at 67 TFLOP/s) over "
            f"{data['work']['plan_frames']} frames")
