"""The device parse's least time as a share (%) of its device time over
the profiled stretch.  Bytes by the layer's work, for the frames
reconstructed on the device: the frames' bytes read once, and 4 bytes
written once for each decoded residual sample (channels x block).  The
operation count (one Rice code each) is printed beside it."""

from benchmark.harness.readers import HBM_BYTES_PER_S, INT32_OPS, roofline_pct

RANGES = {"graph.parse": "flac_codec_tpu_torch.ops.framescan:ParseGraph.replay"}


def nbytes(data):
    w = data["work"]
    return w.get("frame_bytes", 0) + 4 * w.get("samples", 0)


def read(data):
    return roofline_pct(data, "graph.parse", nbytes(data))


def explain(data):
    n = data["work"].get("samples")
    if not n:
        return None
    return (f"{nbytes(data):.0f} bytes ({nbytes(data) / HBM_BYTES_PER_S * 1e6:.3f} us "
            f"at 3.35 TB/s, the bound used); {n} Rice codes "
            f"({n / INT32_OPS * 1e6:.3f} us at one INT32 op each, 33.5 TOP/s)")
