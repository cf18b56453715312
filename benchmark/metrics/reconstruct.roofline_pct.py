"""The reconstruction's least time as a share (%) of its device time
over the profiled stretch.  Bytes by the layer's work, for the frames
reconstructed on the device: 4 bytes read once for each residual sample
and 4 written once for each PCM sample (int32, as ``read_batch_device``
returns it).  The operation count (order multiply-adds a sample, at the
configuration's largest order) is printed beside it."""

from benchmark.harness.readers import HBM_BYTES_PER_S, INT32_OPS, roofline_pct

RANGES = {"graph.reconstruct":
          "flac_codec_tpu_torch.parallel.batch_decode:ReconstructGraph.replay"}


def nbytes(data):
    return 8 * data["work"].get("samples", 0)


def read(data):
    return roofline_pct(data, "graph.reconstruct", nbytes(data))


def explain(data):
    n = data["work"].get("samples")
    if not n:
        return None
    ops = 2 * n * data["cfg"]["max_lpc_order"]
    return (f"{nbytes(data):.0f} bytes ({nbytes(data) / HBM_BYTES_PER_S * 1e6:.3f} us "
            f"at 3.35 TB/s, the bound used); at most {ops} integer ops "
            f"({ops / INT32_OPS * 1e6:.3f} us at 33.5 TOP/s)")
