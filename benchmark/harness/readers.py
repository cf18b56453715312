"""Arithmetic the per-layer metric files share: the card's peaks and the
readings of stage spans, graph ranges and the stretch's busy time."""

from __future__ import annotations

# NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 67e12
INT32_OPS = 33.5e12


def stage_ms(data: dict, stage: str):
    """The mean ms of the window's ``stage`` spans (sum over the batches
    that emitted them), or None where none was emitted."""
    ms = data["spans"].get(stage)
    return sum(ms) / len(ms) if ms else None


def graph(data: dict, label: str):
    """(device us, replays) of the stretch's ``label`` graph range, or
    None where it read nothing."""
    g = data["stretch"].get("graphs", {}).get(label)
    if not g or not g["calls"] or not g["us"]:
        return None
    return g["us"], g["calls"]


def graph_ms(data: dict, label: str):
    """Device ms a replay of the ``label`` graph."""
    g = graph(data, label)
    return None if g is None else g[0] / 1e3 / g[1]


def roofline_pct(data: dict, label: str, nbytes: float):
    """The least time of ``nbytes`` at the HBM rate, as a share (%) of
    the ``label`` graph's device time over the stretch."""
    g = graph(data, label)
    if g is None or not nbytes:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (g[0] / 1e6)


def idle_pct(data: dict):
    """The share (%) of the stretch in which no device event ran."""
    s = data["stretch"]
    if not s or not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
