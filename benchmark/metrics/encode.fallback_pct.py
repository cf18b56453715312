"""Frames the host re-encoded (``BatchEncoder.fallback_frames``) as a
share (%) of the frames the device planned (``device_frames``), over the
window's tracks."""


def read(data):
    c = data["counters"]
    if not c.get("device_frames"):
        return None
    return 100.0 * c["fallback_frames"] / c["device_frames"]
