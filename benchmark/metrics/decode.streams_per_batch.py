"""Streams a device-parse batch holds frames of, over the window: the
sum over device batches of the streams each holds frames of
(``MultiStreamDecoder.batch_streams``) over the device batches
(``device_batches``); nothing where the program counts neither."""


def read(data):
    c = data["counters"]
    if not c.get("device_batches") or "batch_streams" not in c:
        return None
    return c["batch_streams"] / c["device_batches"]
