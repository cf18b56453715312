"""Batches the device parse handed to the host parse
(``BatchDecoder.parse_fallbacks``) as a share (%) of the batches the
device parse took up (those it parsed and those it handed over), over
the window's tracks."""


def read(data):
    c = data["counters"]
    tried = c.get("device_batches", 0) + c.get("parse_fallbacks", 0)
    if not tried:
        return None
    return 100.0 * c["parse_fallbacks"] / tried
