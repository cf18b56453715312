"""The share (%) of the profiled stretch of whole requests in which no
device event (kernel, copy, set) ran: 1 - busy / window."""

from benchmark.harness.readers import idle_pct


def read(data):
    return idle_pct(data)
