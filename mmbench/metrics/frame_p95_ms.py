"""The 95th percentile of every frame's latency in the window, in
milliseconds; a failed frame counts as missing every limit."""

from mmbench.common import readers


def read(records):
    value = readers.percentile(readers.latencies(records), 0.95)
    return None if value is None else value * 1e3
