"""Host milliseconds of a call of ops/stmap.py::stmap, the device idle
when it starts: the median of the benchmark's spans."""

from mmbench.common import readers


def read(records):
    return readers.span_ms(records, "stmap")
