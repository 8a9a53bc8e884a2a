"""Share of a request's wall time in which no operation ran on the
device, in percent: the device's busy seconds a unit of work in the
profiled pass over the wall seconds a unit of the plain pass."""

from mmbench.common import readers


def read(records):
    return readers.idle_pct(records)
