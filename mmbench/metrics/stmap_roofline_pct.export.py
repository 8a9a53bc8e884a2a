"""The ST-map kernel's share of its roofline: the frozen bound
(common/peaks.py) of every launch over the launches' device time in
the profiler, in percent."""

from mmbench.common import readers


def read(records):
    width, height = records.config["plate"]
    return readers.stmap_roofline_pct(records, width, height)
