"""What the metric readers (metrics/<name>.py) share.  A reader that
finds nothing to read returns None, and the metric is left out."""

import math
import re
import statistics

from mmbench.common import peaks


def median(values):
    return statistics.median(values) if values else None


def percentile(values, share):
    """The nearest-rank percentile: the smallest value with at least
    `share` of the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(share * len(ordered)) - 1)]


def latencies(records):
    """Each request's seconds; a failed request never met any limit."""
    return [r.end - r.start if r.ok else math.inf for r in records.requests]


def units(requests):
    return sum(r.units for r in requests if r.ok)


def idle_pct(records):
    """Share of a request's wall time with no operation on the device:
    the device's busy seconds a unit of work under the profiler, over
    the wall seconds a unit of the plain pass (the profiler slows the
    host, not the device)."""
    tr = records.trace
    busy_units, wall_units = units(records.profiled), units(records.plain)
    if tr is None or tr.busy_s <= 0.0 or not busy_units or not wall_units:
        return None
    wall = sum(r.end - r.start for r in records.plain)
    return 100.0 * (1.0 - (tr.busy_s / busy_units) / (wall / wall_units))


def span_ms(records, name):
    value = median(records.spans.get(name, []))
    return None if value is None else value * 1e3


def range_device_ms(records, name):
    if records.trace is None:
        return None
    value = median(records.trace.ranges.get("mmbench." + name, []))
    return value * 1e3 if value else None


# stmap_kernel<CORE, DISTORT, FROM_MAP> of csrc/stmap.cu, as the profiler
# names its instantiations.
_STMAP_KERNEL = re.compile(
    r"stmap_kernel<\s*\(?(\d+)\)?\s*,\s*(true|false|1|0)\s*,\s*(true|false|1|0)\s*>")
_CORES = {0: "TdeClassic", 1: "TdeRadialStdDeg4", 2: "TdeAnamorphicStdDeg4"}


def stmap_roofline_pct(records, width, height):
    """The least time the ST-map launches could take (peaks.stmap_bound
    of each) over the time they took, in percent."""
    if records.trace is None:
        return None
    bound = taken = 0.0
    for name, seconds in records.trace.kernels:
        m = _STMAP_KERNEL.search(name)
        if not m:
            continue
        direction = "distort" if m.group(2) in ("true", "1") else "undistort"
        from_map = m.group(3) in ("true", "1")
        bound += peaks.stmap_bound(_CORES[int(m.group(1))], direction,
                                   width, height, from_map)[0]
        taken += seconds
    return 100.0 * bound / taken if taken > 0.0 else None
