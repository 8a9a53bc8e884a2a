"""The program's own spans in a profiler capture, reduced per span.

mayamatchmovesolver_torch/utils/profiler.py::span opens a host range
"mmsolver.<span>" at a layer boundary while its tracing() is on, on the
profiler's clock with the CUDA kernels.  reduce() gives each span name:

    idle_s     device-idle seconds while a range of that name is open,
               over the union of the name's ranges inside the requests
    busy_s     device-busy seconds over the same union
    launches   kernel-launch runtime calls inside each range, on its
               thread, one count a range

A capture also records a device-side copy of every range that encloses
device work; trace.reduce counts what it is given as device operations,
so it gets the capture without_program_ranges().
"""

import bisect
import re
from collections import defaultdict

from torch.autograd import DeviceType

from mmbench.common.trace import REQUEST_RANGE, _union

PREFIX = "mmsolver."
RANGES = ("mmbench.", PREFIX)
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")


def _cuda(event):
    return event.device_type == DeviceType.CUDA


def without_program_ranges(events):
    """The events less the device-side copies of the program's ranges."""
    return [e for e in events if not (_cuda(e) and e.name.startswith(PREFIX))]


def _intersect(a, b):
    """The intersection of two sorted lists of disjoint [start, end]."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length_s(intervals):
    return sum(end - start for start, end in intervals) * 1e-6


def reduce(events):
    """{span: {"idle_s", "busy_s", "launches"}} of a list of profiler
    FunctionEvents (times in us); {} where the capture holds no program
    range inside a request."""
    device, requests = [], []
    ranges, launches = defaultdict(list), defaultdict(list)
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if _cuda(e):
            if not e.name.startswith(RANGES):
                device.append(span)
        elif e.name == REQUEST_RANGE:
            requests.append(span)
        elif e.name.startswith(PREFIX):
            ranges[e.name[len(PREFIX):]].append((e.thread, *span))
        elif LAUNCH.match(e.name):
            launches[e.thread].append(span[0])
    busy, requests = _union(device), _union(requests)
    for starts in launches.values():
        starts.sort()

    out = {}
    for name, opened in sorted(ranges.items()):
        inside = _intersect(_union((a, b) for _, a, b in opened), requests)
        if not inside:
            continue
        busy_s = _length_s(_intersect(inside, busy))
        counts = []
        for thread, start, end in opened:
            starts = launches.get(thread, [])
            counts.append(bisect.bisect_right(starts, end)
                          - bisect.bisect_left(starts, start))
        out[name] = {"idle_s": _length_s(inside) - busy_s, "busy_s": busy_s,
                     "launches": counts}
    return out
