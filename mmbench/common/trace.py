"""The profiler window of a traced run and its reduction to what the
metric readers and the result's breakdown need."""

import bisect
import dataclasses
import time
from collections import defaultdict

REQUEST_RANGE = "mmbench.request"
# Gaps labelled by what the host was doing, longest first; the rest are
# summed as one entry.
LABELLED_GAPS = 2000
GAP_SCAN = 4000
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float  # host clock, device synchronised at both ends
    busy_s: float  # union of the device's operations
    kernels: list  # (name, seconds) of every device operation
    ranges: dict  # 'mmbench.<name>' -> [device seconds of each range]
    device_ops: list  # [[name, seconds]] most time first
    idle_gaps: list  # [[what the host was doing, seconds]] most first


def profiled(fn, synchronize, cuda=True):
    """fn() under torch.profiler (host and, with `cuda`, CUDA activity);
    returns (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    synchronize()
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        out = fn()
        synchronize()
        window = time.perf_counter() - start
    return out, reduce(prof.events(), window)


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _short(name):
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce(events, window_s):
    """Trace of a list of profiler FunctionEvents (times in us)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            host.append(e)
        elif not e.name.startswith("mmbench."):  # a range's device span
            device.append(e)
    kernels = [(e.name, (e.time_range.end - e.time_range.start) * 1e-6)
               for e in device]
    merged = _union((e.time_range.start, e.time_range.end) for e in device)
    busy_us = sum(end - start for start, end in merged)
    ranges = defaultdict(list)
    for e in host:
        if e.name.startswith("mmbench."):
            ranges[e.name].append(e.device_time_total * 1e-6)

    by_name = defaultdict(float)
    for name, seconds in kernels:
        by_name[name] += seconds
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    device_ops = [[_short(n), s] for n, s in device_ops[:BREAKDOWN_ENTRIES]]

    return Trace(window_s=window_s, busy_s=busy_us * 1e-6, kernels=kernels,
                 ranges=dict(ranges), device_ops=device_ops,
                 idle_gaps=_idle_gaps(host, merged))


def _idle_gaps(host, merged):
    """Idle stretches of the device inside the requests, summed by the
    innermost host call running at their midpoint ('python' where the
    host ran no profiled call)."""
    requests = [e for e in host if e.name == REQUEST_RANGE]
    if not requests:
        return []
    thread = requests[0].thread
    lo = min(e.time_range.start for e in requests)
    hi = max(e.time_range.end for e in requests)
    gaps, cursor = [], lo
    for start, end in merged:
        if start > cursor:
            gaps.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])

    calls = sorted((e for e in host if e.thread == thread
                    and not e.name.startswith("mmbench.")),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in calls]
    totals = defaultdict(float)
    for n, (a, b) in enumerate(gaps):
        if n >= LABELLED_GAPS:
            totals["shorter gaps"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        label = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - GAP_SCAN, -1), -1):
            if calls[j].time_range.end >= mid:
                label = calls[j].name
                break
        totals[_short(label)] += (b - a) * 1e-6
    ordered = sorted(totals.items(), key=lambda kv: -kv[1])
    return [[n, s] for n, s in ordered[:BREAKDOWN_ENTRIES]]
