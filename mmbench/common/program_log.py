"""The program's span log over the traced run's profiled frames: host
time by layer.

While a torch.profiler capture runs, each of the program's spans
(mayamatchmovesolver_torch/utils/profiler.py::span) appends (name,
start, end) to an in-memory log, on time.perf_counter(), the clock of
the harness's Request.start and end.  Only the profiled pass runs under
a capture.  Each ok request of records.profiled takes the log's entries
that lie inside it; an entry across two requests is in neither.  A
request's top-level entries are those inside no other of its entries.
For each request that holds an entry, frame_ms() gives

    <span name>  the summed milliseconds of its top-level entries of
                 that name
    OUTSIDE      the milliseconds from the request's start to the end of
                 its last top-level entry, less their union: the client's
                 and the harness's own host work while issuing the frame
                 (the frame's closing synchronise is left out)

so that, where the top-level entries are disjoint, the names' sums and
OUTSIDE add up to the request's start to its last entry's end.  A
program that keeps no log gives nothing.
"""

import bisect

from mmbench.common import readers
from mmbench.common.trace import _union

OUTSIDE = "outside"


def program_log():
    """The program's log, or None where it keeps none."""
    from mayamatchmovesolver_torch.utils import profiler

    read = getattr(profiler, "span_log", None)
    return None if read is None else read()


def _top_level(entries):
    """The entries inside no other, in order of their start."""
    top, reach = [], None
    for entry in sorted(entries, key=lambda e: (e[1], -e[2])):
        if reach is None or entry[2] > reach:
            top.append(entry)
            reach = entry[2]
    return top


def frame_ms(records, log=None):
    """[{span name: ms, OUTSIDE: ms}] of each ok profiled request that
    holds a logged entry, in request order; None where the program keeps
    no log.  `log` stands in for the program's."""
    if log is None:
        log = program_log()
        if log is None:
            return None
    entries = sorted(log, key=lambda e: e[1])
    starts = [e[1] for e in entries]
    frames = []
    for request in records.profiled:
        if not request.ok:
            continue
        lo = bisect.bisect_left(starts, request.start)
        hi = bisect.bisect_right(starts, request.end)
        inside = [e for e in entries[lo:hi] if e[2] <= request.end]
        if not inside:
            continue
        top = _top_level(inside)
        frame = {}
        for name, start, end in top:
            frame[name] = frame.get(name, 0.0) + (end - start) * 1e3
        last = max(e[2] for e in top)
        covered = sum(b - a for a, b in _union((s, e) for _, s, e in top))
        frame[OUTSIDE] = (last - request.start - covered) * 1e3
        frames.append(frame)
    return frames


def median_ms(records, key, log=None):
    """The median over the profiled frames that hold `key` (a span name
    or OUTSIDE) of its milliseconds; None where none does."""
    frames = frame_ms(records, log) or []
    return readers.median([f[key] for f in frames if key in f])
