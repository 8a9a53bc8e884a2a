"""What a run records for the metric readers: its requests, the
benchmark's own spans around its calls into the program, and the
reduced profiler trace."""

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Optional

import torch


class Recorder:
    """Host spans of the benchmark's calls into the program.  Inactive
    (the measured window) it does nothing.  Active, each span is a
    profiler range 'mmbench.<name>' and its host seconds are kept; with
    `synchronize` the device is idle when a span starts, so the span is
    the call's own host time."""

    def __init__(self, active=False, synchronize=None):
        self.active = active
        self.synchronize = synchronize
        self.spans = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name):
        if not self.active:
            yield
            return
        if self.synchronize is not None:
            self.synchronize()
        start = time.perf_counter()
        with torch.profiler.record_function("mmbench." + name):
            yield
        self.spans[name].append(time.perf_counter() - start)


@dataclasses.dataclass
class Request:
    start: float  # host seconds
    end: float
    units: int  # the work it completed: iterations, frames
    ok: bool


@dataclasses.dataclass
class Records:
    """Everything a metric reader may read.  `requests` and `window_s`
    are the measured window's (trace 0) or the traced passes' (trace 1);
    the traced run's `plain` requests ran as in the window, `spans` come
    from its second pass, `trace` and the `profiled` requests from its
    third."""

    requests: list
    window_s: float
    spans: dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None
    plain: list = dataclasses.field(default_factory=list)
    profiled: list = dataclasses.field(default_factory=list)
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
