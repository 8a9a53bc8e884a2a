"""Profiling hooks.

Port of mayamatchmovesolver_tpu/utils/profiler.py.  The reference has
three tracing layers (SURVEY.md section 5): solver phase timers
(adjust_data.h:58-72), Maya MProfiler scopes, and Python cProfile per
test.  Here: wall-clock phase timers and cProfile (host code, copied),
plus a torch.profiler trace of the host and CUDA timeline in the place
of the reference's jax.profiler trace.

The program's own instrumentation lives here too:

  span(name)  a layer boundary, "mmsolver.<name>".  Off (no running
              torch.profiler capture and no tracing()) it costs one flag
              test and one profiler-state check and returns a shared
              no-op context.  Under a running capture, whatever tracing()
              says, it is an operator record, as an aten op is: the
              capture holds it on the CUDA kernels' clock, nested in the
              spans and ranges around it, with no device-side copy of its
              own, and a hand kernel launched inside it is put down to
              the innermost span, so its device time counts in every
              range around it.  Under tracing() with no capture it
              records nothing in any profiler.  While on, each span also
              appends (name, start, end), in time.perf_counter() seconds,
              to a bounded in-memory log (span_log()); a span's parent is
              the innermost logged span whose interval holds it.
  tracing()   turns spans on for its block; xla_trace enters it.
  counters    integers counted at the same boundaries, always on:
              "stmap.launches" and "stmap_layer.launches" (map kernel
              launches of ops/stmap.py's two C entry points, from the
              pixel index and from a map), "stmap.stack_launches" (those
              of them that map an undistort stack in one launch),
              "warp.launches" (kernel launches of ops/warp.py's; those
              of its half-image instantiation also in
              "warp.half_launches"),
              "host_reads" (device-to-host transfers of
              ops/stmap.py::_host_values) and "stmap.device_packs"
              (launches of csrc/stmap.cu's pack kernel, which folds a
              lens's fields on the card before its map launches).
"""

import collections
import contextlib
import cProfile
import pstats
import time

import torch

counters = collections.Counter()

_tracing = False
# The spans' log: (name, start, end) in time.perf_counter() seconds, the
# oldest dropped once it holds SPAN_LOG_LENGTH.
SPAN_LOG_LENGTH = 65536
_log = collections.deque(maxlen=SPAN_LOG_LENGTH)
_profiling = torch.autograd._profiler_enabled
_Record = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span of tracing off, a context that does nothing.  Its methods
    are a bound builtin, which the with statement calls as it is, with no
    Python frame: an empty format string ignores its arguments and
    returns '', which is false, so an exception passes through."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Span:
    """A span on: logged, and an operator record under a capture."""

    __slots__ = ("name", "record", "start")

    def __init__(self, name, record):
        self.name = name
        self.record = record

    def __enter__(self):
        self.start = time.perf_counter()
        if self.record is not None:
            self.record.__enter__()

    def __exit__(self, *exc):
        if self.record is not None:
            self.record.__exit__(*exc)
        _log.append((self.name, self.start, time.perf_counter()))


def span(name):
    """The layer boundary `name` around a block: while a torch.profiler
    capture runs, an operator record "mmsolver.<name>", and logged; under
    tracing() alone, logged only; a shared no-op context otherwise."""
    profiling = _profiling()
    if not (_tracing or profiling):
        return _OFF
    return _Span(name, _Record("mmsolver." + name) if profiling else None)


def span_log():
    """The spans logged so far, oldest first, as a list of (name, start,
    end) in time.perf_counter() seconds."""
    return list(_log)


@contextlib.contextmanager
def tracing():
    """Spans on for the block; the state before is restored after."""
    global _tracing
    previous, _tracing = _tracing, True
    try:
        yield
    finally:
        _tracing = previous


class PhaseTimer:
    """Accumulating named phase timer
    (ref: SolverTimer, adjust_data.h:58-72)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {
            name: {
                "total_seconds": self.totals[name],
                "count": self.counts[name],
                "mean_seconds": self.totals[name] / self.counts[name],
            }
            for name in sorted(self.totals)
        }


@contextlib.contextmanager
def xla_trace(log_dir):
    """Capture a torch.profiler trace of the block into log_dir: one
    `*.pt.trace.json` file (view with TensorBoard, Perfetto or
    chrome://tracing) holding the host activity and, where a CUDA
    device is present, the kernels on it, with the program's spans.
    Named as the reference's jax.profiler capture, whose role it
    takes."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing(), profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def python_profile(output_path=None, sort="cumulative", top=30):
    """cProfile a block like the reference's per-test .pstat capture
    (ref: tests/test/baseutils.py:52-60)."""
    profiler = cProfile.Profile()
    profiler.enable()
    try:
        yield profiler
    finally:
        profiler.disable()
        if output_path:
            profiler.dump_stats(output_path)
        else:
            pstats.Stats(profiler).sort_stats(sort).print_stats(top)
