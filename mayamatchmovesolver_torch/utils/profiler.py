"""Profiling hooks.

Port of mayamatchmovesolver_tpu/utils/profiler.py.  The reference has
three tracing layers (SURVEY.md section 5): solver phase timers
(adjust_data.h:58-72), Maya MProfiler scopes, and Python cProfile per
test.  Here: wall-clock phase timers and cProfile (host code, copied),
plus a torch.profiler trace of the host and CUDA timeline in the place
of the reference's jax.profiler trace.

The program's own instrumentation lives here too, one of each kind:

  span(name)  a host range "mmsolver.<name>" at a layer boundary.  Off
              (the default) it costs one flag test and returns a shared
              no-op context; under tracing() it is a
              torch.profiler.record_function, so a running profiler
              capture holds it on the same clock as the CUDA kernels,
              nested in the spans and ranges around it.
  tracing()   turns spans on for its block; xla_trace enters it.
  kernel_op(name)
              a hand kernel's launch as an operator of its own, as each
              aten op is: under a running torch.profiler capture a
              record of the profiler's operator scope, whatever tracing()
              says, so the profiler puts the kernel down to it and its
              device time to the ranges around it (a span or a caller's
              record_function, of the user scope, gets none of a kernel
              launched outside an operator); a shared no-op otherwise.
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


class _Off:
    """The span of tracing off, a context that does nothing.  Its methods
    are a bound builtin, which the with statement calls as it is, with no
    Python frame: an empty format string ignores its arguments and
    returns '', which is false, so an exception passes through."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


def span(name):
    """A profiler range "mmsolver.<name>" around a block while tracing()
    is on; a shared no-op context otherwise."""
    if not _tracing:
        return _OFF
    return torch.profiler.record_function("mmsolver." + name)


def kernel_op(name):
    """The launch of the hand kernel `name` as an operator record under a
    running torch.profiler capture; a shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


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
