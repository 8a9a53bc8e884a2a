"""Profiling hooks.

Port of mayamatchmovesolver_tpu/utils/profiler.py.  The reference has
three tracing layers (SURVEY.md section 5): solver phase timers
(adjust_data.h:58-72), Maya MProfiler scopes, and Python cProfile per
test.  Here: wall-clock phase timers and cProfile (host code, copied),
plus a torch.profiler trace of the host and CUDA timeline in the place
of the reference's jax.profiler trace.
"""

import contextlib
import cProfile
import pstats
import time


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
    device is present, the kernels on it.  Named as the reference's
    jax.profiler capture, whose role it takes."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
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
