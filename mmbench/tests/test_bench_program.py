"""The reduction of the program's own spans (common/program.py) on a
hand-built timeline; trace.reduce unchanged by them; and mmbench/spans.py
whole on the CPU at a small size."""

import pytest
import torch

from mmbench import spans
from mmbench.common import program, trace
from mmbench.tests._small import SEED, small_root
from mmbench.tests.test_bench_metrics import EVENTS, _event

# Two requests of 1000 us on thread 1; the device busy 200-350 and
# 1200-1320 us.  A wrapper call whose read waits on the device, a warp
# range in each request and one after them, a span outside every request,
# launch calls on the ranges' thread and on another.
TIMELINE = [
    _event("mmbench.request", 0, 1000),
    _event("mmbench.request", 1000, 2000),
    _event("mmbench.request", 0, 2000, device=True),
    _event("kernel a", 200, 300, device=True),
    _event("kernel b", 250, 350, device=True),
    _event("kernel c", 1200, 1320, device=True),
    _event("mmsolver.stmap.call", 100, 400),
    _event("mmsolver.stmap.call", 200, 350, device=True),
    _event("mmsolver.stmap.host_read", 155, 260),
    _event("mmsolver.warp.call", 1100, 1400),
    _event("mmsolver.warp.call", 1200, 1320, device=True),
    _event("mmsolver.warp.call", 1900, 2100),
    _event("mmsolver.solve.iteration", 3000, 3100),
    _event("cudaLaunchKernel", 150, 160),
    _event("cudaLaunchKernel", 1150, 1160),
    _event("cuLaunchKernelEx", 1170, 1180),
    _event("cudaLaunchKernel", 1175, 1185, thread=2),
    _event("cudaLaunchKernel", 1950, 1960),
    _event("cudaMemcpyAsync", 240, 250),
]


def test_program_reduce():
    got = program.reduce(TIMELINE)
    assert sorted(got) == ["stmap.call", "stmap.host_read", "warp.call"]
    want = {"stmap.call": (150, 150, [1]),
            "stmap.host_read": (45, 60, [0]),
            # 1100-1400 and 1900-2000 inside the requests
            "warp.call": (280, 120, [2, 1])}
    for name, (idle_us, busy_us, launches) in want.items():
        assert got[name]["idle_s"] == pytest.approx(idle_us * 1e-6), name
        assert got[name]["busy_s"] == pytest.approx(busy_us * 1e-6), name
        assert got[name]["launches"] == launches, name


def test_program_reduce_without_program_ranges_is_empty():
    assert program.reduce(EVENTS) == {}
    assert program.reduce([e for e in TIMELINE
                           if e.name != "mmbench.request"]) == {}


def test_trace_reduce_unchanged_by_program_ranges():
    """The program's ranges, their device-side copies taken out, leave
    every field of trace.reduce as it was but the idle gaps' labels: the
    gap that read 'python' is put down to the span open over it."""
    ranges = [_event("mmsolver.stmap.call", 90, 310),
              _event("mmsolver.stmap.call", 200, 300, device=True),
              _event("mmsolver.warp.call", 700, 1350),
              _event("mmsolver.warp.call", 1200, 1320, device=True)]
    before = trace.reduce(EVENTS, 0.002)
    after = trace.reduce(program.without_program_ranges(EVENTS + ranges),
                         0.002)
    for field in ("window_s", "busy_s", "kernels", "ranges", "device_ops"):
        assert getattr(after, field) == getattr(before, field), field
    gaps = dict(before.idle_gaps)
    gaps["mmsolver.warp.call"] = gaps.pop("python")
    assert dict(after.idle_gaps) == gaps
    assert len(trace.reduce(EVENTS + ranges, 0.002).kernels) == 5


def test_spans_script_on_the_cpu(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        line = spans.run("shot.lens_export", SEED, 3, 0.05, 2,
                         torch.device("cpu"), root=small_root(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert len(line["fps"]["off"]) == len(line["fps"]["on"]) == 2
    assert line["units"] == 3 and line["device"] == "cpu"
    # On the CPU the map is the plain version: no wrapper, no read; two
    # warps a frame, no device, no launch.
    assert list(line["spans"]) == ["warp.call"]
    warp = line["spans"]["warp.call"]
    assert warp["ranges"] == 6 and warp["launches_range"] == [0, 0]
    assert warp["busy_ms"] == 0.0 and warp["idle_ms"] > 0.0
    assert line["counters"].get("host_reads", 0) == 0
