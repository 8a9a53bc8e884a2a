"""Each metric reader, and the trace's reduction, on canned records."""

import math
import types

import pytest

from mmbench.common import harness, peaks, trace
from mmbench.common.records import Records, Request


def _read(name, records):
    return harness.load_module(
        harness.BENCH / "metrics" / (name + ".py")).read(records)


def _event(name, start, end, device=False, thread=1, device_total=0.0):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        thread=thread, device_time_total=device_total)


# Two requests of 1000 us; kernels busy 300 us of them, launched by three
# cudaLaunchKernel calls; one warp range whose kernels took 120 us.
EVENTS = [
    _event("mmbench.request", 0, 1000),
    _event("mmbench.request", 1000, 2000),
    _event("mmbench.request", 0, 2000, device=True),
    _event("aten::add", 100, 300),
    _event("cudaLaunchKernel", 150, 160),
    _event("cudaLaunchKernel", 1150, 1160),
    _event("cuLaunchKernelEx", 1170, 1180),
    _event("mmbench.warp", 1100, 1300, device_total=120.0),
    _event("cudaStreamSynchronize", 1500, 1990),
    _event("void stmap_kernel<0, true, false>(float4*, int, int)", 200, 300,
           device=True),
    _event("void stmap_kernel<0, false, false>(float4*, int, int)", 250, 350,
           device=True),
    _event("void at::native::gather(...)", 1200, 1320, device=True),
]


def test_reduce():
    t = trace.reduce(EVENTS, 0.002)
    assert t.window_s == 0.002
    assert t.busy_s == pytest.approx(270e-6)
    assert t.ranges["mmbench.warp"] == [pytest.approx(120e-6)]
    assert len(t.kernels) == 3  # the range's own device span is not one
    assert t.device_ops[0][0].startswith("void at::native::gather")
    gaps = dict(t.idle_gaps)
    # idle: 0-200, 350-1200, 1320-2000 us
    assert sum(gaps.values()) == pytest.approx(1730e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(680e-6)
    assert gaps["aten::add"] == pytest.approx(200e-6)
    assert gaps["python"] == pytest.approx(850e-6)


def _records(**kw):
    reqs = [Request(0.0, 1.0, 10, True), Request(1.0, 3.0, 12, True),
            Request(3.0, 3.5, 6, True)]
    base = dict(requests=reqs, window_s=4.0,
                config={"plate": [1920, 1080]})
    base.update(kw)
    return Records(**base)


def test_end_to_end_readers():
    rec = _records()
    assert _read("export_fps", rec) == pytest.approx(28 / 4.0)
    assert _read("frame_p95_ms", rec) == pytest.approx(2000.0)
    failed = _records(requests=[Request(0.0, 0.001, 1, True)] * 19
                      + [Request(0.0, 0.0, 1, False)])
    assert _read("frame_p95_ms", failed) == pytest.approx(1.0)
    failed.requests.append(Request(0.0, 0.0, 1, False))
    assert math.isinf(_read("frame_p95_ms", failed))
    assert _read("export_fps", _records(requests=[])) is None


def test_per_layer_readers():
    t = trace.reduce(EVENTS, 0.002)
    rec = _records(trace=t, profiled=[Request(0.0, 1.0, 3, True)],
                   plain=[Request(0.0, 0.001, 2, True),
                          Request(0.0, 0.001, 1, True)],
                   spans={"stmap": [1e-4, 2e-4, 9e-4]})
    # busy 90 us a unit against a wall of 2000/3 us a unit
    assert _read("device_idle_pct.export", rec) == pytest.approx(86.5)
    assert _read("stmap_wrapper_ms.export", rec) == pytest.approx(0.2)
    assert _read("warp_device_ms.export", rec) == pytest.approx(0.12)
    bound = (peaks.stmap_bound("TdeClassic", "distort", 1920, 1080)[0]
             + peaks.stmap_bound("TdeClassic", "undistort", 1920, 1080)[0])
    assert _read("stmap_roofline_pct.export", rec) == pytest.approx(
        100.0 * bound / 200e-6)


def test_readers_without_records_return_nothing():
    rec = _records()
    for name in ("device_idle_pct.export",
                 "stmap_roofline_pct.export", "stmap_wrapper_ms.export",
                 "warp_device_ms.export"):
        assert _read(name, rec) is None, name


def test_stmap_bound_is_chip_smokes():
    # chip_smoke.py's figures at 1920x1080: 0.0122 ms (operations) to
    # distort, 0.0099 ms (bytes) to undistort.
    d = peaks.stmap_bound("TdeClassic", "distort", 1920, 1080)
    u = peaks.stmap_bound("TdeClassic", "undistort", 1920, 1080)
    assert d[1] == "operations" and d[0] == pytest.approx(1.2194e-5, rel=1e-3)
    assert u[1] == "bytes" and u[0] == pytest.approx(9.904e-6, rel=1e-3)
