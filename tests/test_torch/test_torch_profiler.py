"""The port's utils/profiler.py against the JAX package's, and solve()
with SolverOptions.profile_dir.

PhaseTimer and python_profile are copies: under one fake clock both
packages' timers give the same summary, and both profiles write what
pstats reads.  xla_trace takes the role of the reference's jax.profiler
capture with torch.profiler: a trace file in log_dir, with the
program's spans.  solve() with profile_dir writes one and solves as
without it (after
tests/test_solver/test_interrupt.py::test_profile_dir_captures_trace).

The port's own spans and counters have no counterpart in the reference:
off (no running capture, no tracing()), a span is the one shared no-op
context, returned after the flag test and one profiler-state check, and
logs nothing; under a capture, whatever tracing() says, spans are
operator records (not user ranges), nested as named and logged; under
tracing() alone they are logged only, on time.perf_counter(), in a
bounded log.  The ST-map wrapper's and the warp's spans nest as named,
and the wrapper counts one host read a call that fetches lens values
from another device (a lens of Python numbers or CPU tensors is handed
over by value, with no read).  Without a card a CUDA call of the wrapper
raises at the output's allocation, inside its launch span: the spans up
to there are in the capture, and no launch is counted.
"""

import contextlib
import dataclasses
import json
import os
import pstats
import time

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.ops.stmap as t_stmap
import mayamatchmovesolver_torch.ops.warp as t_warp
import mayamatchmovesolver_torch.utils.profiler as t_profiler
import mayamatchmovesolver_tpu.utils.profiler as j_profiler
from _torch_stmap_models import program_ranges, torch_model
from mayamatchmovesolver_tpu.core.constants import FilmFit
from torch.profiler import ProfilerActivity, profile

PROFILERS = {"jax": j_profiler, "torch": t_profiler}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _timed_summary(profiler, monkeypatch):
    ticks = iter(np.cumsum([0.0, 0.5, 0.25, 1.0, 2.0, 0.125, 4.0]))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    timer = profiler.PhaseTimer()
    with timer.phase("solve"):
        pass
    with timer.phase("bake"):
        pass
    with pytest.raises(ValueError):
        with timer.phase("solve"):
            raise ValueError("an interrupted phase is timed too")
    return timer.summary()


def test_phase_timer_matches(monkeypatch):
    want = _timed_summary(j_profiler, monkeypatch)
    got = _timed_summary(t_profiler, monkeypatch)
    assert got == want
    assert list(got) == ["bake", "solve"]
    assert got["solve"] == {"total_seconds": 0.625, "count": 2,
                            "mean_seconds": 0.3125}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_python_profile_writes_stats(tmp_path, capsys, pkg):
    path = str(tmp_path / "block.pstat")
    with PROFILERS[pkg].python_profile(path) as prof:
        sum(range(1000))
    assert prof is not None
    assert pstats.Stats(path).total_calls > 0
    with PROFILERS[pkg].python_profile(top=3):
        sorted(range(100))
    assert "function calls" in capsys.readouterr().out


def test_xla_trace_writes_a_trace_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with t_profiler.xla_trace(log_dir):
        torch.ones(16, 16) @ torch.ones(16, 16)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_xla_trace_holds_the_programs_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    image = torch.rand(6, 8, 4)
    assert t_profiler.span("warp.call") is t_profiler.span("stmap.call")
    with t_profiler.xla_trace(log_dir):
        assert t_profiler.span("warp.call") is not t_profiler.span("warp.call")
        t_warp.warp_image(image, torch.rand(6, 8, 4))
    assert t_profiler.span("warp.call") is t_profiler.span("stmap.call")
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mmsolver.warp.call" for e in events)


def test_kernel_op_is_an_operator_under_a_capture_only():
    """The warp's launch span, the operator its hand kernel is put down
    to: off a capture the shared no-op; under one, whatever tracing()
    says, an operator record (not a user range) nested in the ranges
    around it, as an aten op is."""
    assert t_profiler.span("warp.launch") is t_profiler._OFF
    for on in (False, True):
        with contextlib.ExitStack() as stack:
            if on:
                stack.enter_context(t_profiler.tracing())
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with torch.profiler.record_function("caller"):
                    with t_profiler.span("warp.launch"):
                        pass
        (op,) = [e for e in prof.events()
                 if e.name == "mmsolver.warp.launch"]
        assert op.cpu_parent.name == "caller" and not op.is_user_annotation
    assert t_profiler.span("warp.launch") is t_profiler._OFF


def test_span_off_is_the_shared_no_op_after_two_checks(monkeypatch):
    """Off, span() makes one profiler-state check (torch's own
    _profiler_enabled) besides the flag test and returns the shared
    no-op, which logs nothing; with the check true it is a record."""
    assert t_profiler._profiling is torch.autograd._profiler_enabled
    assert not t_profiler._profiling()
    calls = []

    def state(value):
        def check():
            calls.append(value)
            return value
        return check

    monkeypatch.setattr(t_profiler, "_profiling", state(False))
    before = t_profiler.span_log()
    off = t_profiler.span("warp.call")
    assert off is t_profiler._OFF and calls == [False]
    with off:
        pass
    assert t_profiler.span_log() == before
    monkeypatch.setattr(t_profiler, "_profiling", state(True))
    on = t_profiler.span("warp.call")
    assert calls == [False, True] and on is not t_profiler._OFF
    assert on.record is not None


def test_spans_under_a_bare_capture_are_operator_records_and_logged():
    """A capture with tracing() off: the wrapper's and the warp's spans
    are operator records nested as named, and each is logged inside the
    request that made it, nested as in the capture."""
    model, fb = torch_model("classic")
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stmap_cuda(model, fb)
        t_warp.warp_image(torch.rand(6, 8, 4), torch.rand(6, 8, 4))
    end = time.perf_counter()
    records = [e for e in prof.events() if e.name.startswith("mmsolver.")]
    assert records and not any(e.is_user_annotation for e in records)
    want = [("stmap.call", None), ("stmap.launch", "stmap.call"),
            ("warp.call", None)]
    if torch.cuda.is_available():
        want.append(("warp.launch", "warp.call"))
    assert program_ranges(prof.events()) == want
    logged = [e for e in t_profiler.span_log() if e[1] >= start]
    assert all(e[2] <= end for e in logged)
    logged.sort(key=lambda e: (e[1], -e[2]))
    assert [e[0] for e in logged] == [name for name, _ in want]
    call, launch = logged[0], logged[1]
    assert call[1] <= launch[1] <= launch[2] <= call[2] <= logged[2][1]


def test_tracing_without_a_capture_logs_only():
    """tracing() with no capture: a span records nothing in any profiler
    and appends its name and times to the log."""
    start = time.perf_counter()
    with t_profiler.tracing():
        assert t_profiler.span("warp.call").record is None
        t_warp.warp_image(torch.rand(6, 8, 4), torch.rand(6, 8, 4))
    logged = [e for e in t_profiler.span_log() if e[1] >= start]
    assert [e[0] for e in logged] == ["warp.call"]


def test_span_log_times_lie_inside_a_perf_counter_bracket():
    """A span's logged start and end lie inside a time.perf_counter()
    bracket around it, a nested span's inside its parent's; a span left
    by an exception is logged too, and the exception passes."""
    with t_profiler.tracing():
        before = time.perf_counter()
        with t_profiler.span("outer"):
            with t_profiler.span("inner"):
                pass
            with pytest.raises(ValueError):
                with t_profiler.span("raised"):
                    raise ValueError("passes through")
        after = time.perf_counter()
    inner, raised, outer = t_profiler.span_log()[-3:]
    assert [inner[0], raised[0], outer[0]] == ["inner", "raised", "outer"]
    assert before <= outer[1] <= inner[1] <= inner[2] <= raised[1]
    assert raised[1] <= raised[2] <= outer[2] <= after


def test_span_log_is_bounded():
    """The log keeps its last SPAN_LOG_LENGTH (at least 65,536) spans
    and drops the oldest."""
    assert t_profiler.SPAN_LOG_LENGTH >= 65536
    with t_profiler.tracing():
        for i in range(t_profiler.SPAN_LOG_LENGTH + 3):
            with t_profiler.span("n%d" % i):
                pass
    logged = t_profiler.span_log()
    assert len(logged) == t_profiler.SPAN_LOG_LENGTH
    assert logged[0][0] == "n3"
    assert logged[-1][0] == "n%d" % (t_profiler.SPAN_LOG_LENGTH + 2)


def test_tracing_restores_the_state_before():
    with t_profiler.tracing():
        with pytest.raises(ValueError):
            with t_profiler.tracing():
                raise ValueError("left by an exception")
        assert t_profiler.span("x") is not t_profiler.span("x")
    assert t_profiler.span("x") is t_profiler.span("x")


def _captured(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return program_ranges(prof.events())


def _stmap_cuda(model, fb, **kw):
    """stmap_cuda on the card, or its refusal at the allocation without
    one."""
    if torch.cuda.is_available():
        return t_stmap.stmap_cuda(model, fb, 16, 8, device="cuda", **kw)
    with pytest.raises((RuntimeError, AssertionError)):
        t_stmap.stmap_cuda(model, fb, 16, 8, device="cuda", **kw)


def test_spans_off_leave_no_range_yet_count():
    """With no capture running and tracing() off, the calls log no span
    and open no range, and the counters count."""
    model, fb = torch_model("classic")
    counters = t_profiler.counters
    reads = counters["host_reads"]
    before = t_profiler.span_log()
    t_warp.warp_image(torch.rand(6, 8, 4), torch.rand(6, 8, 4))
    t_stmap._host_values([fb.film_back_width_cm, model.distortion])
    _stmap_cuda(model, fb)
    assert t_profiler.span_log() == before
    assert counters["host_reads"] == reads + 1


def test_spans_nest_as_named():
    model, fb = torch_model("classic")
    floats = [type(o)(**{k: float(v) for k, v in vars(o).items()})
              for o in (model, fb)]
    launches = t_profiler.counters["stmap.launches"]
    reads = t_profiler.counters["host_reads"]
    with t_profiler.tracing():
        for lens in ((model, fb), floats):
            ranges = _captured(lambda: _stmap_cuda(*lens))
            assert ranges == [("stmap.call", None),
                              ("stmap.launch", "stmap.call")]
        ranges = _captured(lambda: t_warp.warp_image(
            torch.rand(6, 8, 4), torch.rand(6, 8, 4)))
        assert ranges == [("warp.call", None)]
    ran = torch.cuda.is_available()
    assert t_profiler.counters["stmap.launches"] == launches + 2 * ran
    assert t_profiler.counters["host_reads"] == reads


def test_host_values_counts_one_read_a_call():
    """One read a call of _host_values; the records of a lens read once
    for all its fields that lie on another device than the map's (here
    the CPU tensors of a lens named as on a second card), not at all
    where none does, and the read is the span "stmap.host_read"."""
    model, fb = torch_model("classic")
    counters = t_profiler.counters
    reads = counters["host_reads"]
    tensors = [fb.film_back_width_cm, model.distortion]
    for _ in range(3):
        t_stmap._host_values(tensors)
    assert counters["host_reads"] == reads + 3
    t_stmap._host_values([model.distortion, torch.tensor(
        0.1, dtype=torch.float64)])
    assert counters["host_reads"] == reads + 4
    values, devices = t_stmap._lens_fields(fb, [model])
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    elsewhere = [None if d is None else cuda1 for d in devices]
    with t_profiler.tracing():
        ranges = _captured(lambda: t_stmap._field_records(
            values, elsewhere, cuda0, []))
    assert ranges == [("stmap.host_read", None)]
    assert counters["host_reads"] == reads + 5
    with t_profiler.tracing():
        ranges = _captured(lambda: t_stmap._field_records(
            values, devices, cuda0, []))
    assert ranges == [] and counters["host_reads"] == reads + 5


def test_stmap_stack_reads_once_for_its_layers():
    """A stack is one call of the wrapper, one launch span for all its
    layers, whose fields (CPU tensors here) are handed over by value:
    nothing is read, and no layer is a call of its own."""
    model, fb = torch_model("classic")
    radial, _ = torch_model("radial_deg4")
    reads = t_profiler.counters["host_reads"]

    def stack():
        if torch.cuda.is_available():
            return t_stmap.stmap_stack([model, radial], fb, 16, 8,
                                       device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            t_stmap.stmap_stack([model, radial], fb, 16, 8, device="cuda")

    with t_profiler.tracing():
        ranges = _captured(stack)
    assert t_profiler.counters["host_reads"] == reads
    assert ranges == [("stmap.call", None), ("stmap.launch", "stmap.call")]


def _tracked_scene(num_frames=8, num_bundles=6, seed=0):
    """tests/test_solver/test_interrupt.py::_tracked_scene on the port."""
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import (
        set_marker_screen_positions,
    )

    rng = np.random.RandomState(seed)
    sg = SceneGraph(frame_range=(1, num_frames))
    cam = sg.create_camera(
        "cam",
        tx=np.linspace(-1, 1, num_frames), ty=0.5, tz=10.0,
        ry=np.linspace(-4, 4, num_frames),
        focal_length_mm=35.0, film_fit=FilmFit.HORIZONTAL,
        render_width=1920, render_height=1080,
    )
    bundles = [
        sg.create_bundle(
            "b%d" % i, tx=rng.uniform(-3, 3), ty=rng.uniform(-1, 2),
            tz=rng.uniform(-9, -4),
        )
        for i in range(num_bundles)
    ]
    for i, b in enumerate(bundles):
        sg.create_marker("m%d" % i, camera=cam, bundle=b)
    scene, attrs = sg.bake(device="cpu")
    frames = torch.arange(num_frames)
    ev = evaluate(scene, attrs, frames)
    attrs = set_marker_screen_positions(scene, attrs, frames, ev.point_xy)
    return scene, attrs, cam, bundles


def test_profile_dir_captures_trace(tmp_path):
    """SolverOptions(profile_dir=...) writes a torch.profiler trace of
    the solve, which solves as it does without one."""
    from mayamatchmovesolver_torch.solver import SolverOptions, solve

    scene, attrs, cam, bundles = _tracked_scene()
    static = attrs.static_values.clone()
    static[bundles[0].attr("tx").code // 2] += 0.2
    attrs = dataclasses.replace(attrs, static_values=static)
    solve_attrs = [bundles[0].attr("tx"), bundles[0].attr("ty")]
    trace_dir = str(tmp_path / "trace")
    traced_attrs, result = solve(
        scene, attrs, np.arange(8), solve_attrs,
        SolverOptions(image_width=1920.0, profile_dir=trace_dir),
    )
    assert result.success
    found = []
    for root, _, files in os.walk(trace_dir):
        found += files
    assert found, "no trace files written"
    plain_attrs, plain = solve(scene, attrs, np.arange(8), solve_attrs,
                               SolverOptions(image_width=1920.0))
    assert result.iterations == plain.iterations
    assert torch.equal(traced_attrs.static_values, plain_attrs.static_values)
