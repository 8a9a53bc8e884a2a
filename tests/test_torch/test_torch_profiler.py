"""The port's utils/profiler.py against the JAX package's, and solve()
with SolverOptions.profile_dir.

PhaseTimer and python_profile are copies: under one fake clock both
packages' timers give the same summary, and both profiles write what
pstats reads.  xla_trace takes the role of the reference's jax.profiler
capture with torch.profiler: a trace file in log_dir.  solve() with
profile_dir writes one and solves as without it (after
tests/test_solver/test_interrupt.py::test_profile_dir_captures_trace).
"""

import json
import os
import pstats
import time

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.utils.profiler as t_profiler
import mayamatchmovesolver_tpu.utils.profiler as j_profiler
from mayamatchmovesolver_tpu.core.constants import FilmFit

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
    import dataclasses

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
