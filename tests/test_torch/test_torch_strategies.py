"""Agreement of the port's solver strategies with the JAX package.

The schedules (root_frame_schedule, coerce_frames, the rootframe and
affects functions) must be equal.  Every strategy class runs in both
packages on the same numpy-seeded scene, float64 on the CPU: the same
number of results, iterations, stop reasons and reason strings, errors
and solved attributes at 1e-8.  SolverCamera has its own file,
test_torch_solvercamera.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.solver.affects as t_affects
import mayamatchmovesolver_torch.solver.rootframe as t_rootframe
import mayamatchmovesolver_torch.solver.strategies as t_strat
import mayamatchmovesolver_torch.solver.triangulate as t_tri
import mayamatchmovesolver_tpu.solver.affects as j_affects
import mayamatchmovesolver_tpu.solver.rootframe as j_rootframe
import mayamatchmovesolver_tpu.solver.strategies as j_strat
import mayamatchmovesolver_tpu.solver.triangulate as j_tri
from _torch_port_cases import (
    PACKAGES,
    _bake,
    lens_focal_scene,
    rich_scene,
    to_numpy,
)
from mayamatchmovesolver_tpu.core.constants import FilmFit

TOL = 1e-8
STRATEGIES = [j_strat.RootFrameStrategy.GLOBAL,
              j_strat.RootFrameStrategy.FWD_PAIR,
              j_strat.RootFrameStrategy.FWD_PAIR_AND_GLOBAL,
              j_strat.RootFrameStrategy.FWD_INCREMENT]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Frame:
    def __init__(self, value):
        self.value = value


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("roots", [[7, 0, 4], [3], [2, 9, 5, 30]])
def test_root_frame_schedule_matches(strategy, roots):
    assert (t_strat.root_frame_schedule(roots, strategy)
            == j_strat.root_frame_schedule(roots, strategy))
    assert (getattr(t_strat.RootFrameStrategy, "GLOBAL")
            == j_strat.RootFrameStrategy.GLOBAL)


def test_schedule_refuses_an_unknown_strategy_and_frames_coerce():
    with pytest.raises(ValueError, match="unknown root frame strategy"):
        t_strat.root_frame_schedule([0, 1], "backwards")
    frames = [_Frame(3), 4, np.int64(5)]
    assert t_strat.coerce_frames(frames) == j_strat.coerce_frames(frames)
    assert t_strat.coerce_frames(frames) == [3, 4, 5]
    assert t_strat.SolverStep(frames).frame_indices == [3, 4, 5]
    action = t_strat.Action("add", lambda a, b=0: a + b, (1,), {"b": 2})
    assert action.run() == 3
    compiled = t_strat.SolverStep([0]).compile("scene", "attrs", [], None)
    assert [a.name for a in compiled] == ["SolverStep"]
    assert compiled[0].args[:2] == ("scene", "attrs")
    assert not t_strat.SolverCamera.requires_attributes
    assert not t_strat.SolverTriangulate.requires_attributes
    assert t_strat.SolverStandard.requires_attributes


def test_rootframe_functions_match():
    rng = np.random.RandomState(0)
    enable = rng.uniform(size=(7, 30)) > 0.4
    enable[2] = False
    frames = list(range(101, 131))
    for per_marker in (2, 3, 5):
        assert (t_rootframe.get_root_frames_from_markers(
            enable, frames, per_marker)
            == j_rootframe.get_root_frames_from_markers(
                enable, frames, per_marker))
    for span in (3, 10):
        assert (t_rootframe.root_frames_subdivide([101, 130, 110], span)
                == j_rootframe.root_frames_subdivide([101, 130, 110], span))
    assert t_rootframe.root_frames_subdivide([], 3) == []
    assert (t_rootframe.root_frames_list_combine([5, 1], (3, 1.0))
            == j_rootframe.root_frames_list_combine([5, 1], (3, 1.0))
            == [1, 3, 5])


def test_affects_functions_match_on_the_same_scene_graph():
    out = []
    for pkg, mod in (("jax", j_affects), ("torch", t_affects)):
        _, _, _, _, h = rich_scene(pkg)
        cam0, cam1 = h["cams"]
        attrs = [cam0.attr("tx"), cam1.attr("focal_length_mm"),
                 h["chain"][0].attr("ry"), h["chain"][2].attr("rx"),
                 h["bundles"][0].attr("tx"), h["bundles"][1].attr("ty"),
                 h["markers"][3].attr("weight"),
                 cam1.attr("lens_degree2_distortion")]
        markers = h["markers"][:8]
        split = mod.split_used_markers_and_attributes(
            markers[:2], attrs)
        out.append(dict(
            matrix=mod.marker_attr_affects(markers, attrs),
            split=[[x.name for x in part] for part in split],
            expanded=mod.error_to_parameter_matrix(markers, attrs, 4),
            summary=mod.affects_summary_string(markers, attrs),
        ))
    want, got = out
    np.testing.assert_array_equal(got["matrix"], want["matrix"])
    np.testing.assert_array_equal(got["expanded"], want["expanded"])
    assert got["split"] == want["split"] and got["split"][3]
    assert got["summary"] == want["summary"]
    assert got["matrix"].any() and not got["matrix"].all()


def _options(pkg, **kw):
    mod = j_strat if pkg == "jax" else t_strat
    return mod.SolverOptions(image_width=1920.0, **kw)


def _run(pkg, make_solver, **kw):
    """One strategy on the lens + focal scene of `pkg`."""
    scene, attrs, lens, solve_attrs, _ = lens_focal_scene(pkg)
    mod = j_strat if pkg == "jax" else t_strat
    solver = make_solver(mod)
    return solver.execute(scene, attrs, solve_attrs, _options(pkg),
                          lens=lens, **kw)


def _assert_same(got, want, tol=TOL):
    (t_attrs, t_results), (j_attrs, j_results) = got, want
    assert len(t_results) == len(j_results)
    for t_r, j_r in zip(t_results, j_results):
        assert t_r.success == j_r.success
        assert t_r.stop_reason == j_r.stop_reason
        assert t_r.iterations == j_r.iterations
        assert t_r.reason_string == j_r.reason_string
        assert t_r.per_frame_stop_reason == j_r.per_frame_stop_reason
        assert t_r.per_frame_reverted == j_r.per_frame_reverted
        for field in ("error_initial", "error_final", "error_avg",
                      "error_min", "error_max"):
            np.testing.assert_allclose(getattr(t_r, field),
                                       getattr(j_r, field), atol=tol,
                                       err_msg=field)
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(t_attrs, field)),
                                   np.asarray(getattr(j_attrs, field)),
                                   atol=tol, err_msg=field)


def _both(make_solver, **kw):
    return _run("torch", make_solver, **kw), _run("jax", make_solver, **kw)


def test_solver_step_matches():
    got, want = _both(lambda m: m.SolverStep([0, 4, 7]))
    _assert_same(got, want)
    assert len(got[1]) == 1 and got[1][0].success


@pytest.mark.parametrize("sequential", [False, True])
def test_solver_basic_matches(sequential):
    """Only the animated attributes are solved, frame by frame."""
    got, want = _both(lambda m: m.SolverBasic(range(8),
                                              sequential=sequential))
    _assert_same(got, want)
    assert len(got[1]) == 1
    assert len(got[1][0].per_frame_stop_reason) == 8
    # The static attributes (focal, distortion) are untouched.
    _, start, _, _, truth = lens_focal_scene("torch")
    for key in ("focal_index", "distortion_index"):
        assert (float(got[0].static_values[truth[key]])
                == float(start.static_values[truth[key]]))


def test_solver_basic_takes_a_marker_mask():
    mask = np.arange(6) != 2
    got, want = _both(lambda m: m.SolverBasic(range(8)), marker_mask=mask)
    _assert_same(got, want)


@pytest.mark.parametrize("case", ["use_single_frame", "one_frame"])
def test_solver_standard_single_frame_matches(case):
    def make(m):
        if case == "use_single_frame":
            return m.SolverStandard(range(8), use_single_frame=True)
        return m.SolverStandard([3])

    got, want = _both(make)
    _assert_same(got, want)
    assert len(got[1]) == 1


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_solver_standard_with_given_roots_matches(strategy):
    """Root pass per strategy, then the per-frame pass."""
    got, want = _both(lambda m: m.SolverStandard(
        range(8), root_frame_indices=[0, 4, 7],
        root_frame_strategy=strategy))
    _assert_same(got, want)
    batches = len(t_strat.root_frame_schedule([0, 4, 7], strategy))
    assert len(got[1]) == batches + 1
    assert len(got[1][-1].per_frame_stop_reason) == 8


def test_solver_standard_automatic_roots_and_global_solve_match():
    """Roots from the markers' enables (first, last, subdivided to a
    span of 4: frames 0, 3, 7), root pass, per-frame pass, global pass;
    the solve recovers focal length and distortion."""
    make = lambda m: m.SolverStandard(  # noqa: E731
        range(8), root_frame_indices=None, global_solve=True,
        root_frame_span=4)
    got, want = _both(make)
    _assert_same(got, want)
    assert len(got[1]) == 3
    scene, attrs, _, _, truth = lens_focal_scene("torch")
    solver = make(t_strat)
    j_scene, j_attrs, _, _, _ = lens_focal_scene("jax")
    assert (solver._auto_root_frames(scene, attrs)
            == make(j_strat)._auto_root_frames(j_scene, j_attrs)
            == [0, 3, 7])
    assert abs(float(got[0].static_values[truth["focal_index"]])
               - truth["focal"]) < 1e-6
    assert abs(float(got[0].static_values[truth["distortion_index"]])
               - truth["distortion"]) < 1e-8


def test_solver_standard_with_only_static_attributes_skips_the_sweep():
    def run(pkg):
        scene, attrs, lens, solve_attrs, _ = lens_focal_scene(pkg)
        mod = j_strat if pkg == "jax" else t_strat
        static = [a for a in solve_attrs if a.code % 2 == 0]
        return mod.SolverStandard(
            range(8), root_frame_indices=[0, 4, 7]).execute(
                scene, attrs, static, _options(pkg), lens=lens)
    got, want = run("torch"), run("jax")
    _assert_same(got, want)
    assert len(got[1]) == 1


def _triangulation_scene(pkg):
    """A known animated camera over 6 frames, 7 bundles moved off their
    positions (two of them with animated tx, one under a parent), one
    marker disabled on all but one frame.  Returns (scene, attrs,
    bundle position attributes, true positions)."""
    scene_mod, _ = PACKAGES[pkg]
    rng = np.random.RandomState(4)
    n = 6
    sg = scene_mod.SceneGraph(frame_range=(1, n))
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=1920,
        render_height=1080, tx=np.linspace(-3, 3, n),
        ty=0.2 * np.sin(np.linspace(0, 3, n)), tz=12.0,
        ry=np.linspace(-10, 10, n), focal_length_mm=35.0)
    truth = np.stack([rng.uniform(-4, 4, 7), rng.uniform(-2, 2, 7),
                      rng.uniform(-8, -3, 7)], -1)
    parent = sg.create_transform("rig", tx=0.5, ty=-0.25)
    bundles, markers = [], []
    for i, p in enumerate(truth):
        bundles.append(sg.create_bundle(
            "b%d" % i, parent=parent if i == 6 else None,
            tx=np.full(n, p[0]) if i in (1, 2) else p[0], ty=p[1], tz=p[2]))
        values = dict(tx=np.zeros(n), ty=np.zeros(n))
        if i == 5:
            values["enable"] = np.array([1.0] + [0.0] * (n - 1))
        markers.append(sg.create_marker("m%d" % i, camera=cam,
                                        bundle=bundles[-1], **values))
    scene, attrs = _bake(pkg, sg)
    if pkg == "torch":
        from mayamatchmovesolver_torch.scene import flatscene as fs
        fi = torch.arange(n)
        ev = fs.evaluate(scene, attrs, fi)
        attrs = fs.set_marker_screen_positions(scene, attrs, fi, ev.point_xy)
        static = attrs.static_values.numpy().copy()
        anim = attrs.anim_values.numpy().copy()
    else:
        from mayamatchmovesolver_tpu.scene import flatscene as fs
        fi = jnp.arange(n)
        ev = fs.evaluate_jit(scene, attrs, fi)
        attrs = fs.set_marker_screen_positions(scene, attrs, fi, ev.point_xy)
        static = np.array(attrs.static_values)
        anim = np.array(attrs.anim_values)
    bundle_attrs = []
    for b in bundles[:6]:
        for ch, delta in (("tx", 0.7), ("ty", -0.4), ("tz", 1.1)):
            a = b.attr(ch)
            bundle_attrs.append(a)
            if a.code % 2 == 0:
                static[a.code // 2] += delta
            else:
                anim[a.code // 2] += delta
    if pkg == "torch":
        attrs = dataclasses.replace(
            attrs, static_values=torch.as_tensor(static),
            anim_values=torch.as_tensor(anim))
    else:
        attrs = attrs._replace(static_values=jnp.asarray(static),
                               anim_values=jnp.asarray(anim))
    return sg, scene, attrs, bundle_attrs, truth


def test_triangulate_functions_match():
    _, j_scene, j_attrs, _, truth = _triangulation_scene("jax")
    sg, scene, attrs, bundle_attrs, _ = _triangulation_scene("torch")
    want, want_ok = j_tri.triangulate_markers(j_scene, j_attrs, range(6))
    got, got_ok = t_tri.triangulate_markers(scene, attrs, range(6))
    np.testing.assert_array_equal(to_numpy(got_ok), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert list(ok) == [True] * 5 + [False, True]
    np.testing.assert_allclose(to_numpy(got)[ok], np.asarray(want)[ok],
                               atol=TOL)
    # Markers 0-4 see their bundle at its true world position.
    np.testing.assert_allclose(to_numpy(got)[:5], truth[:5], atol=1e-7)
    mask = np.array([True, True, False, True, True, True, True])
    j_out, j_ok = j_tri.triangulate_into_attrs(j_scene, j_attrs, range(6),
                                               marker_mask=mask)
    t_out, t_ok = t_tri.triangulate_into_attrs(scene, attrs, range(6),
                                               marker_mask=mask)
    np.testing.assert_array_equal(t_ok, np.asarray(j_ok))
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(t_out, field)),
                                   np.asarray(getattr(j_out, field)),
                                   atol=TOL, err_msg=field)
    # An animated channel is written across all its frames; the masked
    # marker's bundle keeps its displaced start.
    tx1 = bundle_attrs[3]
    np.testing.assert_allclose(
        to_numpy(t_out.anim_values[tx1.code // 2]), truth[1, 0], atol=1e-7)
    tx2 = bundle_attrs[6]
    np.testing.assert_allclose(
        to_numpy(t_out.anim_values[tx2.code // 2]), truth[2, 0] + 0.7,
        atol=1e-12)
    # With the scene graph's handles: root-level static cells only.
    j_sg, j_scene, j_attrs, _, _ = _triangulation_scene("jax")
    j_out, _ = j_tri.triangulate_and_update(j_sg, j_scene, j_attrs, range(6))
    t_out, _ = t_tri.triangulate_and_update(sg, scene, attrs, range(6))
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(t_out, field)),
                                   np.asarray(getattr(j_out, field)),
                                   atol=TOL, err_msg=field)
    assert torch.equal(t_out.anim_values, attrs.anim_values)


@pytest.mark.parametrize("refine", [False, True])
def test_solver_triangulate_matches(refine):
    def run(pkg):
        _, scene, attrs, bundle_attrs, _ = _triangulation_scene(pkg)
        mod = j_strat if pkg == "jax" else t_strat
        # Without the one-frame marker and the parented bundle's (its
        # world position lands in its local cells, as in the reference).
        mask = np.array([True] * 5 + [False, False])
        return mod.SolverTriangulate(
            range(6), refine=refine, refine_iterations=4).execute(
                scene, attrs, bundle_attrs[:15], _options(pkg),
                marker_mask=mask)
    got, want = run("torch"), run("jax")
    _assert_same(got, want)
    assert len(got[1]) == (2 if refine else 1)
    last = got[1][-1]
    assert last.reason_string == "triangulated 5/7 bundles"
    assert not last.success and last.error_final < 1e-6
