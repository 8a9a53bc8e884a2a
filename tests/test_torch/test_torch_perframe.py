"""Agreement of the torch port's per-frame solve and batched LM with the
JAX package.

The same numpy-seeded shot (8 frames, 6 bundles, float64) goes through
solve_per_frame of both packages.  Parallel mode: attributes at 1e-10,
and each frame's iterations, evaluation counts, stop reason and reverted
flag, the result strings and the error statistics (1e-9 px) equal — with
a marker mask, with stiffness and smoothness on, and when every frame is
reverted.  Sequential mode: attributes at 1e-8 with and without the
Kalman warm start (each frame starts from the previous frames' results,
so round-off travels along the shot).  The batched LM against one
unbatched solve per row: counters and stop reasons equal, parameters at
1e-12 (the batched products sum in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.solver.lm as t_lm
from _torch_port_cases import PACKAGES, lens_focal_scene, to_numpy
from mayamatchmovesolver_tpu.core.constants import FilmFit

t_solve = importlib.import_module("mayamatchmovesolver_torch.solver.solve")
j_solve = importlib.import_module("mayamatchmovesolver_tpu.solver.solve")
SOLVE = {"jax": j_solve, "torch": t_solve}

ATTR_TOL = 1e-10
SEQUENTIAL_TOL = 1e-8
ERROR_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shot(pkg):
    """lens_focal_scene with only its six animated camera channels to
    solve (the perturbed focal length and distortion stay wrong, so no
    frame reaches zero error)."""
    scene, attrs, lens, solve_attrs, _ = lens_focal_scene(pkg)
    return scene, attrs, lens, solve_attrs[:6]


def _mask():
    """Marker 1 off on frames 2 and 5, marker 4 off everywhere, frame 6
    measures nothing."""
    mask = np.ones((6, 8), bool)
    mask[1, [2, 5]] = False
    mask[4] = False
    mask[:, 6] = False
    return mask


def _stiffness(pkg, solve_attrs):
    mod = SOLVE[pkg]
    stiff = mod.build_stiffness(None, solve_attrs[:2], range(8), weight=2.0,
                                variance=0.5)
    smooth = mod.build_stiffness(None, solve_attrs[4:5], range(8),
                                 weight=0.7, variance=3.0, mode="smoothness")
    return mod.merge_stiffness(stiff, smooth)


def _run(pkg, case, **kwargs):
    scene, attrs, lens, solve_attrs = _shot(pkg)
    mod = SOLVE[pkg]
    if case == "mask":
        kwargs["marker_frame_mask"] = _mask()
    elif case == "marker_mask":
        kwargs["marker_mask"] = np.array([1, 1, 0, 1, 1, 1], bool)
    elif case == "stiffness":
        kwargs["stiffness"] = _stiffness(pkg, solve_attrs)
    options = mod.SolverOptions(image_width=1920.0, iterations=12)
    attrs_out, result = mod.solve_per_frame(
        scene, attrs, np.arange(8), solve_attrs, options, lens=lens, **kwargs)
    return attrs, attrs_out, result


def _assert_same_result(t_res, j_res, tol=ERROR_TOL):
    assert t_res.per_frame_stop_reason == j_res.per_frame_stop_reason
    assert t_res.per_frame_reverted == j_res.per_frame_reverted
    assert t_res.success == j_res.success
    assert t_res.stop_reason == j_res.stop_reason
    assert t_res.reason_string == j_res.reason_string
    assert t_res.iterations == j_res.iterations
    assert t_res.function_evals == j_res.function_evals
    assert t_res.jacobian_evals == j_res.jacobian_evals
    for name in ("error_initial", "error_final", "error_avg", "error_min",
                 "error_max"):
        np.testing.assert_allclose(getattr(t_res, name), getattr(j_res, name),
                                   rtol=0, atol=tol, err_msg=name)
    assert t_res.per_frame_error.frames == j_res.per_frame_error.frames
    np.testing.assert_allclose(t_res.per_frame_error.errors,
                               j_res.per_frame_error.errors, atol=tol)
    assert t_res.per_marker_error.keys() == j_res.per_marker_error.keys()
    for key, curve in j_res.per_marker_error.items():
        assert t_res.per_marker_error[key].frames == curve.frames, key
        np.testing.assert_allclose(t_res.per_marker_error[key].errors,
                                   curve.errors, atol=tol, err_msg=key)
    keys = ("success", "reason_num", "reason_string", "iteration_num",
            "iteration_function_num", "iteration_jacobian_num",
            "user_interrupted")
    t_lines, j_lines = (
        [line for line in res.as_key_value_strings()
         if line.split("=")[0] in keys]
        for res in (t_res, j_res))
    assert t_lines == j_lines and len(t_lines) == len(keys)


@pytest.mark.parametrize("case", ["plain", "mask", "marker_mask", "stiffness"])
def test_parallel_per_frame_matches(case):
    j_in, j_out, j_res = _run("jax", case)
    t_in, t_out, t_res = _run("torch", case)
    assert j_res.success and j_res.error_final < j_res.error_initial
    assert max(j_res.per_frame_stop_reason) <= 4
    if case == "mask":
        assert j_res.per_frame_reverted[6]  # nothing measured: reverted
    np.testing.assert_allclose(to_numpy(t_out.anim_values),
                               np.asarray(j_out.anim_values), rtol=0,
                               atol=ATTR_TOL)
    np.testing.assert_array_equal(to_numpy(t_out.static_values),
                                  to_numpy(t_in.static_values))
    assert not np.array_equal(to_numpy(t_out.anim_values),
                              to_numpy(t_in.anim_values))
    _assert_same_result(t_res, j_res)


def test_stiffness_changes_the_answer_and_isolates_frames():
    """With stiffness on, each frame's target is its neighbour in the
    base attributes, not the neighbour's candidate: the answer differs
    from the unconstrained one, and solving frames 2..5 alone gives those
    frames the values they get in the whole sweep."""
    scene, attrs, lens, solve_attrs = _shot("torch")
    options = t_solve.SolverOptions(image_width=1920.0, iterations=12)
    stiffness = _stiffness("torch", solve_attrs)
    free, _ = t_solve.solve_per_frame(
        scene, attrs, np.arange(8), solve_attrs, options, lens=lens)
    whole, _ = t_solve.solve_per_frame(
        scene, attrs, np.arange(8), solve_attrs, options, lens=lens,
        stiffness=stiffness)
    part, _ = t_solve.solve_per_frame(
        scene, attrs, np.arange(2, 6), solve_attrs, options, lens=lens,
        stiffness=stiffness)
    assert float((whole.anim_values - free.anim_values).abs().max()) > 1e-6
    np.testing.assert_allclose(to_numpy(part.anim_values[:, 2:6]),
                               to_numpy(whole.anim_values[:, 2:6]), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(to_numpy(part.anim_values[:, :2]),
                                  to_numpy(attrs.anim_values[:, :2]))


def _tracking_scene(pkg):
    """The all-reverted case of the JAX package's own per-frame test: a
    static camera, one bundle animated in x that starts AT the optimum,
    so no frame can improve."""
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu.scene import evaluate, flatscene

    n = 8

    def make(scene_mod, **marker):
        sg = scene_mod.SceneGraph(frame_range=(1, n))
        cam = sg.create_camera(
            "cam", tx=0.0, ty=0.0, tz=10.0, focal_length_mm=35.0,
            sensor_width_mm=36.0, sensor_height_mm=24.0,
            film_fit=FilmFit.HORIZONTAL, render_width=1500,
            render_height=1000)
        bnd = sg.create_bundle("bnd", tx=np.linspace(-2.0, 2.0, n),
                               ty=np.zeros(n), tz=np.zeros(n))
        sg.create_marker("mkr", camera=cam, bundle=bnd, **marker)
        return sg, bnd

    # The ground-truth track, from the JAX package for both.
    gscene, gattrs = make(PACKAGES["jax"][0])[0].bake()
    track = np.asarray(evaluate(gscene, gattrs, jnp.arange(n)).point_xy)
    fsx, fsy = flatscene.marker_fit_scale(gscene, gattrs, jnp.arange(n))
    sg, bnd = make(PACKAGES[pkg][0],
                   tx=track[0, :, 0] / np.asarray(fsx)[0],
                   ty=track[0, :, 1] / np.asarray(fsy)[0])
    scene, attrs = sg.bake(device="cpu") if pkg == "torch" else sg.bake()
    return scene, attrs, bnd


def test_all_frames_reverted_matches():
    results = {}
    for pkg, mod in SOLVE.items():
        scene, attrs, bnd = _tracking_scene(pkg)
        attrs_out, result = mod.solve_per_frame(
            scene, attrs, range(8), [bnd.attr("tx")],
            mod.SolverOptions(iterations=5))
        assert all(result.per_frame_reverted)
        np.testing.assert_array_equal(to_numpy(attrs_out.anim_values),
                                      to_numpy(attrs.anim_values))
        results[pkg] = result
    assert "8 frame(s) reverted: no improvement" in \
        results["torch"].reason_string
    _assert_same_result(results["torch"], results["jax"])


@pytest.mark.parametrize("warm_start", [True, False])
def test_sequential_per_frame_matches(warm_start):
    kwargs = dict(sequential=True, kalman_warm_start=warm_start)
    _, j_out, j_res = _run("jax", "stiffness", **kwargs)
    _, t_out, t_res = _run("torch", "stiffness", **kwargs)
    assert j_res.success
    np.testing.assert_allclose(to_numpy(t_out.anim_values),
                               np.asarray(j_out.anim_values), rtol=0,
                               atol=SEQUENTIAL_TOL)
    _assert_same_result(t_res, j_res, tol=1e-7)


def test_sequential_sees_the_solved_previous_frame():
    """Sequential mode's stiffness target is the previous frame as
    solved, so it differs from the parallel sweep's."""
    _, seq, _ = _run("torch", "stiffness", sequential=True)
    _, par, _ = _run("torch", "stiffness")
    assert float((seq.anim_values - par.anim_values).abs().max()) > 1e-6


def test_per_frame_refuses_static_attributes_and_bad_masks():
    scene, attrs, lens, solve_attrs, _ = lens_focal_scene("torch")
    with pytest.raises(ValueError, match="animated attributes only"):
        t_solve.solve_per_frame(scene, attrs, range(8), solve_attrs,
                                lens=lens)
    with pytest.raises(ValueError, match=r"marker_frame_mask shape \(6, 3\)"):
        t_solve.solve_per_frame(scene, attrs, range(8), solve_attrs[:6],
                                lens=lens,
                                marker_frame_mask=np.ones((6, 3), bool))


def test_stiffness_specs_match():
    _, _, _, j_attrs = _shot("jax")
    _, _, _, t_attrs = _shot("torch")
    assert _stiffness("torch", t_attrs) == _stiffness("jax", j_attrs)
    per_attr = {t_attrs[0].code: 1.5, t_attrs[1]: 0.0}
    assert t_solve.build_stiffness(
        None, t_attrs[:3], [0, 1, 2], weight=per_attr, variance=per_attr
    ) == j_solve.build_stiffness(
        None, j_attrs[:3], [0, 1, 2],
        weight={j_attrs[0].code: 1.5, j_attrs[1]: 0.0},
        variance={j_attrs[0].code: 1.5, j_attrs[1]: 0.0})
    assert t_solve.merge_stiffness(None) == j_solve.merge_stiffness(None)
    assert int(t_solve.FrameSolveMode.PER_FRAME) == int(
        j_solve.FrameSolveMode.PER_FRAME)
    assert [m.name for m in t_solve.SceneGraphMode] == [
        m.name for m in j_solve.SceneGraphMode]


# ---- The batched LM against unbatched solves. ----------------------------


def _curve_fit(batch, seed=0):
    """Row b fits a * exp(-k t) + c to its own noisy samples; rows differ
    in data and difficulty, so they stop at different iterations."""
    rng = np.random.RandomState(seed)
    t = torch.linspace(0.0, 4.0, 15, dtype=torch.float64)
    truth = rng.uniform([1.0, 0.3, -1.0], [3.0, 1.5, 1.0], (batch, 3))
    data = torch.as_tensor(
        truth[:, :1] * np.exp(-truth[:, 1:2] * t.numpy()) + truth[:, 2:]
        + rng.normal(0.0, 0.01, (batch, 15)))
    x0 = torch.as_tensor(truth * rng.uniform(0.5, 1.5, (batch, 3)))

    def fn(x, y=data):
        return (x[..., 0:1] * torch.exp(-x[..., 1:2] * t) + x[..., 2:3]) - y

    return fn, x0, data


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_batched_lm_equals_unbatched_solves(mode):
    fn, x0, data = _curve_fit(6)
    config = t_lm.LMConfig(max_iterations=30, jacobian_mode=mode)
    got = t_lm.levenberg_marquardt(fn, x0, config)
    assert got.x.shape == (6, 3) and got.stop_reason.shape == (6,)
    assert len(set(got.iterations.tolist())) > 1  # rows stop apart
    for b in range(6):
        want = t_lm.levenberg_marquardt(
            lambda x: fn(x, data[b]), x0[b], config)
        for name in ("iterations", "func_evals", "jacobian_evals",
                     "stop_reason"):
            assert int(getattr(got, name)[b]) == int(getattr(want, name)), \
                (b, name)
        np.testing.assert_allclose(to_numpy(got.x[b]), to_numpy(want.x),
                                   rtol=0, atol=1e-12)
        for name in ("cost", "cost_initial", "gradient_norm"):
            np.testing.assert_allclose(
                float(getattr(got, name)[b]), float(getattr(want, name)),
                rtol=1e-10, atol=1e-14, err_msg=name)


def test_batched_lm_failed_row_stops_alone():
    """A row whose normal matrix cannot be factored gets the NaN step and
    stop 5; the others go on to their own ends."""
    fn, x0, data = _curve_fit(4)

    def poisoned(x):
        r = fn(x)
        bad = torch.zeros_like(r[:, :1])
        bad[2] = torch.inf
        return r + torch.where(torch.isinf(bad), bad * x[..., 0:1], 0.0)

    config = t_lm.LMConfig(max_iterations=30)
    got = t_lm.levenberg_marquardt(poisoned, x0, config)
    clean = t_lm.levenberg_marquardt(fn, x0, config)
    assert int(got.stop_reason[2]) == 5 and int(got.iterations[2]) == 1
    np.testing.assert_array_equal(to_numpy(got.x[2]), to_numpy(x0[2]))
    keep = [0, 1, 3]
    np.testing.assert_array_equal(to_numpy(got.stop_reason[keep]),
                                  to_numpy(clean.stop_reason[keep]))
    np.testing.assert_array_equal(to_numpy(got.iterations[keep]),
                                  to_numpy(clean.iterations[keep]))
    np.testing.assert_allclose(to_numpy(got.x[keep]), to_numpy(clean.x[keep]),
                               rtol=0, atol=1e-12)


def test_batched_run_block_resumes():
    """Blocks of 2 iterations give the state of one uninterrupted run,
    and a stopped row's counters stay where they stopped."""
    fn, x0, _ = _curve_fit(5, seed=3)
    config = t_lm.LMConfig(max_iterations=30)
    whole = t_lm.lm_run_block(fn, t_lm.lm_init(fn, x0, config), config)
    state = t_lm.lm_init(fn, x0, config)
    limit = 0
    while bool(((state.stop == 0) & (state.it < 30)).any()):
        limit += 2
        state = t_lm.lm_run_block(fn, state, config, limit)
        assert int(state.it.max()) <= limit
    for name in ("x", "cost", "mu", "nu", "it", "nfev", "njev", "stop"):
        np.testing.assert_array_equal(to_numpy(getattr(state, name)),
                                      to_numpy(getattr(whole, name)), name)
