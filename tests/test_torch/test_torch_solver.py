"""Agreement of the torch port's dense solve with the JAX package.

Residuals and deviation stats at 1e-10 (float64; relative as well as
absolute, since behind-camera residuals are scaled by 1e6), the normal
system (r, JtJ, Jtr) at rtol 1e-8, and a full lens + focal solve that
must take the same iterations to the same stop reason and land within
1e-6.  Robust losses are compared without behind-camera markers: at
|r| ~ 1e9 the loss rescaling cancels in any implementation (the JAX
package's own tests exclude that case too).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.solver.lm as t_lm
import mayamatchmovesolver_torch.solver.problem as t_problem
import mayamatchmovesolver_tpu.solver.lm as j_lm
import mayamatchmovesolver_tpu.solver.problem as j_problem
from _torch_port_cases import lens_focal_scene, rich_scene, to_numpy
from mayamatchmovesolver_torch.solver import registry as t_registry
from mayamatchmovesolver_tpu.solver.loss import RobustLossType

# The solver packages export solve() under the name of its module.
t_solve = importlib.import_module("mayamatchmovesolver_torch.solver.solve")
j_solve = importlib.import_module("mayamatchmovesolver_tpu.solver.solve")

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rich_problems(loss_type):
    """The rich scene as a problem in both packages, with line and
    stiffness terms; the markers of the behind-camera bundle are masked
    out for the robust losses."""
    problems = []
    for pkg, solve_mod in (("jax", j_solve), ("torch", t_solve)):
        sg, scene, attrs, lens, h = rich_scene(pkg)
        cam0, cam1 = h["cams"]
        solve_attrs = [cam0.attr("tx"), cam0.attr("ry"),
                       cam0.attr("focal_length_mm"), cam1.attr("lens_degree2_distortion"),
                       h["bundles"][0].attr("tx"), h["chain"][1].attr("ty")]
        n = attrs.num_frames
        stiff = j_solve.build_stiffness(
            None, solve_attrs, range(n), weight=0.5, variance=2.0)
        smooth = j_solve.build_stiffness(
            None, solve_attrs, range(n), weight=0.3, mode="smoothness")
        stiffness = j_solve.merge_stiffness(stiff, smooth)
        m = h["markers"]
        sg.create_line("line", [m[0], m[2], m[4], m[6]])
        mask = np.ones((scene.num_markers, n), bool)
        if loss_type != RobustLossType.TRIVIAL:
            mask[-2:] = False  # the behind-camera bundle's markers
        options = solve_mod.SolverOptions(
            image_width=1920.0, robust_loss_type=loss_type,
            robust_loss_scale=3.0)
        problems.append(solve_mod.build_problem(
            scene, attrs, np.arange(n), solve_attrs, options,
            marker_frame_mask=mask, stiffness=stiffness, lens=lens,
            lines=sg.line_spec()))
    return problems


@pytest.mark.parametrize("loss_type", list(RobustLossType))
def test_measure_residuals_matches(loss_type):
    j_prob, t_prob = _rich_problems(loss_type)
    assert t_prob.num_line_errors > 0 and t_prob.stiff_codes.shape[0] > 0
    j_r, j_aux = jax.jit(j_problem.measure_residuals)(j_prob, j_prob.attrs)
    t_r, t_aux = t_problem.measure_residuals(t_prob, t_prob.attrs)
    np.testing.assert_allclose(to_numpy(t_r), np.asarray(j_r), rtol=TOL,
                               atol=TOL)
    for key in j_aux:
        np.testing.assert_allclose(
            to_numpy(t_aux[key]), np.asarray(j_aux[key]), rtol=TOL,
            atol=TOL, err_msg=key)
    # residual_fn at the initial parameters is measure_residuals' vector.
    x0 = t_problem.initial_parameters(t_prob)
    np.testing.assert_allclose(
        to_numpy(t_problem.residual_fn(t_prob)(x0)), to_numpy(t_r),
        rtol=TOL, atol=TOL)


def test_parameters_round_trip_matches():
    j_prob, t_prob = _rich_problems(RobustLossType.TRIVIAL)
    np.testing.assert_allclose(
        to_numpy(t_problem.initial_parameters(t_prob)),
        np.asarray(j_problem.initial_parameters(j_prob)), atol=TOL)
    x = np.random.RandomState(2).uniform(-2, 2, t_prob.num_params)
    j_attrs = j_problem.insert_parameters(j_prob, jnp.asarray(x))
    t_attrs = t_problem.insert_parameters(t_prob, torch.as_tensor(x))
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(
            to_numpy(getattr(t_attrs, field)),
            np.asarray(getattr(j_attrs, field)), atol=TOL)


@pytest.fixture(scope="module")
def lens_focal():
    return lens_focal_scene("jax"), lens_focal_scene("torch")


def _problems(lens_focal, frames=None):
    out = []
    for (scene, attrs, lens, solve_attrs, _), solve_mod in zip(
            lens_focal, (j_solve, t_solve)):
        options = solve_mod.SolverOptions(image_width=1920.0)
        n = attrs.num_frames if frames is None else frames
        out.append(solve_mod.build_problem(
            scene, attrs, np.arange(n), solve_attrs, options, lens=lens))
    return out


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_normal_system_matches(lens_focal, mode):
    j_prob, t_prob = _problems(lens_focal)
    x = np.asarray(j_problem.initial_parameters(j_prob))
    x = x + np.random.RandomState(4).normal(0.0, 1e-3, x.shape)
    want = jax.jit(j_lm._make_normal_system(
        j_problem.residual_fn(j_prob), mode))(jnp.asarray(x))
    got = t_lm._make_normal_system(
        t_problem.residual_fn(t_prob), mode)(torch.as_tensor(x))
    for name, a, b in zip(("r", "JtJ", "Jtr"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(
            to_numpy(a), b, rtol=1e-8, atol=1e-8 * np.abs(b).max(),
            err_msg=name)


def test_solve_damped_matches_and_flags_failure():
    rng = np.random.RandomState(0)
    j = rng.normal(size=(30, 8)) * rng.uniform(0.01, 100.0, 8)
    jtj, jtr = j.T @ j, j.T @ rng.normal(size=30)
    want = np.asarray(j_lm._solve_damped(jnp.asarray(jtj), jnp.asarray(jtr),
                                         1e-3))
    got = t_lm._solve_damped(torch.as_tensor(jtj), torch.as_tensor(jtr),
                             torch.tensor(1e-3, dtype=torch.float64))
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-8)
    bad = t_lm._solve_damped(-torch.as_tensor(jtj), torch.as_tensor(jtr),
                             torch.tensor(1e-3, dtype=torch.float64))
    assert torch.isnan(bad).all()


def test_solve_matches(lens_focal):
    (j_sc, j_at, j_lens, j_sa, truth), (t_sc, t_at, t_lens, t_sa, _) = \
        lens_focal
    n = j_at.num_frames
    j_attrs, j_res = j_solve.solve(
        j_sc, j_at, np.arange(n), j_sa,
        j_solve.SolverOptions(image_width=1920.0), lens=j_lens)
    t_attrs, t_res = t_solve.solve(
        t_sc, t_at, np.arange(n), t_sa,
        t_solve.SolverOptions(image_width=1920.0), lens=t_lens)
    assert j_res.success and t_res.success
    assert t_res.iterations == j_res.iterations
    assert t_res.stop_reason == j_res.stop_reason
    assert t_res.function_evals == j_res.function_evals
    assert t_res.jacobian_evals == j_res.jacobian_evals
    assert t_res.solver_type_name == j_res.solver_type_name == "lm_jax"
    assert t_res.reason_string == j_res.reason_string
    assert abs(t_res.error_initial - j_res.error_initial) < 1e-6
    assert abs(t_res.error_final - j_res.error_final) < 1e-6
    np.testing.assert_allclose(t_res.solved_parameters,
                               np.asarray(j_res.solved_parameters), atol=1e-6)
    np.testing.assert_allclose(to_numpy(t_attrs.static_values),
                               np.asarray(j_attrs.static_values), atol=1e-6)
    np.testing.assert_allclose(t_res.per_frame_error.errors,
                               j_res.per_frame_error.errors, atol=1e-6)
    assert t_res.per_marker_error.keys() == j_res.per_marker_error.keys()
    focal = float(t_attrs.static_values[truth["focal_index"]])
    assert abs(focal - truth["focal"]) < 1e-3


def test_refusal_string_matches(lens_focal):
    (j_sc, j_at, j_lens, j_sa, _), (t_sc, t_at, t_lens, t_sa, _) = lens_focal
    results = []
    for scene, attrs, lens, sa, solve_mod in (
            (j_sc, j_at, j_lens, j_sa, j_solve),
            (t_sc, t_at, t_lens, t_sa, t_solve)):
        # 12 errors (6 markers x 1 frame x 2) for 8 parameters would
        # solve; every camera channel animated over 2 frames is 14.
        attrs_out, result = solve_mod.solve(
            scene, attrs, [0], sa * 2, solve_mod.SolverOptions(),
            lens=lens, marker_frame_mask=np.ones((6, 1), bool))
        assert attrs_out is attrs
        results.append(result)
    assert not results[1].success
    assert results[1].reason_string == results[0].reason_string
    assert results[1].reason_string == "cannot solve: 12 errors < 16 parameters"
    assert (results[1].as_key_value_strings()
            == results[0].as_key_value_strings())


def _assert_same_result(t_res, j_res, tol=1e-6):
    """Equal result strings, but for the timers and the error values,
    which agree within `tol` px."""
    def split(res):
        lines = [ln for ln in res.as_key_value_strings()
                 if not ln.startswith(("timer_", "error_"))]
        errors = [res.error_initial, res.error_final, res.error_avg,
                  res.error_max, res.error_min] + res.per_frame_error.errors
        return lines, errors

    (t_lines, t_err), (j_lines, j_err) = split(t_res), split(j_res)
    assert t_lines == j_lines
    np.testing.assert_allclose(t_err, j_err, atol=tol)


@pytest.mark.parametrize("option,value,match", [
    ("solver_type", t_registry.SOLVER_TYPE_LM_SHARDED, "item 14"),
    ("solver_type", t_registry.SOLVER_TYPE_BA_SHARDED, "item 14"),
], ids=["solver_type-2-item 14", "solver_type-3-item 14"])
def test_solve_refuses_unported_options(lens_focal, option, value, match):
    """The sharded solver types, once refused (ROADMAP item 14), now give
    the JAX package's result.  lm_sharded with only the static focal and
    distortion solved runs the frame-sharded LM in both: the JAX package
    over its 8 test devices (a frame each), the port at world size 1 —
    the same arithmetic up to the order of a sum.  ba_schur_sharded on a
    solve without bundles falls back to the dense LM in both, with the
    bridge's reason."""
    results, attrs_out = [], []
    for (scene, attrs, lens, sa, _), solve_mod in zip(lens_focal,
                                                      (j_solve, t_solve)):
        if value == t_registry.SOLVER_TYPE_LM_SHARDED:
            sa = sa[6:]
        options = dataclasses.replace(
            solve_mod.SolverOptions(image_width=1920.0), **{option: value})
        out, result = solve_mod.solve(scene, attrs, np.arange(attrs.num_frames),
                                      sa, options, lens=lens)
        results.append(result)
        attrs_out.append(out)
    j_res, t_res = results
    assert t_res.success
    assert t_res.solver_type_name == (
        "lm_sharded" if value == t_registry.SOLVER_TYPE_LM_SHARDED
        else "lm_jax")
    _assert_same_result(t_res, j_res)
    np.testing.assert_allclose(t_res.solved_parameters,
                               np.asarray(j_res.solved_parameters), atol=1e-6)
    np.testing.assert_allclose(to_numpy(attrs_out[1].static_values),
                               np.asarray(attrs_out[0].static_values),
                               atol=1e-6)


@pytest.mark.parametrize("option,value", [
    ("iteration_callback", lambda it, cost: None),
    ("interrupt_check", lambda: False),
    ("max_seconds", 3600.0),
])
def test_solve_with_a_host_hook_equals_the_plain_solve(lens_focal, option,
                                                       value):
    """Each hook alone sends solve() through the block-resumable solve loop,
    which must give the fused solve's result exactly."""
    _, (scene, attrs, lens, sa, _) = lens_focal
    n = attrs.num_frames
    want_attrs, want = t_solve.solve(
        scene, attrs, np.arange(n), sa,
        t_solve.SolverOptions(image_width=1920.0), lens=lens)
    options = dataclasses.replace(
        t_solve.SolverOptions(image_width=1920.0), **{option: value})
    got_attrs, got = t_solve.solve(scene, attrs, np.arange(n), sa, options,
                                   lens=lens)
    assert not got.user_interrupted and got.solver_type_name == "lm_jax"
    assert got.iterations == want.iterations
    assert got.reason_string == want.reason_string
    assert got.error_final == want.error_final
    np.testing.assert_array_equal(got.solved_parameters,
                                  want.solved_parameters)
    assert torch.equal(got_attrs.static_values, want_attrs.static_values)


def test_solve_refuses_unported_default_solver(lens_focal, monkeypatch):
    """The registry default from the environment, once refused for the
    sharded types (ROADMAP item 14), picks ba_schur_sharded in both
    packages: a one-frame solve without bundles falls back to the dense
    LM with the same reason and result."""
    monkeypatch.setenv(t_registry.DEFAULT_SOLVER_ENV_VAR, "ba_schur_sharded")
    results = [solve_mod.solve(scene, attrs, [0], sa, lens=lens)[1]
               for (scene, attrs, lens, sa, _), solve_mod in zip(
                   lens_focal, (j_solve, t_solve))]
    assert "ba fallback to dense" in results[1].reason_string
    _assert_same_result(results[1], results[0])
