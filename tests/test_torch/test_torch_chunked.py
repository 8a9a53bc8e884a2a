"""The block-resumable solve loops and the checkpoints of the torch
port, against its own fused solve and against the JAX package.

One BA-shaped shot (6 frames, 5 bundles, float64, the shot of
test_torch_ba_bridge) goes through solve() on the dense LM and on the
Schur BA.  A hooked solve must equal the unhooked one exactly (same
body, same number of times); the callback sequence, an interrupt and a
zero time budget must give the JAX package's result fields (counts and
strings equal, deviations and costs at 1e-8).  A checkpoint written by
either package resumes in the other to the uninterrupted solve's end
(parameters at 1e-9: the packages part by round-off only).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.solver.ba as t_ba
import mayamatchmovesolver_torch.solver.checkpoint as t_checkpoint
import mayamatchmovesolver_torch.solver.lm as t_lm
import mayamatchmovesolver_torch.solver.problem as t_problem
import mayamatchmovesolver_tpu.solver.checkpoint as j_checkpoint
from _torch_port_cases import to_numpy
from mayamatchmovesolver_torch.solver import registry as t_registry
from test_torch_ba_bridge import BRIDGE, FRAMES, SOLVE, _shot

t_solve, j_solve = SOLVE["torch"], SOLVE["jax"]
TOL = 1e-8
RESUME_TOL = 1e-9
ROUTES = {"dense": t_registry.SOLVER_TYPE_LM_DENSE,
          "ba": t_registry.SOLVER_TYPE_BA_SCHUR}
ROUTE_NAMES = {"dense": "lm_jax", "ba": "ba_schur"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shots():
    return {pkg: _shot(pkg, perturb=True) for pkg in ("jax", "torch")}


def _solve(shots, pkg, route, **options):
    scene, attrs, lens, solve_attrs, extra, _ = shots[pkg]
    mod = SOLVE[pkg]
    attrs_out, result = mod.solve(
        scene, attrs, np.arange(FRAMES), solve_attrs,
        mod.SolverOptions(image_width=1920.0, solver_type=ROUTES[route],
                          **options),
        lens=lens, **extra)
    assert result.solver_type_name == ROUTE_NAMES[route]
    return attrs_out, result


@pytest.fixture(scope="module")
def unhooked(shots):
    return {route: _solve(shots, "torch", route) for route in ROUTES}


def _assert_fields_match(t_res, j_res):
    for name in ("success", "stop_reason", "reason_string", "iterations",
                 "function_evals", "jacobian_evals", "user_interrupted",
                 "solver_type_name"):
        assert getattr(t_res, name) == getattr(j_res, name), name
    for name in ("error_initial", "error_final", "error_avg", "error_min",
                 "error_max"):
        assert abs(getattr(t_res, name) - getattr(j_res, name)) < TOL, name


@pytest.mark.parametrize("route", list(ROUTES))
def test_hooked_solve_equals_unhooked(shots, unhooked, route):
    calls = []
    attrs_out, result = _solve(
        shots, "torch", route, callback_interval=2,
        iteration_callback=lambda it, cost: calls.append((it, cost)),
        interrupt_check=lambda: False, max_seconds=3600.0)
    want_attrs, want = unhooked[route]
    assert not result.user_interrupted and result.success
    assert result.iterations == want.iterations > 2
    for name in ("stop_reason", "reason_string", "function_evals",
                 "jacobian_evals", "error_initial", "error_final",
                 "error_min", "error_max"):
        assert getattr(result, name) == getattr(want, name), name
    np.testing.assert_array_equal(result.solved_parameters,
                                  want.solved_parameters)
    assert torch.equal(attrs_out.static_values, want_attrs.static_values)
    assert torch.equal(attrs_out.anim_values, want_attrs.anim_values)
    its = [it for it, _ in calls]
    costs = [cost for _, cost in calls]
    assert its == sorted(set(its)) and its[-1] == want.iterations
    assert its[:-1] == list(range(2, its[-1], 2))
    assert all(b <= a for a, b in zip(costs, costs[1:]))
    assert all(isinstance(c, float) for c in costs)


@pytest.mark.parametrize("route", list(ROUTES))
def test_callback_sequence_matches_jax(shots, route):
    calls = {"jax": [], "torch": []}
    results = {}
    for pkg in calls:
        _, results[pkg] = _solve(
            shots, pkg, route, callback_interval=3,
            iteration_callback=lambda it, cost, log=calls[pkg]: log.append(
                (it, cost)))
    assert [it for it, _ in calls["torch"]] == [it for it, _ in calls["jax"]]
    np.testing.assert_allclose([c for _, c in calls["torch"]],
                               [c for _, c in calls["jax"]], rtol=1e-8,
                               atol=1e-12)
    _assert_fields_match(results["torch"], results["jax"])


@pytest.mark.parametrize("hook", ["interrupt", "max_seconds"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_interrupted_solve_matches_jax(shots, unhooked, route, hook):
    if hook == "interrupt":
        options = dict(callback_interval=2, interrupt_check=lambda: True)
    else:
        options = dict(callback_interval=1, max_seconds=0.0)
    t_attrs, t_res = _solve(shots, "torch", route, **options)
    j_attrs, j_res = _solve(shots, "jax", route, **options)
    assert t_res.user_interrupted
    assert t_res.iterations == options["callback_interval"]
    assert t_res.iterations < unhooked[route][1].iterations
    assert t_res.reason_string.startswith("user interrupted")
    assert t_res.error_final <= t_res.error_initial
    _assert_fields_match(t_res, j_res)
    np.testing.assert_allclose(to_numpy(t_attrs.static_values),
                               np.asarray(j_attrs.static_values), atol=TOL)
    np.testing.assert_allclose(to_numpy(t_attrs.anim_values),
                               np.asarray(j_attrs.anim_values), atol=TOL)


def test_interrupt_is_not_asked_after_convergence(shots, unhooked):
    """A solve that converges inside a block reports its own stop reason,
    and the interrupt check of that block is never called."""
    asked = []
    iterations = unhooked["dense"][1].iterations
    _, result = _solve(
        shots, "torch", "dense", callback_interval=iterations,
        interrupt_check=lambda: asked.append(1) or True)
    assert not asked and not result.user_interrupted
    assert result.reason_string == unhooked["dense"][1].reason_string


# ---- Checkpoints. --------------------------------------------------------


def _lm_problems(shots):
    out = {}
    for pkg in ("jax", "torch"):
        scene, attrs, lens, solve_attrs, extra, _ = shots[pkg]
        mod = SOLVE[pkg]
        out[pkg] = mod.build_problem(
            scene, attrs, np.arange(FRAMES), solve_attrs,
            mod.SolverOptions(image_width=1920.0), lens=lens, **extra)
    return out


J_LM_CFG = (20, 1e-3, 1e-6, 1e-6, 1e-6, "fwd")


def test_lm_checkpoints_cross_the_packages(shots, tmp_path):
    problems = _lm_problems(shots)
    config = t_lm.LMConfig()
    fn = t_problem.residual_fn(problems["torch"])
    t_init = t_lm.lm_init(fn, t_problem.initial_parameters(problems["torch"]),
                          config)
    t_mid = t_lm.lm_run_block(fn, t_init, config, 2)
    t_end = t_lm.lm_run_block(fn, t_mid, config)
    j_init, _ = j_solve._lm_init_jit(problems["jax"], J_LM_CFG)
    j_mid = j_solve._lm_block_jit(problems["jax"], J_LM_CFG, j_init,
                                  jnp.asarray(2, jnp.int32))
    j_end = j_solve._lm_block_jit(problems["jax"], J_LM_CFG, j_mid,
                                  jnp.asarray(20, jnp.int32))
    assert int(t_mid.it) == 2 and int(t_end.it) == int(j_end.it) > 2

    # JAX writes, the port resumes.
    path = tmp_path / "from_jax.npz"
    j_checkpoint.save_lm_state(path, j_mid, metadata={"shot": "a", "n": 2})
    state, meta = t_checkpoint.load_lm_state(path, device="cpu")
    assert meta == {"shot": "a", "n": 2}
    for f in dataclasses.fields(state):
        want = np.asarray(getattr(j_mid, f.name))
        got = getattr(state, f.name)
        assert got.shape == want.shape and got.device.type == "cpu", f.name
        assert to_numpy(got).dtype == want.dtype, f.name
    resumed = t_lm.lm_run_block(fn, state, config)
    for name in ("it", "nfev", "njev", "stop"):
        assert int(getattr(resumed, name)) == int(getattr(t_end, name)), name
    np.testing.assert_allclose(to_numpy(resumed.x), to_numpy(t_end.x),
                               rtol=0, atol=RESUME_TOL)

    # The port writes, JAX resumes.
    path = tmp_path / "from_torch.npz"
    t_checkpoint.save_lm_state(path, t_mid, metadata={"shot": "b"})
    state, meta = j_checkpoint.load_lm_state(path)
    assert meta == {"shot": "b"}
    assert state.it.dtype == jnp.int32 and state.x.dtype == jnp.float64
    resumed = j_solve._lm_block_jit(problems["jax"], J_LM_CFG, state,
                                    jnp.asarray(20, jnp.int32))
    for name in ("it", "nfev", "njev", "stop"):
        assert int(getattr(resumed, name)) == int(getattr(j_end, name)), name
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(j_end.x),
                               rtol=0, atol=RESUME_TOL)

    # The port's own round trip is exact.
    state, _ = t_checkpoint.load_lm_state(path, device="cpu")
    again = t_lm.lm_run_block(fn, state, config)
    assert torch.equal(again.x, t_end.x) and torch.equal(again.cost,
                                                         t_end.cost)


def test_ba_checkpoints_cross_the_packages(shots, tmp_path):
    bridges = {}
    for pkg in ("jax", "torch"):
        scene, attrs, lens, solve_attrs, extra, _ = shots[pkg]
        bridges[pkg], reason = BRIDGE[pkg].build_ba_bridge(
            scene, attrs, np.arange(FRAMES), solve_attrs,
            SOLVE[pkg].SolverOptions(image_width=1920.0), lens=lens, **extra)
        assert bridges[pkg] is not None, reason
    t_prob, j_prob = bridges["torch"].problem, bridges["jax"].problem
    kw = dict(max_iterations=20, eps1=1e-6, eps2=1e-6, eps3=1e-6,
              linear_solver="cholesky")
    j_cfg = (20, 1e-3, 1e-6, 1e-6, 1e-6, "cholesky", 30)
    t_mid = t_ba.ba_run_block(t_prob, t_ba.ba_init(t_prob), 2, **kw)
    t_end = t_ba.ba_run_block(t_prob, t_mid, 20, **kw)
    j_mid = j_solve._ba_block_jit(j_prob, j_cfg, j_solve._ba_init_jit(
        j_prob, j_cfg), jnp.asarray(2, jnp.int32))
    j_end = j_solve._ba_block_jit(j_prob, j_cfg, j_mid,
                                  jnp.asarray(20, jnp.int32))
    assert int(t_mid.it) == 2 and int(t_end.it) == int(j_end.it) > 2

    path = tmp_path / "ba_from_jax.npz"
    j_checkpoint.save_ba_state(path, j_mid, metadata={"route": "ba"})
    state, meta = t_checkpoint.load_ba_state(path, device="cpu")
    assert meta == {"route": "ba"}
    assert state.it.dtype == torch.int32 and state.cam.dtype == torch.float64
    resumed = t_ba.ba_run_block(t_prob, state, 20, **kw)
    for name in ("it", "nfev", "njev", "stop"):
        assert int(getattr(resumed, name)) == int(getattr(t_end, name)), name
    for name in ("cam", "bnd", "sh"):
        np.testing.assert_allclose(
            to_numpy(getattr(resumed, name)), to_numpy(getattr(t_end, name)),
            rtol=0, atol=RESUME_TOL, err_msg=name)

    path = tmp_path / "ba_from_torch.npz"
    t_checkpoint.save_ba_state(path, t_mid)
    state, meta = j_checkpoint.load_ba_state(path)
    assert meta == {}
    resumed = j_solve._ba_block_jit(j_prob, j_cfg, state,
                                    jnp.asarray(20, jnp.int32))
    for name in ("it", "nfev", "njev", "stop"):
        assert int(getattr(resumed, name)) == int(getattr(j_end, name)), name
    for name in ("cam", "bnd", "sh"):
        np.testing.assert_allclose(
            np.asarray(getattr(resumed, name)),
            np.asarray(getattr(j_end, name)), rtol=0, atol=RESUME_TOL,
            err_msg=name)


def test_attr_and_solve_state_files_cross_the_packages(shots, tmp_path):
    j_attrs, t_attrs = shots["jax"][1], shots["torch"][1]
    params = np.linspace(0.0, 1.0, 5)

    path = tmp_path / "attrs_from_jax.npz"
    j_checkpoint.save_attrs(path, j_attrs, metadata={"frames": [1, 6]})
    got, meta = t_checkpoint.load_attrs(path, device="cpu")
    assert meta == {"frames": [1, 6]}
    assert torch.equal(got.static_values, t_attrs.static_values)
    np.testing.assert_array_equal(to_numpy(got.anim_values),
                                  np.asarray(j_attrs.anim_values))

    path = tmp_path / "attrs_from_torch.npz"
    t_checkpoint.save_attrs(path, t_attrs)
    got, meta = j_checkpoint.load_attrs(path)
    assert meta == {}
    np.testing.assert_array_equal(np.asarray(got.static_values),
                                  to_numpy(t_attrs.static_values))

    path = tmp_path / "solve_from_jax.npz"
    j_checkpoint.save_solve_state(path, j_attrs, params=params, iteration=7,
                                  cost=1.5, extra={"note": "x"})
    got, got_params, meta = t_checkpoint.load_solve_state(path, device="cpu")
    assert meta == {"note": "x", "iteration": 7, "cost": 1.5}
    np.testing.assert_array_equal(got_params, params)
    np.testing.assert_array_equal(to_numpy(got.anim_values),
                                  np.asarray(j_attrs.anim_values))

    path = tmp_path / "solve_from_torch.npz"
    t_checkpoint.save_solve_state(path, t_attrs, params=torch.as_tensor(
        params), iteration=3)
    got, got_params, meta = j_checkpoint.load_solve_state(path)
    assert meta == {"iteration": 3}
    np.testing.assert_array_equal(got_params, params)
    t_checkpoint.save_solve_state(path, t_attrs)
    assert t_checkpoint.load_solve_state(path, device="cpu")[1] is None


def _rewrite(path, out, drop=(), **replace):
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files if k not in drop}
    arrays.update(replace)
    np.savez_compressed(out, **arrays)
    return out


def test_checkpoint_missing_field_rules(shots, tmp_path):
    problems = _lm_problems(shots)
    fn = t_problem.residual_fn(problems["torch"])
    state = t_lm.lm_run_block(
        fn, t_lm.lm_init(fn, t_problem.initial_parameters(problems["torch"])),
        t_lm.LMConfig(), 1)
    path = tmp_path / "lm.npz"
    t_checkpoint.save_lm_state(path, state)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["format_version", "metadata"]
            + ["lm_" + f.name for f in dataclasses.fields(state)])
        assert int(data["format_version"]) == j_checkpoint.FORMAT_VERSION
        assert json.loads(str(data["metadata"])) == {}

    # An old file without the evaluation counters: they start at 1.
    old = _rewrite(path, tmp_path / "old.npz", drop=("lm_nfev", "lm_njev"))
    loaded, _ = t_checkpoint.load_lm_state(old, device="cpu")
    assert int(loaded.nfev) == int(loaded.njev) == 1
    assert loaded.nfev.dtype == torch.int32
    assert torch.equal(loaded.x, state.x) and int(loaded.it) == 1
    # Any other missing field is an error, not a zero.
    for field in ("lm_mu", "lm_x", "lm_stop"):
        broken = _rewrite(path, tmp_path / "broken.npz", drop=(field,))
        with pytest.raises(ValueError, match=field):
            t_checkpoint.load_lm_state(broken, device="cpu")
    future = _rewrite(path, tmp_path / "future.npz", format_version=2)
    with pytest.raises(ValueError, match="unsupported checkpoint version: 2"):
        t_checkpoint.load_lm_state(future, device="cpu")

    attrs_path = tmp_path / "solve.npz"
    t_checkpoint.save_solve_state(attrs_path, shots["torch"][1])
    future = _rewrite(attrs_path, tmp_path / "future_solve.npz",
                      format_version=3)
    for load in (t_checkpoint.load_attrs, t_checkpoint.load_solve_state):
        with pytest.raises(ValueError, match="version: 3"):
            load(future, device="cpu")

    ba_path = tmp_path / "ba.npz"
    bridge, _ = BRIDGE["torch"].build_ba_bridge(
        shots["torch"][0], shots["torch"][1], np.arange(FRAMES),
        shots["torch"][3], t_solve.SolverOptions(image_width=1920.0),
        lens=shots["torch"][2])
    t_checkpoint.save_ba_state(ba_path, t_ba.ba_init(bridge.problem))
    broken = _rewrite(ba_path, tmp_path / "ba_broken.npz", drop=("ba_gnorm",))
    with pytest.raises(ValueError, match="ba_gnorm"):
        t_checkpoint.load_ba_state(broken, device="cpu")
    # A BA file without the counters resumes with those of ba_init, which
    # has evaluated the cost once and assembled no block yet.
    old = _rewrite(ba_path, tmp_path / "ba_old.npz",
                   drop=("ba_nfev", "ba_njev"))
    loaded, _ = t_checkpoint.load_ba_state(old, device="cpu")
    fresh = t_ba.ba_init(bridge.problem)
    assert (int(loaded.nfev), int(loaded.njev)) == (1, 0)
    assert (int(fresh.nfev), int(fresh.njev)) == (1, 0)
