"""Agreement of the port's frame-sharded solvers (parallel/) with the JAX
package at world size 1.

The cases of tests/test_parallel/test_sharded.py run on both packages
from the same numpy arrays, float64: the JAX side on a mesh of
jax.devices()[:1], the port in this process with no process group (world
size 1, identity collectives).  Both must take the same iterations to the
same stop reason with the same counters, and give cost and border
within 1e-10 relative: each tensor against its largest entry, the cost
against the initial cost (a converged cost is round-off).  Cameras and
bundles that are all free are defined only up to a similarity of the
world, and the fixed-count CG, which runs on past convergence, moves each
package along it by its own round-off (5e-5 scene units over the border
case's 26 iterations); they are held, within 1e-10 of the largest, by
what the gauge cannot move: the projection of every bundle in every
frame.  Where the solve stops before CG runs dry (the early-stop case)
they are also held directly.  The refusals give the same messages.
Multi-rank runs are in test_torch_multihost.py.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.parallel as t_parallel
import mayamatchmovesolver_torch.solver.ba as t_ba
import mayamatchmovesolver_torch.solver.problem as t_problem
import mayamatchmovesolver_tpu.parallel as j_parallel
import mayamatchmovesolver_tpu.solver.ba as j_ba
import mayamatchmovesolver_tpu.solver.problem as j_problem
from _torch_sharded_cases import (
    BA_CASES,
    BA_ITERATIONS,
    assert_agree,
    ba_arrays,
    ba_problem,
    close,
    static_lm_problem,
)
from mayamatchmovesolver_torch.parallel import ba_sharded as t_ba_sharded
from mayamatchmovesolver_tpu.parallel import ba_sharded as j_ba_sharded

TOL = 1e-10
FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, scale=None, err_msg=""):
    close(got, want, TOL, scale, err_msg)


@functools.lru_cache(maxsize=None)
def jax_sharded_ba(num_devices):
    """The JAX package's sharded_solve_ba on a mesh of the first
    `num_devices` devices, jitted: its shard_map run eagerly dispatches
    every operation on its own (25 s a solve on the CPU, 3 s jitted)."""
    mesh = j_parallel.make_frame_mesh(jax.devices()[:num_devices])
    return jax.jit(functools.partial(
        j_ba_sharded.sharded_solve_ba, mesh=mesh,
        max_iterations=BA_ITERATIONS), static_argnames=("cg_iterations",))


def _solve_both(case):
    kwargs, replace = ba_arrays(case, FRAMES)
    cg = BA_CASES[case][-1]
    j_prob = ba_problem(j_ba, kwargs, replace)
    j_res = jax_sharded_ba(1)(j_prob, cg_iterations=cg)
    t_prob = ba_problem(t_ba, kwargs, replace, device="cpu")
    t_mesh = t_parallel.make_frame_mesh("cpu")
    assert t_mesh.size == 1 and t_mesh.group is None
    t_res = t_ba_sharded.sharded_solve_ba(
        t_ba_sharded.shard_ba_problem(t_prob, t_mesh), t_mesh,
        max_iterations=BA_ITERATIONS, cg_iterations=cg)
    return j_prob, j_res, t_prob, t_res


@pytest.mark.parametrize("case", list(BA_CASES))
def test_sharded_ba_matches(case):
    j_prob, j_res, t_prob, t_res = _solve_both(case)
    assert_agree(t_prob, t_res, j_res, TOL, direct=case == "early")
    cost, cost0 = float(t_res.cost), float(t_res.cost_initial)
    if case == "converge":
        assert cost < 1e-8 * cost0, (cost, cost0)
        dense = t_ba.solve_ba(t_prob, max_iterations=30)
        assert float(dense.cost) < 1e-8 * float(dense.cost_initial)
    elif case == "border":
        # Observations were synthesized at the intrinsics' 35 mm.
        assert abs(float(t_res.shared_params[0]) - 35.0) < 0.3
        dense = t_ba.solve_ba(t_prob, max_iterations=30)
        assert abs(float(t_res.shared_params[0])
                   - float(dense.shared_params[0])) < 0.05
    elif case == "robust":
        # The cost the sharded loop minimized is the robust objective, and
        # it differs from the trivial-loss cost of the same solution.
        args = (t_res.cam_params, t_res.bnd_params, t_res.shared_params)
        robust = float(t_ba.ba_cost(t_prob, *args))
        np.testing.assert_allclose(cost, robust, rtol=1e-5)
        trivial = float(t_ba.ba_cost(t_prob._replace(loss_type=0), *args))
        assert abs(robust - trivial) > 1e-3 * trivial
        dense = t_ba.solve_ba(t_prob, max_iterations=30)
        np.testing.assert_allclose(t_res.cam_params.numpy(),
                                   dense.cam_params.numpy(), atol=2e-4)
    else:
        assert int(t_res.stop_reason) in (1, 2, 3)
        assert int(t_res.iterations) < 15


def test_sharded_lm_static_params_matches():
    """The generic frame-sharded LM over static attrs, against the JAX
    one and the truth, with real counters."""
    n = 4
    j_prob = static_lm_problem("jax", n)
    mesh = j_parallel.make_frame_mesh(jax.devices()[:1])
    j_prob = j_parallel.shard_problem_arrays(j_prob, mesh)
    j_state = jax.jit(functools.partial(
        j_parallel.sharded_levenberg_marquardt, mesh=mesh,
        max_iterations=30))(j_prob, j_problem.initial_parameters(j_prob))
    t_prob = static_lm_problem("torch", n)
    t_mesh = t_parallel.make_frame_mesh("cpu")
    t_prob = t_parallel.shard_problem_arrays(t_prob, t_mesh)
    t_state = t_parallel.sharded_levenberg_marquardt(
        t_prob, t_problem.initial_parameters(t_prob), t_mesh,
        max_iterations=30)
    np.testing.assert_allclose(float(t_state.params[0]), 0.5, atol=1e-5)
    for name in ("it", "stop", "nfev", "njev"):
        assert int(getattr(t_state, name)) == int(getattr(j_state, name))
    assert int(t_state.nfev) == int(t_state.it) + 1 == int(t_state.njev)
    _close(t_state.params, j_state.params, err_msg="params")
    r0 = t_problem.residual_fn(t_prob)(t_problem.initial_parameters(t_prob))
    _close(t_state.cost, j_state.cost, scale=float(0.5 * r0.dot(r0)),
           err_msg="cost")


def test_sharded_normal_system_matches():
    """The all-reduced normal system at world size 1 is the dense one."""
    j_prob, t_prob = static_lm_problem("jax", 4), static_lm_problem("torch", 4)
    x = np.array([0.7, 0.2])
    j_fn = j_parallel.sharded_normal_system(
        j_prob, j_parallel.make_frame_mesh(jax.devices()[:1]))
    t_fn = t_parallel.sharded_normal_system(
        t_prob, t_parallel.make_frame_mesh("cpu"))
    for name, got, want in zip(("cost", "jtj", "jtr"),
                               t_fn(torch.as_tensor(x)),
                               j_fn(jnp.asarray(x))):
        _close(got, want, err_msg=name)


def test_refusals_match():
    """Frame counts the mesh does not divide, and multi-camera rigs, are
    refused with the reference's words."""
    three = types.SimpleNamespace(size=3)
    kwargs, replace = ba_arrays("converge", FRAMES)
    j_prob = ba_problem(j_ba, kwargs, replace)
    t_prob = ba_problem(t_ba, kwargs, replace, device="cpu")
    messages = []
    for fn, prob, mesh in (
            (j_ba_sharded.sharded_solve_ba, j_prob,
             j_parallel.make_frame_mesh(jax.devices()[:3])),
            (t_ba_sharded.sharded_solve_ba, t_prob, three),
            (j_parallel.sharded_normal_system, static_lm_problem("jax", 4),
             j_parallel.make_frame_mesh(jax.devices()[:3])),
            (t_parallel.sharded_normal_system, static_lm_problem("torch", 4),
             three)):
        with pytest.raises(ValueError) as info:
            fn(prob, mesh)
        messages.append(str(info.value))
    assert messages[0] == messages[1] == (
        "frame count 8 not divisible by 3 devices")
    assert messages[2] == messages[3] == (
        "frame count 4 not divisible by 3 devices — pad frames")

    rig = dict(kwargs, cam_params=np.concatenate([kwargs["cam_params"]] * 2),
               mkr_cam_index=np.arange(10) % 2)
    rig_messages = []
    for ba_mod, sharded, mesh, extra in (
            (j_ba, j_ba_sharded,
             j_parallel.make_frame_mesh(jax.devices()[:1]), {}),
            (t_ba, t_ba_sharded, t_parallel.make_frame_mesh("cpu"),
             {"device": "cpu"})):
        with pytest.raises(ValueError) as info:
            sharded.sharded_solve_ba(ba_mod.make_ba_problem(**rig, **extra),
                                     mesh)
        rig_messages.append(str(info.value))
    assert rig_messages[0] == rig_messages[1]
    assert rig_messages[1].startswith(
        "the frame-sharded BA supports one camera per problem")
