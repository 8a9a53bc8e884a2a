"""The port's multi-process layer (parallel/multihost.py) and its sharded
solvers over 2 and 4 gloo ranks on the CPU, held against the JAX package
on meshes of as many devices.

Each world size is one spawn of _torch_multihost_worker.py processes,
torch pinned to one thread, joined through `multihost.initialize` from
the torchrun variables (two "hosts" of two ranks at world size 4).  Every
rank runs the frame-sharded LM and the frame-sharded BA without and with
a border on the seeded problems of _torch_sharded_cases (8 frames: 4 or
2 a rank) and writes its results.  Every rank must hold the same results,
and they must agree with the JAX functions on jax.devices()[:2] and
[:4] in float64 within 1e-9 relative, with equal iterations, stop
reasons and counters (cameras and bundles through their projections, as
in test_torch_sharded.py).  The border case is the one that shows a
border inner product summed over the ranks (n times too large).
"""

import functools
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

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
from _torch_multihost_worker import FRAMES, WORKER_BA_CASES
from mayamatchmovesolver_torch.solver import ba as t_ba
from mayamatchmovesolver_tpu.parallel import ba_sharded as j_ba_sharded

TOL = 1e-9
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_multihost_worker.py")
SPAWN_TIMEOUT_S = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(world, out_dir):
    """The world's rank processes, started (two 'hosts' when world > 2)."""
    port = _free_port()
    local_world = 2
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank % local_world),
                   LOCAL_WORLD_SIZE=str(local_world), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(out_dir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs):
    """Every rank's (returncode, stdout, stderr); all ranks are killed
    when the spawn outlives SPAWN_TIMEOUT_S."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@functools.lru_cache(maxsize=None)
def _jax_results(world):
    """The JAX package's sharded LM and BAs on a mesh of `world` devices,
    jitted (see test_torch_sharded.jax_sharded_ba)."""
    mesh = j_parallel.make_frame_mesh(jax.devices()[:world])
    prob = j_parallel.shard_problem_arrays(_jax_lm_problem(), mesh)
    lm = jax.jit(functools.partial(
        j_parallel.sharded_levenberg_marquardt, mesh=mesh,
        max_iterations=30))(prob, j_problem.initial_parameters(prob))
    solve = jax.jit(functools.partial(
        j_ba_sharded.sharded_solve_ba, mesh=mesh,
        max_iterations=BA_ITERATIONS), static_argnames=("cg_iterations",))
    bas = {}
    for case in WORKER_BA_CASES:
        kwargs, replace = ba_arrays(case, FRAMES)
        bas[case] = solve(ba_problem(j_ba, kwargs, replace),
                          cg_iterations=BA_CASES[case][-1])
    return lm, bas


@functools.lru_cache(maxsize=None)
def _jax_lm_problem():
    return static_lm_problem("jax", FRAMES)


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def spawned(request, tmp_path_factory):
    """(world size, every rank's results), after one spawn; the JAX side
    is computed while the ranks run."""
    world = request.param
    out_dir = tmp_path_factory.mktemp("ranks%d" % world)
    procs = _start_ranks(world, out_dir)
    try:
        _jax_results(world)
    finally:
        outs = _wait(procs)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, (rank, rc, out[-2000:], err[-4000:])
        assert "WORKER_%d_OK" % rank in out
    return world, [dict(np.load(os.path.join(out_dir, "rank%d.npz" % r)))
                   for r in range(world)]


def test_every_rank_holds_the_same_results(spawned):
    world, ranks = spawned
    for rank in ranks[1:]:
        for key, value in ranks[0].items():
            if key not in ("is_primary",):
                np.testing.assert_array_equal(rank[key], value, err_msg=key)


def test_bootstrap_from_the_torchrun_variables(spawned):
    """initialize() joined every rank; rank 0 alone is primary; hosts and
    the host mesh follow LOCAL_WORLD_SIZE (2 ranks a host)."""
    world, ranks = spawned
    assert [bool(r["is_primary"]) for r in ranks] == [True] + [False] * (
        world - 1)
    for r in ranks:
        assert int(r["num_hosts"]) == world // 2
        assert tuple(r["host_mesh_shape"]) == (world // 2, 2)


def test_solve_routes_the_sharded_types(spawned):
    """solve() over the ranks: lm_sharded runs the frame-sharded LM (the
    iterations of the direct call), ba_schur_sharded the frame-sharded BA
    with the reference's zero counters."""
    _, ranks = spawned
    lm = list(ranks[0]["solve_lm_lines"])
    assert "solver_type=lm_sharded" in lm and "success=1" in lm
    assert "iteration_num=%d" % int(ranks[0]["lm_it"]) in lm
    ba = list(ranks[0]["solve_ba_lines"])
    assert "solver_type=ba_schur_sharded" in ba and "success=1" in ba
    assert "iteration_function_num=0" in ba
    assert "iteration_jacobian_num=0" in ba
    final = float(next(x for x in ba if x.startswith("error_final="))
                  .split("=")[1])
    assert final < 1e-6, ba


def test_sharded_lm_matches_the_jax_mesh(spawned):
    world, ranks = spawned
    lm, _ = _jax_results(world)
    got = ranks[0]
    for name in ("it", "stop", "nfev", "njev"):
        assert int(got["lm_" + name]) == int(getattr(lm, name)), name
    assert int(got["lm_nfev"]) == int(got["lm_it"]) + 1
    np.testing.assert_allclose(got["lm_params"][0], 0.5, atol=1e-5)
    close(got["lm_params"], lm.params, TOL, err_msg="params")
    prob = _jax_lm_problem()
    r0 = j_problem.residual_fn(prob)(j_problem.initial_parameters(prob))
    close(got["lm_cost"], lm.cost, TOL, scale=float(0.5 * r0.dot(r0)),
          err_msg="cost")


@pytest.mark.parametrize("case", WORKER_BA_CASES)
def test_sharded_ba_matches_the_jax_mesh(spawned, case):
    world, ranks = spawned
    _, bas = _jax_results(world)
    got = ranks[0]
    fields = {name[len(case) + 1:]: value for name, value in got.items()
              if name.startswith(case + "_")}
    kwargs, replace = ba_arrays(case, FRAMES)
    t_prob = ba_problem(t_ba, kwargs, replace, device="cpu")
    result = types.SimpleNamespace(**fields)
    assert_agree(t_prob, result, bas[case], TOL)
    assert float(result.cost) < 1e-8 * float(result.cost_initial)
    # gather_to_primary: the ranks' frame blocks, in rank order, are the
    # global cameras.
    assert fields["gathered"].shape == (FRAMES, 6)
    np.testing.assert_array_equal(fields["gathered"], fields["cam_params"])
