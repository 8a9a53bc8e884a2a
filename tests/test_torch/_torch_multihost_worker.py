"""One rank of test_torch_multihost.py's gloo process group, on the CPU.

Usage: python _torch_multihost_worker.py <output directory>

The rank, world size and address come from the torchrun variables
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE), which the test sets.  The rank joins the group through
parallel.multihost.initialize, runs the frame-sharded LM and two
frame-sharded BAs (without and with a border) on the seeded problems of
_torch_sharded_cases, exercises the multihost helpers, and writes what it
got to <output directory>/rank<r>.npz.  Imports no jax.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_sharded_cases import (  # noqa: E402
    BA_CASES,
    BA_ITERATIONS,
    ba_arrays,
    ba_problem,
    ba_scene,
    static_lm_scene,
)
from mayamatchmovesolver_torch.parallel import (  # noqa: E402
    ba_sharded,
    multihost,
    shard_problem_arrays,
    sharded_levenberg_marquardt,
)
from mayamatchmovesolver_torch.solver import (  # noqa: E402
    SolverOptions,
    ba,
    registry,
    solve,
)
from mayamatchmovesolver_torch.solver import problem as problem_mod  # noqa

FRAMES = 8
WORKER_BA_CASES = ("converge", "border")


def main(out_dir):
    torch.set_num_threads(1)
    assert multihost.initialize(device="cpu"), "no process group"
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    mesh = multihost.frame_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    out = {"is_primary": multihost.is_primary(),
           "num_hosts": multihost.num_hosts(),
           "host_mesh_shape": np.array(
               multihost.host_mesh(device_type="cpu").shape)}

    scene, attrs, solve_attrs, build_problem, options = static_lm_scene(
        "torch", FRAMES)
    lm_problem = shard_problem_arrays(
        build_problem(scene, attrs, np.arange(FRAMES), solve_attrs, options),
        mesh)
    # solve() with the sharded types: the frame-sharded LM, and the
    # frame-sharded BA of a BA-shaped shot (world size > 1).
    for name, (scene_, attrs_, solve_attrs_), solver_type in (
            ("lm", (scene, attrs, solve_attrs),
             registry.SOLVER_TYPE_LM_SHARDED),
            ("ba", ba_scene(FRAMES), registry.SOLVER_TYPE_BA_SHARDED)):
        _, result = solve(scene_, attrs_, np.arange(FRAMES), solve_attrs_,
                          SolverOptions(image_width=1920.0, iterations=30,
                                        solver_type=solver_type))
        out["solve_%s_lines" % name] = np.array([
            line for line in result.as_key_value_strings()
            if not line.startswith("timer_")])
    state = sharded_levenberg_marquardt(
        lm_problem, problem_mod.initial_parameters(lm_problem), mesh,
        max_iterations=30)
    for name in ("params", "cost", "it", "stop", "nfev", "njev"):
        out["lm_" + name] = getattr(state, name).numpy()

    for case in WORKER_BA_CASES:
        kwargs, replace = ba_arrays(case, FRAMES)
        problem = ba_sharded.shard_ba_problem(
            ba_problem(ba, kwargs, replace, device="cpu"), mesh)
        result = ba_sharded.sharded_solve_ba(
            problem, mesh, max_iterations=BA_ITERATIONS,
            cg_iterations=BA_CASES[case][-1])
        for name, value in result._asdict().items():
            out["%s_%s" % (case, name)] = value.numpy()
        # Each rank's frame block, gathered: the global cameras again.
        out["%s_gathered" % case] = multihost.gather_to_primary(
            mesh.block(result.cam_params, 0))
    multihost.sync_hosts("done")
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    print("WORKER_%d_OK" % rank)


if __name__ == "__main__":
    main(sys.argv[1])
