"""Solve frontend: build a SolveProblem from scene objects, run LM,
write results back.

Port of mayamatchmovesolver_tpu/solver/solve.py (ref:
src/mmSolver/adjust/adjust_base.cpp:713-1580): problem sizing and
validation, the dense LM and the structured Schur BA (solver/ba.py,
reached through solver/ba_bridge.py), their frame-sharded variants
(parallel/), the block-resumable solve loops that give the host control
between iteration blocks, the per-frame solve (all frames at once under
one batched LM, or in order with a Kalman warm start),
accept-only-better revert, and result assembly.
"""

import contextlib
import dataclasses
import enum
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mayamatchmovesolver_torch.scene.attrblock import AttrBlock
from mayamatchmovesolver_torch.solver import ba as ba_mod
from mayamatchmovesolver_torch.solver import ba_bridge
from mayamatchmovesolver_torch.solver import lm as lm_mod
from mayamatchmovesolver_torch.solver import problem as problem_mod
from mayamatchmovesolver_torch.solver import registry as registry_mod
from mayamatchmovesolver_torch.solver import results as results_mod
from mayamatchmovesolver_torch.solver.loss import RobustLossType
from mayamatchmovesolver_torch.utils import profiler as profiler_mod


class FrameSolveMode(enum.IntEnum):
    """(ref: FrameSolveMode, adjust_data.h:74-78.)"""

    ALL_FRAMES_AT_ONCE = 0
    PER_FRAME = 1


class SceneGraphMode(enum.IntEnum):
    """Kept for API parity with the reference's MayaDAG/MMSceneGraph flag
    (ref: adjust_data.h:80-84); this framework has one engine."""

    AUTO = 0
    FLAT_SCENE = 1


@dataclasses.dataclass
class SolverOptions:
    """Solver flags (ref: docs/source/commands_solve.rst:17-37 and
    SolverOptions, adjust_data.h:133-186)."""

    iterations: int = 20
    tau: float = 1e-3
    eps1: float = 1e-6  # gtol
    eps2: float = 1e-6  # xtol
    eps3: float = 1e-6  # ftol
    robust_loss_type: RobustLossType = RobustLossType.TRIVIAL
    robust_loss_scale: float = 1.0
    frame_solve_mode: FrameSolveMode = FrameSolveMode.ALL_FRAMES_AT_ONCE
    accept_only_better: bool = True
    image_width: float = 2048.0
    # 'fwd' Jacobian = n_params JVP passes; 'rev' = m VJP passes.
    jacobian_mode: str = "fwd"
    # Solver backend (solver/registry.py indices); None = the registry
    # default, which honors the MMSOLVER_TPU_DEFAULT_SOLVER env var.
    solver_type: Optional[int] = None
    # Linear solver for the Schur BA: None = auto (exact Cholesky for
    # short shots, block-preconditioned CG once the reduced camera system
    # has _BA_AUTO_CG_THRESHOLD unknowns, and always for multi-camera
    # rigs), or explicitly 'cholesky' / 'cg'.
    ba_linear_solver: Optional[str] = None
    ba_cg_iterations: int = 30
    # Jacobian assembly of the Schur BA: 'ad' (per-observation forward
    # AD) or 'analytic' (solver/ba.py ASSEMBLIES).
    ba_assembly: str = "ad"
    # Cooperative interruption / progress reporting for long solves
    # (ref: MComputation::isInterruptRequested polled inside the
    # residual callback and Jacobian loop, adjust_solveFunc.cpp:567-571,
    # 321-325; per-iteration progress lines, adjust_solveFunc.cpp:616).
    # When any of these is set, the solve runs in blocks of
    # `callback_interval` iterations; between blocks the host calls
    # iteration_callback(iteration, cost), checks interrupt_check() and
    # the max_seconds wall-clock budget.  An interrupted solve returns
    # the best parameters found so far with result.user_interrupted.
    iteration_callback: Optional[Callable] = None
    interrupt_check: Optional[Callable] = None
    max_seconds: Optional[float] = None
    callback_interval: int = 5
    # Sequential per-frame Kalman warm-start tuning (ref: the execute
    # layer's value-prediction constants, _execute/main.py:483-497):
    # smaller measurement variance trusts each solved frame more;
    # larger process variance lets the prediction drift faster.
    kalman_measurement_variance: float = 1.0
    kalman_process_variance: float = 1.0
    # Capture a torch.profiler trace of the solve into this directory
    # (utils/profiler.py::xla_trace; the MProfiler-scope counterpart,
    # ref: adjust_solveFunc.cpp:573-579).
    profile_dir: Optional[str] = None


def _lm_config(options: SolverOptions):
    return lm_mod.LMConfig(
        max_iterations=options.iterations,
        tau=options.tau,
        eps1=options.eps1,
        eps2=options.eps2,
        eps3=options.eps3,
        jacobian_mode=options.jacobian_mode,
    )


# Reduced-system size (camera blocks x 6) from which the BA picks the CG
# linear solver when ba_linear_solver is None: past it the dense
# factorization's sequential columns dominate the step.
_BA_AUTO_CG_THRESHOLD = 512


def _solver_type(options: SolverOptions):
    """The requested backend: the option, else the registry default."""
    if options.solver_type is None:
        return registry_mod.get_solver_type_default()[0]
    return options.solver_type


def _resolve_solver_type(options: SolverOptions, problem):
    """Pick the solver backend: explicit option, else the registry
    default (which honors the MMSOLVER_TPU_DEFAULT_SOLVER env var,
    like the reference's MMSOLVER_DEFAULT_SOLVER,
    adjust_base.cpp:102-127).  The frame-sharded LM needs every parameter
    static and the solve frame count divisible by the world size; a
    problem that does not meet that falls back to the dense LM."""
    from mayamatchmovesolver_torch.parallel import make_frame_mesh

    st = _solver_type(options)
    if st == registry_mod.SOLVER_TYPE_LM_SHARDED:
        all_static = bool(torch.all(problem.param_frames == -1))
        world = make_frame_mesh(problem.attrs.static_values.device).size
        if not all_static or int(problem.num_frames) % world != 0:
            return registry_mod.SOLVER_TYPE_LM_DENSE
    # BA backends are resolved by the bridge in solve() (they need the
    # original scene/attr handles, not the flattened problem).
    return st


def build_problem(
    scene,
    attrs: AttrBlock,
    frame_indices: Sequence[int],
    solve_attrs,
    options: SolverOptions,
    marker_frame_mask=None,
    stiffness=None,
    lens=None,
    lines=None,
) -> problem_mod.SolveProblem:
    """Expand Attribute handles into the flat parameter layout, on the
    attributes' device.

    Animated attrs contribute one parameter per solve frame; static
    attrs one parameter (ref: countUpNumberOfUnknownParameters,
    adjust_relationships.cpp:223).
    """
    frame_indices = np.asarray(frame_indices, dtype=np.int64)
    codes, frames, mins, maxs, offs, scales = [], [], [], [], [], []
    for attr in solve_attrs:
        attr_frames = frame_indices if attr.code % 2 == 1 else [-1]
        for f in attr_frames:
            codes.append(attr.code)
            frames.append(int(f))
            mins.append(attr.min_value)
            maxs.append(attr.max_value)
            offs.append(attr.offset_value)
            scales.append(attr.scale_value)

    if marker_frame_mask is None:
        marker_frame_mask = np.ones(
            (scene.num_markers, len(frame_indices)), dtype=bool
        )

    if stiffness is None:
        stiff = dict(codes=[], frames=[], weight=[], variance=[], target=[])
    else:
        stiff = dict(stiffness)
    n_stiff = len(stiff["codes"])
    stiff.setdefault("prev_frames", [-1] * n_stiff)
    stiff.setdefault("prev2_frames", [-1] * n_stiff)
    stiff.setdefault("mode", [0] * n_stiff)
    stiff.setdefault("target", [0.0] * n_stiff)

    if lines is None:
        lines = dict(mkr_index=np.zeros((0, 1), np.int64),
                     mkr_mask=np.zeros((0, 1), bool),
                     weight=np.zeros(0))

    dtype = attrs.static_values.dtype
    device = attrs.static_values.device

    def ints(values):
        return torch.as_tensor(
            np.asarray(values, dtype=np.int64), device=device
        )

    def floats(values):
        return torch.as_tensor(
            np.asarray(values, dtype=np.float64), dtype=dtype, device=device
        )

    return problem_mod.SolveProblem(
        scene=scene,
        attrs=attrs,
        frame_indices=ints(frame_indices),
        param_codes=ints(codes),
        param_frames=ints(frames),
        param_min=floats(mins),
        param_max=floats(maxs),
        param_offset=floats(offs),
        param_scale=floats(scales),
        stiff_codes=ints(stiff["codes"]),
        stiff_frames=ints(stiff["frames"]),
        stiff_prev_frames=ints(stiff["prev_frames"]),
        stiff_prev2_frames=ints(stiff["prev2_frames"]),
        stiff_mode=ints(stiff["mode"]),
        stiff_weight=floats(stiff["weight"]),
        stiff_variance=floats(stiff["variance"] or []),
        stiff_target=floats(stiff["target"]),
        line_mkr_index=ints(lines["mkr_index"]),
        line_mkr_mask=torch.as_tensor(
            np.asarray(lines["mkr_mask"], dtype=bool), device=device
        ),
        line_weight=floats(lines["weight"]),
        marker_frame_mask=torch.as_tensor(
            np.array(marker_frame_mask, dtype=bool), device=device
        ),
        lens=lens,
        loss_type=int(options.robust_loss_type),
        loss_scale=float(options.robust_loss_scale),
        image_width=float(options.image_width),
    )


def build_stiffness(attrs_block, solve_attrs, frame_indices,
                    weight=1.0, variance=1.0, mode="stiffness"):
    """Build the stiffness/smoothness spec consumed by build_problem.

    Stiffness pulls each animated parameter toward its *previous
    frame's* value; smoothness toward the linear prediction from the
    two previous frames (ref: the attrStiffness/attrSmoothness solver
    flags and their target wiring, adjust_measureErrors.cpp:311-387,
    compile.py:486-589).  Targets are LIVE — resolved from the current
    attribute state at every residual evaluation (the reference reads
    the neighboring-frame values with candidate parameters applied), so
    only the frame indices are recorded here.

    `weight` and `variance` may be scalars or per-attribute mappings
    keyed by attr code (the per-attribute exposure of the reference's
    setattributedetails stiffness/smoothness values).
    """

    def per_attr(value, attr):
        if isinstance(value, dict):
            return value.get(attr.code, value.get(attr, 0.0))
        return value

    spec = dict(codes=[], frames=[], prev_frames=[], prev2_frames=[],
                weight=[], variance=[], target=[], mode=[])
    mode_id = 1 if mode == "stiffness" else 2
    frame_indices = list(frame_indices)
    for attr in solve_attrs:
        if attr.code % 2 != 1:
            continue
        w = float(per_attr(weight, attr))
        v = float(per_attr(variance, attr)) or 1.0
        if w <= 0.0:
            continue
        for f in frame_indices:
            if mode_id == 1 and f - 1 < 0:
                continue
            if mode_id == 2 and f - 2 < 0:
                continue
            spec["codes"].append(attr.code)
            spec["frames"].append(int(f))
            spec["prev_frames"].append(int(f) - 1)
            spec["prev2_frames"].append(max(int(f) - 2, 0))
            spec["weight"].append(w)
            spec["variance"].append(v)
            spec["target"].append(0.0)
            spec["mode"].append(mode_id)
    return spec


def merge_stiffness(*specs):
    """Concatenate stiffness/smoothness specs from build_stiffness."""
    keys = ("codes", "frames", "prev_frames", "prev2_frames", "weight",
            "variance", "target", "mode")
    out = {k: [] for k in keys}
    for spec in specs:
        if spec is None:
            continue
        n = len(spec["codes"])
        for k in keys:
            out[k].extend(spec.get(k, [0] * n))
    return out


def count_errors_and_parameters(problem: problem_mod.SolveProblem):
    """Problem sizing, for validation
    (ref: countUpNumberOfErrors / countUpNumberOfUnknownParameters,
    adjust_relationships.cpp:75,223)."""
    num_marker_errors = int(problem.marker_frame_mask.sum()) * 2
    num_stiff = int(problem.stiff_codes.shape[0])
    num_line = int(problem.line_mkr_mask.sum()) * int(problem.num_frames)
    return (
        num_marker_errors + num_stiff + num_line,
        int(problem.num_params),
    )


def _run_blocks(options: SolverOptions, max_it, state, run_block):
    """Host control between blocks of `callback_interval` iterations:
    after each block the progress callback, then — unless the solve
    converged in the block — the interrupt check and the wall-clock
    budget, in that order.  With no hook set the one block is the whole
    solve.  `run_block(state, limit)` iterates up to `limit` total
    iterations.  Returns (state, interrupted)."""
    hooked = (
        options.iteration_callback is not None
        or options.interrupt_check is not None
        or options.max_seconds is not None
    )
    block = max(1, int(options.callback_interval)) if hooked else max_it
    t_start = time.perf_counter()
    it_done, stop = 0, 0  # a state fresh from init has not stopped
    while it_done < max_it and stop == 0:
        state = run_block(state, min(it_done + block, max_it))
        it_done, stop = torch.stack([state.it, state.stop]).tolist()
        if options.iteration_callback is not None:
            options.iteration_callback(it_done, float(state.cost))
        if stop != 0:
            # Converged inside this block: report the real convergence
            # reason, not a (now-moot) interruption or budget hit.
            break
        if (options.interrupt_check is not None
                and options.interrupt_check()):
            return state, True
        if (options.max_seconds is not None
                and time.perf_counter() - t_start > options.max_seconds):
            return state, True
    return state, False


def _solve_problem_chunked(problem, config, options: SolverOptions):
    """One dense solve, block-resumable: initial deviations, the LM in
    blocks with the host in control between them, final deviations.
    Every dense solve takes this route; the block size changes how often
    the host looks, not what the LM computes.
    Returns (lm_result, attrs_out, aux0, aux1, interrupted)."""
    fn = problem_mod.residual_fn(problem)
    x0 = problem_mod.initial_parameters(problem)
    _, aux0 = problem_mod.measure_residuals(problem, problem.attrs)
    init = lm_mod.lm_init(fn, x0, config)
    state, interrupted = _run_blocks(
        options, config.max_iterations, init,
        lambda state, limit: lm_mod.lm_run_block(fn, state, config, limit),
    )
    result = lm_mod.lm_finalize(state, init.cost)
    attrs_out = problem_mod.insert_parameters(problem, result.x)
    _, aux1 = problem_mod.measure_residuals(problem, attrs_out)
    return result, attrs_out, aux0, aux1, interrupted


def _solve_ba_chunked(bridge, options: SolverOptions, linear_solver):
    """Block-resumable BA solve, the BA counterpart of
    _solve_problem_chunked and the route of every BA solve.
    Returns (BAResult, interrupted)."""
    max_it = int(options.iterations)
    init = ba_mod.ba_init(bridge.problem, float(options.tau))
    state, interrupted = _run_blocks(
        options, max_it, init,
        lambda state, limit: ba_mod.ba_run_block(
            bridge.problem, state, limit, max_iterations=max_it,
            eps1=float(options.eps1), eps2=float(options.eps2),
            eps3=float(options.eps3), linear_solver=linear_solver,
            cg_iterations=int(options.ba_cg_iterations),
            assembly=options.ba_assembly,
        ),
    )
    return ba_mod.ba_finalize(state, init.cost), interrupted


def _solve_problem_sharded(problem, config):
    """Frame-sharded LM backend (parallel/sharded.py) behind the same
    result contract as the dense path.  Every rank holds the whole
    problem, so the deviations before and after cover every frame.
    Returns (lm_result, attrs_out, aux0, aux1, interrupted)."""
    from mayamatchmovesolver_torch.parallel import (
        make_frame_mesh,
        shard_problem_arrays,
        sharded_levenberg_marquardt,
    )

    mesh = make_frame_mesh(problem.attrs.static_values.device)
    sharded = shard_problem_arrays(problem, mesh)
    x0 = problem_mod.initial_parameters(sharded)
    r0, aux0 = problem_mod.measure_residuals(sharded, sharded.attrs)
    state = sharded_levenberg_marquardt(
        sharded, x0, mesh, max_iterations=config.max_iterations,
        tau=config.tau, eps1=config.eps1, eps2=config.eps2, eps3=config.eps3,
    )
    attrs_out = problem_mod.insert_parameters(sharded, state.params)
    r1, aux1 = problem_mod.measure_residuals(sharded, attrs_out)
    lm_result = lm_mod.LMResult(
        x=state.params,
        residuals=r1,
        cost=state.cost,
        cost_initial=0.5 * torch.sum(r0 * r0),
        iterations=state.it,
        # Counted in ShardedLMState: one sharded normal-system evaluation
        # per iteration plus the initial one.
        func_evals=state.nfev,
        jacobian_evals=state.njev,
        stop_reason=torch.where(state.stop == 0, 4, state.stop),
        gradient_norm=torch.max(torch.abs(state.jtr)),
    )
    return lm_result, attrs_out, aux0, aux1, False


def _solve_ba_sharded(bridge, options: SolverOptions):
    """The frame-sharded Schur-CG BA (parallel/ba_sharded.py) as a
    BAResult, or None where it does not apply: one rank, frames not
    divisible by the world size, or a multi-camera rig — the single-device
    Schur BA is the same algorithm.  As in the reference, the result's
    counters and gradient norm are zero."""
    from mayamatchmovesolver_torch.parallel import ba_sharded, make_frame_mesh

    problem = bridge.problem
    mesh = make_frame_mesh(problem.cam_params.device)
    num_frames = problem.cam_params.shape[0]
    if (mesh.size == 1 or num_frames % mesh.size != 0
            or problem.num_cameras > 1):
        return None
    s_res = ba_sharded.sharded_solve_ba(
        ba_sharded.shard_ba_problem(problem, mesh), mesh,
        max_iterations=int(options.iterations), tau=float(options.tau),
        eps1=float(options.eps1), eps2=float(options.eps2),
        eps3=float(options.eps3), assembly=options.ba_assembly,
    )
    zero = torch.zeros((), dtype=torch.int32, device=s_res.cost.device)
    return ba_mod.BAResult(
        cam_params=s_res.cam_params,
        bnd_params=s_res.bnd_params,
        shared_params=s_res.shared_params,
        cost=s_res.cost,
        cost_initial=s_res.cost_initial,
        iterations=s_res.iterations,
        stop_reason=s_res.stop_reason,
        gradient_norm=torch.zeros_like(s_res.cost),
        func_evals=zero,
        jacobian_evals=zero,
    )


def _solve_problem_ba(problem, bridge, options: SolverOptions, solver_type,
                      has_hooks=False):
    """The Schur BA (or its sharded variant) behind the dense path's
    result contract: returns (lm_result, attrs_out, aux0, aux1,
    interrupted).  Host hooks keep the sharded type on the
    block-resumable single-device solve."""
    linear_solver = options.ba_linear_solver
    multi_cam = bridge.problem.num_cameras > 1
    if linear_solver is None:
        n_reduced = bridge.problem.cam_params.shape[0] * 6
        linear_solver = (
            "cg" if (multi_cam or n_reduced >= _BA_AUTO_CG_THRESHOLD)
            else "cholesky"
        )
    elif multi_cam:
        linear_solver = "cg"  # the dense step is single-camera only
    ba_result, interrupted = None, False
    if solver_type == registry_mod.SOLVER_TYPE_BA_SHARDED and not has_hooks:
        ba_result = _solve_ba_sharded(bridge, options)
    if ba_result is None:
        ba_result, interrupted = _solve_ba_chunked(bridge, options,
                                                   linear_solver)
    attrs_out = bridge.apply_result(problem.attrs, ba_result)
    _, aux0 = problem_mod.measure_residuals(problem, problem.attrs)
    r1, aux1 = problem_mod.measure_residuals(problem, attrs_out)
    lm_result = lm_mod.LMResult(
        x=ba_result.cam_params.reshape(-1),
        residuals=r1,
        cost=ba_result.cost,
        cost_initial=ba_result.cost_initial,
        iterations=ba_result.iterations,
        # Counted in BAState: trial-cost evaluations and block assemblies.
        func_evals=ba_result.func_evals,
        jacobian_evals=ba_result.jacobian_evals,
        stop_reason=ba_result.stop_reason,
        gradient_norm=ba_result.gradient_norm,
    )
    return lm_result, attrs_out, aux0, aux1, interrupted


def _to_host(tree):
    """Every tensor of a dataclass or dict as numpy, in one pass."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def solve(
    scene,
    attrs: AttrBlock,
    frame_indices: Sequence[int],
    solve_attrs,
    options: Optional[SolverOptions] = None,
    marker_frame_mask=None,
    stiffness=None,
    lens=None,
    lines=None,
):
    """Solve and return (new_attrs, SolverResult).

    Runs on the device the attributes lie on.  Equivalent of one
    mmSolver command invocation (ref: MMSolverCmd::doIt -> solve_v1,
    MMSolverCmd.cpp:109, adjust_base.cpp:1297).  With solver_type
    SOLVER_TYPE_BA_SCHUR or SOLVER_TYPE_BA_SHARDED a request with the
    bundle-adjustment shape runs the Schur BA; any other falls back to the
    dense LM, and the result's reason string says why.  The sharded types
    split the frames over the ranks of an initialised process group
    (parallel/); on one rank they run the single-device backends.  The
    dense LM and the single-device BA run block-resumable: with
    iteration_callback, interrupt_check or max_seconds set the host gets
    control every callback_interval iterations, else once at the end;
    hooks send a sharded type to those single-device loops.
    """
    options = options or SolverOptions()
    problem = build_problem(
        scene, attrs, frame_indices, solve_attrs, options,
        marker_frame_mask=marker_frame_mask, stiffness=stiffness,
        lens=lens, lines=lines,
    )

    num_errors, num_params = count_errors_and_parameters(problem)
    result = results_mod.SolverResult()
    if num_params == 0 or num_errors < num_params:
        # (ref: adjust_base.cpp:864-882 — errors >= parameters required.)
        result.success = False
        result.reason_string = (
            "cannot solve: %d errors < %d parameters"
            % (num_errors, num_params)
        )
        return attrs, result

    solver_type = _resolve_solver_type(options, problem)
    has_hooks = (
        options.iteration_callback is not None
        or options.interrupt_check is not None
        or options.max_seconds is not None
    )
    fallback_note = ""
    bridge = None
    if solver_type in (registry_mod.SOLVER_TYPE_BA_SCHUR,
                       registry_mod.SOLVER_TYPE_BA_SHARDED):
        # SolveProblem -> BAProblem bridge (ref: one command surface
        # dispatching every registered backend, adjust_base.cpp:80-127).
        bridge, reason = ba_bridge.build_ba_bridge(
            scene, attrs, frame_indices, solve_attrs, options,
            marker_frame_mask=marker_frame_mask, stiffness=stiffness,
            lens=lens, lines=lines,
        )
        if bridge is None:
            fallback_note = " (ba fallback to dense: %s)" % reason
            solver_type = registry_mod.SOLVER_TYPE_LM_DENSE

    profile_ctx = (
        profiler_mod.xla_trace(options.profile_dir)
        if options.profile_dir else contextlib.nullcontext()
    )
    t0 = time.perf_counter()
    with profile_ctx:
        if bridge is not None:
            (lm_result, attrs_out, aux0, aux1,
             interrupted) = _solve_problem_ba(problem, bridge, options,
                                              solver_type, has_hooks)
        elif (solver_type == registry_mod.SOLVER_TYPE_LM_SHARDED
              and not has_hooks):
            (lm_result, attrs_out, aux0, aux1,
             interrupted) = _solve_problem_sharded(problem,
                                                   _lm_config(options))
        else:
            (lm_result, attrs_out, aux0, aux1,
             interrupted) = _solve_problem_chunked(
                problem, _lm_config(options), options
            )
        if attrs_out.static_values.is_cuda:
            torch.cuda.synchronize(attrs_out.static_values.device)
    solve_seconds = time.perf_counter() - t0

    lm_result, aux0, aux1 = (
        _to_host(lm_result), _to_host(aux0), _to_host(aux1)
    )
    error_initial = float(aux0["error_avg"])
    error_final = float(aux1["error_avg"])

    reverted = False
    if options.accept_only_better and not (error_final < error_initial):
        # (ref: acceptOnlyBetter revert, adjust_base.cpp:1208-1244.)
        attrs_out = attrs
        error_final = error_initial
        aux1 = aux0
        reverted = True

    result.stop_reason = int(lm_result["stop_reason"])
    result.success = result.stop_reason in (1, 2, 3, 4)
    result.reason_string = results_mod.STOP_REASON_MESSAGES.get(
        result.stop_reason, ""
    ) + fallback_note
    # Hooks run the sharded LM as the dense one, and the name says so.
    result.solver_type_name = registry_mod.solver_name(
        registry_mod.SOLVER_TYPE_LM_DENSE
        if (has_hooks and bridge is None) else solver_type
    )
    result.user_interrupted = interrupted
    if interrupted:
        # (ref: interrupted solves keep the best state found so far,
        # adjust_base.cpp solverFrames early-out on isInterruptRequested.)
        result.reason_string = "user interrupted"
    if reverted:
        result.reason_string += " (reverted: no improvement)"
    result.iterations = int(lm_result["iterations"])
    result.function_evals = int(lm_result["func_evals"])
    result.jacobian_evals = int(lm_result["jacobian_evals"])
    result.error_initial = error_initial
    result.error_final = error_final
    result.error_avg = float(aux1["error_avg"])
    result.error_min = float(aux1["error_min"])
    result.error_max = float(aux1["error_max"])
    result.timer.solve_seconds = solve_seconds
    result.solved_parameters = lm_result["x"]

    frames = [int(f) for f in problem.frame_indices.cpu().numpy()]
    _set_deviation_curves(
        result, frames, aux1["per_marker_frame_distance"], aux1["mask"]
    )
    return attrs_out, result


def _set_deviation_curves(result, frames, dist, mask):
    """Per-frame average deviation and per-marker deviation curves (the
    reference bakes the latter onto the marker nodes for the "Show
    Deviation Curves" tool) from host (M, F) distances and mask."""
    per_frame = [
        float(dist[:, fi][mask[:, fi]].mean())
        if mask[:, fi].any() else float("nan")
        for fi in range(len(frames))
    ]
    result.per_frame_error = results_mod.FrameErrorList(
        frames=frames, errors=per_frame
    )
    for mi in range(dist.shape[0]):
        fl = results_mod.FrameErrorList()
        for fi, frame in enumerate(frames):
            if mask[mi, fi]:
                fl.frames.append(frame)
                fl.errors.append(float(dist[mi, fi]))
        result.per_marker_error["marker_%d" % mi] = fl


def _per_frame_error(dist, mask):
    """(M, F) distances + mask -> (F,) masked per-frame mean (inf where
    nothing measured, so unmeasured frames never win an accept test)."""
    n = torch.clamp(torch.sum(mask, dim=0), min=1)
    err = torch.sum(torch.where(mask, dist, 0.0), dim=0) / n
    return torch.where(torch.any(mask, dim=0), err, torch.inf)


def _frame_stiff_weight(base, frame_idx):
    """Restrict soft constraints to the frame being solved (other
    frames' entries are constants that would pollute the ftol test)."""
    return torch.where(base.stiff_frames == frame_idx, base.stiff_weight,
                       torch.zeros_like(base.stiff_weight))


def _solve_per_frame(base, frame_indices, full_mask, config,
                     accept_only_better):
    """The whole per-frame sweep: one batched LM over the frames (every
    frame iterates until all have stopped; one host read per
    iteration), the scatter of the solutions into the attr block,
    per-frame accept-only-better revert (ref: adjust_base.cpp:1430-1484
    reverts a worsened frame), and the final deviation measurement.
    Returns (attrs_out, batched LMResult, aux, improved)."""
    num_frames = frame_indices.shape[0]
    fn = problem_mod.per_frame_residual_fn(base, frame_indices, full_mask)
    x0 = problem_mod.per_frame_initial_parameters(base, frame_indices)
    batched = lm_mod.levenberg_marquardt(fn, x0, config)

    # Initial deviations over every frame (for error_initial and the
    # per-frame accept test).
    eval_prob = problem_mod.per_frame_problem(base, frame_indices, full_mask)
    _, aux0 = problem_mod.measure_residuals(eval_prob, base.attrs)

    # All parameters are animated, so solution (F, P) writes to
    # anim[channel_p, frame_f] after bound conversion.
    external = problem_mod.per_frame_external(base, batched.x)
    _, aux1 = problem_mod.measure_residuals(
        eval_prob,
        problem_mod.scatter_frame_values(base, frame_indices, external),
    )

    # Per-frame accept-only-better: revert frames the solve worsened
    # (ref: acceptOnlyBetter + per-frame loop, adjust_base.cpp:
    # 1208-1244, 1430-1484).
    err0 = _per_frame_error(aux0["per_marker_frame_distance"], aux0["mask"])
    err1 = _per_frame_error(aux1["per_marker_frame_distance"], aux1["mask"])
    if accept_only_better:
        improved = err1 < err0
    else:
        improved = torch.ones(num_frames, dtype=torch.bool,
                              device=frame_indices.device)
    channels = base.param_codes // 2
    old_vals = base.attrs.anim_values[
        channels[None, :], frame_indices[:, None]
    ]  # (F, P)
    final_vals = torch.where(
        improved[:, None], external.to(old_vals.dtype), old_vals
    )
    attrs_out = problem_mod.scatter_frame_values(
        base, frame_indices, final_vals
    )

    # Final deviation stats from the accepted per-frame states (no third
    # scene evaluation needed: pick each frame's column).
    dist = torch.where(
        improved[None, :],
        aux1["per_marker_frame_distance"],
        aux0["per_marker_frame_distance"],
    )
    mask = torch.where(improved[None, :], aux1["mask"], aux0["mask"])
    n_measured = torch.clamp(torch.sum(mask), min=1)
    aux = {
        "error_initial": aux0["error_avg"],
        "error_avg": torch.sum(torch.where(mask, dist, 0.0)) / n_measured,
        "error_min": torch.min(torch.where(mask, dist, torch.inf)),
        "error_max": torch.max(torch.where(mask, dist, -torch.inf)),
        "per_marker_frame_distance": dist,
        "mask": mask,
    }
    return attrs_out, batched, aux, improved


def _solve_sequential(base, frame_indices, full_mask, config,
                      accept_only_better, warm_start,
                      kalman_measurement_variance=1.0,
                      kalman_process_variance=1.0):
    """Sequential per-frame sweep, a host loop of single-frame solves:
    each frame starts from a Kalman prediction fused from the previously
    solved frames (ref: the attribute value prediction between per-frame
    solves, _execute/main.py:483-497, utils/kalmanfilter.py), and
    stiffness constraints see the already-solved previous frame.  The
    accept test and the filter stay on the device; the host reads only
    what each frame's LM loop reads."""
    from mayamatchmovesolver_torch.solver import bounds as bounds_mod
    from mayamatchmovesolver_torch.utils import kalmanfilter

    channels = base.param_codes // 2  # (P,) all animated
    anim = base.attrs.anim_values
    dtype, device = anim.dtype, anim.device
    num_params = base.param_codes.shape[0]
    mean = torch.zeros(num_params, dtype=dtype, device=device)
    var = torch.ones(num_params, dtype=dtype, device=device)
    n_solved = 0
    outputs = []
    for i in range(frame_indices.shape[0]):
        frame_idx = frame_indices[i]
        # Warm start: overwrite this frame's cells with the prediction
        # once at least one frame informs the filter.
        cur = anim[channels, frame_idx]
        anim_ws = anim.index_put(
            (channels, frame_idx.expand(num_params)),
            mean if n_solved > 0 else cur,
        )
        attrs_f = dataclasses.replace(base.attrs, anim_values=anim_ws)
        prob = dataclasses.replace(
            base,
            attrs=attrs_f,
            frame_indices=frame_indices[i:i + 1],
            param_frames=frame_idx.expand(num_params),
            marker_frame_mask=full_mask[:, i:i + 1],
            stiff_weight=_frame_stiff_weight(base, frame_idx),
        )
        _, aux0 = problem_mod.measure_residuals(prob, attrs_f)
        lm_result = lm_mod.levenberg_marquardt(
            problem_mod.residual_fn(prob),
            problem_mod.initial_parameters(prob), config,
        )
        external = bounds_mod.internal_to_external(
            lm_result.x, base.param_min, base.param_max,
            base.param_offset, base.param_scale,
        ).to(dtype)
        anim_new = anim_ws.index_put(
            (channels, frame_idx.expand(num_params)), external
        )
        _, aux1 = problem_mod.measure_residuals(
            prob, dataclasses.replace(attrs_f, anim_values=anim_new)
        )
        if accept_only_better:
            improved = aux1["error_avg"] < aux0["error_avg"]
        else:
            improved = torch.ones((), dtype=torch.bool, device=device)
        accepted = torch.where(improved, external, cur)
        anim = anim.index_put(
            (channels, frame_idx.expand(num_params)), accepted
        )

        # Kalman fuse + predict for the next frame's warm start.
        if not warm_start:
            mean, var = torch.zeros_like(mean), torch.ones_like(var)
            n_solved = 0
        elif n_solved == 0:
            mean = accepted
            var = torch.full_like(var, kalman_process_variance)
            n_solved = 1
        else:
            fused = kalmanfilter.update(
                kalmanfilter.State(value=mean, mean=mean, variance=var),
                kalmanfilter.State(
                    value=accepted, mean=accepted,
                    variance=torch.full_like(var, kalman_measurement_variance),
                ),
            )
            predicted = kalmanfilter.predict(
                fused,
                kalmanfilter.State(
                    value=0.0, mean=torch.zeros_like(mean),
                    variance=torch.full_like(var, kalman_process_variance),
                ),
            )
            mean, var = predicted.mean, predicted.variance
            n_solved += 1
        outputs.append((lm_result.iterations, lm_result.func_evals,
                        lm_result.jacobian_evals, lm_result.stop_reason,
                        improved))

    iterations, func_evals, jac_evals, stop_reasons, improved = (
        torch.stack(column) for column in zip(*outputs)
    )
    attrs_out = dataclasses.replace(base.attrs, anim_values=anim)
    eval_prob = problem_mod.per_frame_problem(base, frame_indices, full_mask)
    _, aux0 = problem_mod.measure_residuals(eval_prob, base.attrs)
    _, aux1 = problem_mod.measure_residuals(eval_prob, attrs_out)
    aux = dict(aux1)
    aux["error_initial"] = aux0["error_avg"]

    # The reference fills the fields of the sweep's LMResult that its
    # scan does not carry with zeros; kept as it is.
    zeros_f = torch.zeros(frame_indices.shape[0], dtype=dtype, device=device)
    batched = lm_mod.LMResult(
        x=torch.zeros((frame_indices.shape[0], num_params), dtype=dtype,
                      device=device),
        residuals=zeros_f,
        cost=zeros_f,
        cost_initial=zeros_f,
        iterations=iterations,
        func_evals=func_evals,
        jacobian_evals=jac_evals,
        stop_reason=stop_reasons,
        gradient_norm=zeros_f,
    )
    return attrs_out, batched, aux, improved


def solve_per_frame(
    scene,
    attrs: AttrBlock,
    frame_indices: Sequence[int],
    solve_attrs,
    options: Optional[SolverOptions] = None,
    lens=None,
    marker_mask=None,
    marker_frame_mask=None,
    stiffness=None,
    lines=None,
    sequential=False,
    kalman_warm_start=True,
):
    """Per-frame solve mode: each frame is an independent problem.

    The reference loops frames serially because the Maya DG is not
    thread-safe (ref: adjust_base.cpp:1430-1484); here all frames solve
    *in parallel* under one batched LM on the attributes' device.  With
    ``sequential=True`` frames solve in order, one single-frame LM
    each, warm-started from a Kalman prediction of the previous
    solutions (ref: _execute/main.py:483-497) — slower (a host loop)
    but propagates information forward like the reference's per-frame
    loop.

    Only animated attributes are meaningful per-frame; static attrs
    would be re-solved per frame (the reference has the same semantics —
    later frames overwrite earlier results).
    """
    options = options or SolverOptions()
    frame_indices = np.asarray(frame_indices, dtype=np.int64)
    anim_attrs = [a for a in solve_attrs if a.code % 2 == 1]
    if len(anim_attrs) != len(solve_attrs):
        raise ValueError(
            "per-frame solve supports animated attributes only; "
            "solve static attrs in ALL_FRAMES_AT_ONCE mode"
        )

    num_frames = len(frame_indices)
    if marker_frame_mask is not None:
        full_mask = np.asarray(marker_frame_mask, dtype=bool)
        if full_mask.shape != (scene.num_markers, num_frames):
            raise ValueError(
                "marker_frame_mask shape %r != (markers=%d, frames=%d)"
                % (full_mask.shape, scene.num_markers, num_frames)
            )
    elif marker_mask is not None:
        full_mask = np.broadcast_to(
            np.asarray(marker_mask, dtype=bool)[:, None],
            (scene.num_markers, num_frames),
        )
    else:
        full_mask = np.ones((scene.num_markers, num_frames), dtype=bool)

    base = build_problem(
        scene, attrs, frame_indices[:1], anim_attrs, options, lens=lens,
        stiffness=stiffness, lines=lines,
    )
    device = attrs.static_values.device
    frames_t = torch.as_tensor(frame_indices, device=device)
    mask_t = torch.as_tensor(np.ascontiguousarray(full_mask), device=device)
    config = _lm_config(options)

    t0 = time.perf_counter()
    if sequential:
        attrs_out, batched, aux, improved = _solve_sequential(
            base, frames_t, mask_t, config,
            bool(options.accept_only_better), bool(kalman_warm_start),
            float(options.kalman_measurement_variance),
            float(options.kalman_process_variance),
        )
    else:
        attrs_out, batched, aux, improved = _solve_per_frame(
            base, frames_t, mask_t, config,
            bool(options.accept_only_better),
        )
    if attrs_out.static_values.is_cuda:
        torch.cuda.synchronize(device)
    solve_seconds = time.perf_counter() - t0

    # One bulk device->host fetch of the result tree; attrs_out stays on
    # the device for the caller.
    batched, aux = _to_host(batched), _to_host(aux)
    improved = improved.cpu().numpy()

    stop_reasons = batched["stop_reason"]
    result = results_mod.SolverResult()
    result.success = bool(np.all(np.isin(stop_reasons, (1, 2, 3, 4))))
    result.stop_reason = int(np.max(stop_reasons))
    result.reason_string = results_mod.STOP_REASON_MESSAGES.get(
        result.stop_reason, ""
    )
    n_reverted = int(np.sum(~improved))
    if n_reverted:
        result.reason_string += (
            " (%d frame(s) reverted: no improvement)" % n_reverted
        )
    result.iterations = int(np.max(batched["iterations"]))
    result.function_evals = int(np.sum(batched["func_evals"]))
    result.jacobian_evals = int(np.sum(batched["jacobian_evals"]))
    result.error_initial = float(aux["error_initial"])
    result.error_final = float(aux["error_avg"])
    result.error_avg = float(aux["error_avg"])
    result.error_min = float(aux["error_min"])
    result.error_max = float(aux["error_max"])
    result.timer.solve_seconds = solve_seconds
    result.per_frame_stop_reason = [int(s) for s in stop_reasons]
    result.per_frame_reverted = [bool(not i) for i in improved]
    _set_deviation_curves(
        result, [int(f) for f in frame_indices],
        aux["per_marker_frame_distance"], aux["mask"],
    )
    return attrs_out, result
