"""Solve frontend: build a SolveProblem from scene objects, run LM,
write results back.

Port of mayamatchmovesolver_tpu/solver/solve.py (ref:
src/mmSolver/adjust/adjust_base.cpp:713-1580): problem sizing and
validation, the dense LM and the structured Schur BA (solver/ba.py,
reached through solver/ba_bridge.py), accept-only-better revert, and
result assembly.  Backends and options that the port does not have yet
raise NotImplementedError naming the ROADMAP item that brings them.
"""

import dataclasses
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


@dataclasses.dataclass
class SolverOptions:
    """Solver flags (ref: docs/source/commands_solve.rst:17-37 and
    SolverOptions, adjust_data.h:133-186).

    The fields of the reference's options that only its per-frame and
    Kalman paths read are not here yet; they arrive with those paths.
    """

    iterations: int = 20
    tau: float = 1e-3
    eps1: float = 1e-6  # gtol
    eps2: float = 1e-6  # xtol
    eps3: float = 1e-6  # ftol
    robust_loss_type: RobustLossType = RobustLossType.TRIVIAL
    robust_loss_scale: float = 1.0
    accept_only_better: bool = True
    image_width: float = 2048.0
    # 'fwd' Jacobian = n_params JVP passes; 'rev' = m VJP passes.
    jacobian_mode: str = "fwd"
    # Solver backend (solver/registry.py indices); None = the registry
    # default, which honors the MMSOLVER_TPU_DEFAULT_SOLVER env var.
    # The dense LM and the Schur BA are ported, the sharded ones not.
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
    # Host hooks of the reference's block-resumable solve loop and its
    # profiler trace; not ported yet, solve() refuses them.
    iteration_callback: Optional[Callable] = None
    interrupt_check: Optional[Callable] = None
    max_seconds: Optional[float] = None
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


def _refuse_unported(options: SolverOptions):
    """Raise for every option this port does not carry out yet."""
    st = _solver_type(options)
    if st not in (registry_mod.SOLVER_TYPE_LM_DENSE,
                  registry_mod.SOLVER_TYPE_BA_SCHUR):
        raise NotImplementedError(
            "solver_type %r (%s) is not ported to torch yet: the sharded "
            "backends come with ROADMAP Queue 1 item 14"
            % (st, registry_mod.solver_name(st))
        )
    for name in ("iteration_callback", "interrupt_check", "max_seconds"):
        if getattr(options, name) is not None:
            raise NotImplementedError(
                "SolverOptions.%s needs the block-resumable solve loop of the "
                "dense and BA backends, which is not ported to torch yet "
                "(ROADMAP Queue 1 item 8)" % name
            )
    if options.profile_dir is not None:
        raise NotImplementedError(
            "SolverOptions.profile_dir needs utils/profiler.py, which is "
            "not ported to torch yet (ROADMAP Queue 1 item 15)"
        )


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
            np.asarray(marker_frame_mask, dtype=bool), device=device
        ),
        lens=lens,
        loss_type=int(options.robust_loss_type),
        loss_scale=float(options.robust_loss_scale),
        image_width=float(options.image_width),
    )


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


def _solve_problem(problem, config):
    """One dense solve: initial deviations, LM, final deviations."""
    fn = problem_mod.residual_fn(problem)
    x0 = problem_mod.initial_parameters(problem)
    _, aux0 = problem_mod.measure_residuals(problem, problem.attrs)
    result = lm_mod.levenberg_marquardt(fn, x0, config)
    attrs_out = problem_mod.insert_parameters(problem, result.x)
    _, aux1 = problem_mod.measure_residuals(problem, attrs_out)
    return result, attrs_out, aux0, aux1


def _solve_problem_ba(problem, bridge, options: SolverOptions):
    """The Schur BA behind the dense path's result contract: returns
    (lm_result, attrs_out, aux0, aux1)."""
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
    ba_result = ba_mod.solve_ba(
        bridge.problem, max_iterations=int(options.iterations),
        tau=float(options.tau), eps1=float(options.eps1),
        eps2=float(options.eps2), eps3=float(options.eps3),
        linear_solver=linear_solver,
        cg_iterations=int(options.ba_cg_iterations),
        assembly=options.ba_assembly,
    )
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
    return lm_result, attrs_out, aux0, aux1


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
    SOLVER_TYPE_BA_SCHUR a request with the bundle-adjustment shape runs
    the Schur BA; any other falls back to the dense LM, and the result's
    reason string says why.
    """
    options = options or SolverOptions()
    _refuse_unported(options)
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

    solver_type = _solver_type(options)
    fallback_note = ""
    bridge = None
    if solver_type == registry_mod.SOLVER_TYPE_BA_SCHUR:
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

    t0 = time.perf_counter()
    if bridge is not None:
        lm_result, attrs_out, aux0, aux1 = _solve_problem_ba(
            problem, bridge, options
        )
    else:
        lm_result, attrs_out, aux0, aux1 = _solve_problem(
            problem, _lm_config(options)
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
    result.solver_type_name = registry_mod.solver_name(solver_type)
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

    # Per-frame average deviation.
    dist = aux1["per_marker_frame_distance"]  # (M, F)
    mask = aux1["mask"]
    frames = [int(f) for f in problem.frame_indices.cpu().numpy()]
    per_frame = [
        float(dist[:, fi][mask[:, fi]].mean())
        if mask[:, fi].any() else float("nan")
        for fi in range(len(frames))
    ]
    result.per_frame_error = results_mod.FrameErrorList(
        frames=frames, errors=per_frame
    )
    # Per-marker deviation curves (the reference bakes these onto the
    # marker nodes for the "Show Deviation Curves" tool).
    for mi in range(dist.shape[0]):
        fl = results_mod.FrameErrorList()
        for fi, frame in enumerate(frames):
            if mask[mi, fi]:
                fl.frames.append(frame)
                fl.errors.append(float(dist[mi, fi]))
        result.per_marker_error["marker_%d" % mi] = fl
    return attrs_out, result
