"""Solver strategies: Step / Basic / Standard / Camera schedules.

Port of mayamatchmovesolver_tpu/solver/strategies.py, the counterparts
of the reference's Python solver classes
(ref: python/mmSolver/_api/solverstep.py, solverbasic.py:44,
solverstandard.py:40-76,633-746): a strategy compiles into a list of
Action steps (here: closures running solve()/solve_per_frame()) executed
in order — the root-then-animated coarse-to-fine schedule that makes
long-sequence solves tractable (ref: docs/source/solver_design.rst:
188-218 on the O(n^2) static-attr blow-up the schedule avoids).

Every strategy runs on the device its attributes lie on.
"""

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mayamatchmovesolver_torch.core.transform import matrix_to_euler
from mayamatchmovesolver_torch.scene import flatscene
from mayamatchmovesolver_torch.scene.attrblock import (
    gather_attr_values_static,
)
from mayamatchmovesolver_torch.sfm import camerasolve
from mayamatchmovesolver_torch.solver import problem as problem_mod
from mayamatchmovesolver_torch.solver import results as results_mod
from mayamatchmovesolver_torch.solver import rootframe as rootframe_mod
from mayamatchmovesolver_torch.solver import triangulate as triangulate_mod
from mayamatchmovesolver_torch.solver.solve import (
    SolverOptions,
    build_problem,
    solve,
    solve_per_frame,
)


def _expand_mask(marker_mask, scene, frame_indices):
    """(M,) marker selection -> (M, F) marker_frame_mask (None passes
    through: all markers measured)."""
    if marker_mask is None:
        return None
    return np.broadcast_to(
        np.asarray(marker_mask, dtype=bool)[:, None],
        (scene.num_markers, len(list(frame_indices))),
    )


def _frames_on(attrs, frame_indices):
    """Frame indices as a tensor on the attributes' device."""
    return torch.as_tensor(np.asarray(frame_indices, dtype=np.int64),
                           device=attrs.static_values.device)


def _set_deviation(result, scene, attrs, frame_indices, options, **kwargs):
    """Deviation statistics through the real residual pipeline: an
    empty-parameter problem measures without solving."""
    eval_problem = build_problem(scene, attrs, frame_indices, [], options,
                                 **kwargs)
    _, aux = problem_mod.measure_residuals(eval_problem, attrs)
    avg, lo, hi = torch.stack(
        [aux["error_avg"], aux["error_min"], aux["error_max"]]
    ).tolist()
    result.error_final = result.error_avg = avg
    result.error_min, result.error_max = lo, hi


@dataclasses.dataclass
class Action:
    """One executable solve step
    (ref: python/mmSolver/_api/action.py Action(func,args,kwargs))."""

    name: str
    func: object
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)

    def run(self):
        return self.func(*self.args, **self.kwargs)


def coerce_frames(frame_indices):
    """Accept plain ints or api.Frame objects (ref: _api/frame.py —
    Frame wraps a number plus tags) anywhere a frame list is taken."""
    return [int(getattr(f, "value", f)) for f in frame_indices]


class SolverBase:
    """(ref: solverbase.py.)  Subclasses implement execute(); compile()
    exposes the schedule as Actions for inspection."""

    # Whether the solver consumes the Collection's attribute list
    # (SolverCamera determines its own parameters).
    requires_attributes = True

    def execute(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        raise NotImplementedError

    def compile(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        return [
            Action(
                name=type(self).__name__,
                func=self.execute,
                args=(scene, attrs, solve_attrs, options),
                kwargs=dict(lens=lens, marker_mask=marker_mask,
                            stiffness=stiffness, lines=lines),
            )
        ]


class SolverStep(SolverBase):
    """Raw single step over an explicit frame list
    (ref: solverstep.py)."""

    def __init__(self, frame_indices):
        self.frame_indices = coerce_frames(frame_indices)

    def execute(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        options = options or SolverOptions()
        attrs, result = solve(
            scene, attrs, self.frame_indices, solve_attrs, options,
            lens=lens, marker_frame_mask=_expand_mask(
                marker_mask, scene, self.frame_indices
            ),
            stiffness=stiffness, lines=lines,
        )
        return attrs, [result]


class SolverBasic(SolverBase):
    """Animated-attribute per-frame sweep
    (ref: solverbasic.py:44 — anim attrs only, one solve per frame;
    ours batches all frames through one batched LM, or sequentially
    with Kalman warm-starts when sequential=True)."""

    def __init__(self, frame_indices, sequential=False):
        self.frame_indices = coerce_frames(frame_indices)
        self.sequential = bool(sequential)

    def execute(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        options = options or SolverOptions()
        anim = [a for a in solve_attrs if a.code % 2 == 1]
        attrs, result = solve_per_frame(
            scene, attrs, self.frame_indices, anim, options,
            lens=lens, marker_mask=marker_mask, stiffness=stiffness,
            lines=lines, sequential=self.sequential,
        )
        return attrs, [result]


class RootFrameStrategy:
    """Root-frame iteration strategies
    (ref: constant.py:355-366 SOLVER_STD_STRATEGY_* — GLOBAL,
    FWD_PAIR, FWD_PAIR_AND_GLOBAL, FWD_INCREMENT — orchestrated by
    compile_multi_frame, solverstandard.py:721-745)."""

    GLOBAL = "global"
    FWD_PAIR = "fwd_pair"
    FWD_PAIR_AND_GLOBAL = "fwd_pair_and_global"
    FWD_INCREMENT = "fwd_increment"


def root_frame_schedule(root_frames, strategy):
    """Expand root frames into a list of frame-batches to solve in
    order, per the chosen strategy."""
    roots = sorted(root_frames)
    if strategy == RootFrameStrategy.GLOBAL:
        return [list(roots)]
    if strategy == RootFrameStrategy.FWD_PAIR:
        return [[a, b] for a, b in zip(roots, roots[1:])] or [roots]
    if strategy == RootFrameStrategy.FWD_PAIR_AND_GLOBAL:
        out = [[a, b] for a, b in zip(roots, roots[1:])] or [roots]
        out.append(list(roots))
        return out
    if strategy == RootFrameStrategy.FWD_INCREMENT:
        return [roots[: i + 2] for i in range(len(roots) - 1)] or [roots]
    raise ValueError("unknown root frame strategy: %r" % strategy)


class SolverStandard(SolverBase):
    """Root-frames pass (static + anim at roots) then per-frame anim
    pass, then optional global pass
    (ref: solverstandard.py:40-76; compile_multi_frame at
    solverstandardutils.py orchestrated from solverstandard.py:633-746).
    """

    def __init__(
        self,
        frame_indices: Sequence[int],
        root_frame_indices: Optional[Sequence[int]] = None,
        use_single_frame: bool = False,
        global_solve: bool = False,
        root_frame_span: int = 10,
        root_frame_strategy: str = RootFrameStrategy.GLOBAL,
    ):
        self.frame_indices = coerce_frames(frame_indices)
        self.root_frame_indices = (
            list(root_frame_indices) if root_frame_indices is not None
            else None
        )
        self.use_single_frame = use_single_frame
        self.global_solve = global_solve
        self.root_frame_span = root_frame_span
        self.root_frame_strategy = root_frame_strategy

    def _auto_root_frames(self, scene, attrs):
        ev = flatscene.evaluate(scene, attrs,
                                _frames_on(attrs, self.frame_indices))
        # The one host read: which markers are enabled on which frames.
        roots = rootframe_mod.get_root_frames_from_markers(
            ev.marker_enable.cpu().numpy(), self.frame_indices
        )
        roots = rootframe_mod.root_frames_subdivide(
            roots, self.root_frame_span
        )
        return [f for f in roots if f in self.frame_indices]

    def execute(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        options = options or SolverOptions()
        results = []

        if self.use_single_frame or len(self.frame_indices) == 1:
            attrs, result = solve(
                scene, attrs, self.frame_indices[:1], solve_attrs, options,
                lens=lens, marker_frame_mask=_expand_mask(
                    marker_mask, scene, self.frame_indices[:1]
                ),
                stiffness=stiffness, lines=lines,
            )
            return attrs, [result]

        anim_attrs = [a for a in solve_attrs if a.code % 2 == 1]

        roots = self.root_frame_indices
        if roots is None:
            roots = self._auto_root_frames(scene, attrs)
        if not roots:
            roots = [self.frame_indices[0], self.frame_indices[-1]]

        # Pass 1: root frames, all attributes (static couple all
        # roots), batched per the root-frame strategy.
        for batch in root_frame_schedule(roots,
                                         self.root_frame_strategy):
            attrs, result = solve(
                scene, attrs, batch, solve_attrs, options, lens=lens,
                marker_frame_mask=_expand_mask(marker_mask, scene, batch),
                stiffness=stiffness, lines=lines,
            )
            results.append(result)

        # Pass 2: per-frame animated sweep over the full range.
        if anim_attrs:
            attrs, result = solve_per_frame(
                scene, attrs, self.frame_indices, anim_attrs, options,
                lens=lens, marker_mask=marker_mask,
                stiffness=stiffness, lines=lines,
            )
            results.append(result)

        # Pass 3 (optional): one global all-frames polish.
        if self.global_solve:
            attrs, result = solve(
                scene, attrs, self.frame_indices, solve_attrs, options,
                lens=lens, marker_frame_mask=_expand_mask(
                    marker_mask, scene, self.frame_indices
                ),
                stiffness=stiffness, lines=lines,
            )
            results.append(result)

        return attrs, results


class SolverTriangulate(SolverBase):
    """Bundle triangulation step: DLT-place every (selected) marker's
    bundle from its 2D track through the current camera, optionally
    followed by an LM refinement of the bundle positions
    (ref: python/mmSolver/_api/solvertriangulate.py,
    triangulatebundle.py and the triangulatebundle tool).

    The Collection's attribute list is optional — with refine=True and
    no attributes given, the triangulated bundles' tx/ty/tz refine.
    """

    requires_attributes = False

    def __init__(self, frame_indices, refine=False,
                 refine_iterations=10):
        self.frame_indices = coerce_frames(frame_indices)
        self.refine = bool(refine)
        self.refine_iterations = int(refine_iterations)

    def execute(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        options = options or SolverOptions()
        t0 = time.perf_counter()
        attrs, ok = triangulate_mod.triangulate_into_attrs(
            scene, attrs, self.frame_indices, marker_mask=marker_mask
        )
        frame_mask = _expand_mask(marker_mask, scene, self.frame_indices)
        results = []
        if self.refine and solve_attrs:
            refine_options = dataclasses.replace(
                options, iterations=self.refine_iterations
            )
            attrs, result = solve(
                scene, attrs, self.frame_indices, solve_attrs,
                refine_options, lens=lens, marker_frame_mask=frame_mask,
            )
            results.append(result)

        result = results_mod.SolverResult()
        result.success = bool(np.all(ok))
        result.reason_string = "triangulated %d/%d bundles" % (
            int(np.sum(ok)), int(ok.size)
        )
        _set_deviation(result, scene, attrs, self.frame_indices, options,
                       lens=lens, marker_frame_mask=frame_mask)
        result.timer.solve_seconds = time.perf_counter() - t0
        return attrs, results + [result]


class SolverCamera(SolverBase):
    """From-scratch camera solve: recover camera poses, bundle
    positions and (optionally) focal length purely from 2D markers
    (ref: python/mmSolver/_api/solvercamera.py:48 and the camera_solve
    pipeline, solvercamerautils.py:958-1290).

    The Collection's attribute list is ignored — the camera solve
    determines its own parameters (camera animated transform, bundle
    positions, focal length).  Requirements: a root-level camera with
    animated tx..rz attributes, root-level bundles with static or
    animated tx/ty/tz.

    sampler supplies the RANSAC draws of the bootstrap
    (sfm/camerasolve.py::seeded_sampler when None).
    """

    requires_attributes = False

    def __init__(
        self,
        frame_indices: Sequence[int],
        camera_index: int = 0,
        solve_focal: bool = True,
        origin_frame: Optional[int] = None,
        scene_scale: float = 1.0,
        min_pair_separation: int = 5,
        refine_rounds: int = 2,
        max_bundle_error_px: float = 9.0,
        ba_iterations: int = 50,
        sampler=None,
    ):
        self.frame_indices = coerce_frames(frame_indices)
        self.camera_index = int(camera_index)
        self.solve_focal = bool(solve_focal)
        self.origin_frame = origin_frame
        self.scene_scale = float(scene_scale)
        self.min_pair_separation = int(min_pair_separation)
        self.refine_rounds = int(refine_rounds)
        self.max_bundle_error_px = float(max_bundle_error_px)
        self.ba_iterations = int(ba_iterations)
        self.sampler = sampler

    def execute(self, scene, attrs, solve_attrs, options=None,
                lens=None, marker_mask=None, stiffness=None,
                lines=None):
        t0 = time.perf_counter()
        options = options or SolverOptions()
        ci = self.camera_index
        device = attrs.static_values.device
        frames = np.asarray(self.frame_indices, dtype=np.int64)
        ev = flatscene.evaluate(scene, attrs, _frames_on(attrs, frames))

        sel = scene.mkr_cam_index.cpu().numpy() == ci  # (M,) this camera
        if marker_mask is not None:
            sel = sel & np.asarray(marker_mask, bool)
        sel_idx = np.nonzero(sel)[0]
        if sel_idx.size < 8:
            result = results_mod.SolverResult()
            result.success = False
            result.reason_string = (
                "camera solve needs >= 8 markers, got %d" % sel_idx.size
            )
            return attrs, [result]

        pick = torch.as_tensor(sel_idx, device=device)
        marker_xy = ev.marker_xy[pick]  # (Ms, F, 2)
        enable = (
            (ev.marker_enable[pick] > 0.5) & (ev.marker_weight[pick] > 0.0)
        ).cpu().numpy()

        # Intrinsics from the camera's attributes at the first frame.
        cv = gather_attr_values_static(
            attrs, scene.cam_attr_codes[ci], int(frames[0])
        ).tolist()
        names = flatscene.CAM_ATTRS
        fbw = cv[names.index("sensor_width_mm")]
        fbh = cv[names.index("sensor_height_mm")]
        focal0 = cv[names.index("focal_length_mm")]
        render = scene.cam_render_size[ci].tolist()
        render_aspect = render[0] / render[1]
        image_width = render[0]

        origin = (
            0 if self.origin_frame is None
            else list(self.frame_indices).index(int(self.origin_frame))
        )
        result_sfm, ba_result, focal = camerasolve.camera_solve_full(
            marker_xy, enable,
            focal_length_mm=focal0,
            film_back_width_mm=fbw,
            film_back_height_mm=fbh,
            render_aspect=render_aspect,
            image_width=image_width,
            solve_focal=self.solve_focal,
            sampler=self.sampler,
            min_pair_separation=self.min_pair_separation,
            refine_rounds=self.refine_rounds,
            max_bundle_error_px=self.max_bundle_error_px,
            ba_iterations=self.ba_iterations,
            origin_frame=origin,
            scene_scale=self.scene_scale,
            device=device,
        )

        attrs = self._write_back(
            scene, attrs, frames, sel_idx, result_sfm, focal
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        solve_seconds = time.perf_counter() - t0

        # Final deviation stats through the real residual pipeline.
        # Bundles culled by the bad-bundle filter are excluded — their
        # markers no longer participate in the solve (ref: the reference
        # disables filtered bundles' markers,
        # solvercamerautils.py:182-227).
        eval_mask = np.zeros((scene.num_markers, len(frames)), bool)
        eval_mask[sel_idx[result_sfm.point_valid]] = True
        result = results_mod.SolverResult()
        result.success = bool(np.all(result_sfm.frame_solved))
        result.stop_reason = int(ba_result.stop_reason)
        result.reason_string = (
            "camera solve: %d/%d frames, %d/%d bundles, focal=%.3fmm"
            % (
                int(result_sfm.frame_solved.sum()), len(frames),
                int(result_sfm.point_valid.sum()),
                result_sfm.point_valid.size, focal,
            )
        )
        result.iterations = int(ba_result.iterations)
        result.error_initial = float(ba_result.cost_initial)
        _set_deviation(result, scene, attrs, frames, options,
                       marker_frame_mask=eval_mask)
        result.timer.solve_seconds = solve_seconds
        return attrs, [result]

    def _write_back(self, scene, attrs, frames, sel_idx, result_sfm,
                    focal):
        """Scatter solved poses/bundles/focal into the attr block; the
        new block lies on the scene's device."""
        ci = self.camera_index
        like = attrs.static_values
        static = attrs.static_values.cpu().numpy().copy()
        anim = attrs.anim_values.cpu().numpy().copy()

        def write(code, values, frame_sel=None):
            code = int(code)
            if code < 0:
                return
            if code % 2 == 0:
                static[code // 2] = float(np.asarray(values).reshape(-1)[0])
            elif frame_sel is None:
                anim[code // 2, :] = values
            else:
                anim[code // 2, frame_sel] = values

        # Camera pose (animated tx..rz at the solved frames).
        all_tfm_codes = scene.tfm_attr_codes.cpu().numpy()
        cam_tfm = int(scene.cam_tfm_index[ci])
        tfm_codes = all_tfm_codes[cam_tfm]
        if np.any(tfm_codes[:6] % 2 == 0):
            raise ValueError(
                "camera solve requires animated camera tx..rz attributes"
            )
        ro = int(scene.tfm_rotate_order[cam_tfm])
        eulers = matrix_to_euler(result_sfm.rotations, ro).cpu().numpy()
        positions = result_sfm.positions.cpu().numpy()
        points3d = result_sfm.points3d.cpu().numpy()
        solved_f = np.asarray(result_sfm.frame_solved)
        fsel = np.asarray(frames)[solved_f]
        for k in range(3):
            write(tfm_codes[k], positions[solved_f, k], fsel)
            write(tfm_codes[3 + k], eulers[solved_f, k], fsel)

        # Bundle positions (first valid marker wins per bundle).
        mkr_bnd = scene.mkr_bnd_index.cpu().numpy()
        bnd_tfm = scene.bnd_tfm_index.cpu().numpy()
        tfm_parent = scene.tfm_parent.cpu().numpy()
        written = set()
        for mi_local, mi in enumerate(sel_idx):
            if not result_sfm.point_valid[mi_local]:
                continue
            bi = int(mkr_bnd[mi])
            if bi in written:
                continue
            written.add(bi)
            tfm = int(bnd_tfm[bi])
            if tfm_parent[tfm] >= 0:
                continue  # parented bundles keep their rig
            for k in range(3):
                write(all_tfm_codes[tfm, k], points3d[mi_local, k])

        # Solved focal length.
        if self.solve_focal:
            fcode = int(
                scene.cam_attr_codes[
                    ci, flatscene.CAM_ATTRS.index("focal_length_mm")
                ]
            )
            write(fcode, np.full(len(frames), focal),
                  np.asarray(frames))

        return dataclasses.replace(
            attrs,
            static_values=torch.as_tensor(static, device=like.device),
            anim_values=torch.as_tensor(anim, device=like.device),
        )
