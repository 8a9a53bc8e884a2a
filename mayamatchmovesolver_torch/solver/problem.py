"""Solve-problem definition: parameters <-> attributes, residual assembly.

Port of mayamatchmovesolver_tpu/solver/problem.py (ref:
src/mmSolver/adjust/adjust_solveFunc.cpp:529, adjust_measureErrors.cpp:
392-521, adjust_setParameters.cpp:174-250):

  * a parameter vector maps onto attribute storage by an out-of-place
    scatter (setParameters) — static attrs or (animated attr, frame)
    cells;
  * the scene is evaluated for all frames at once;
  * residuals are the weighted pixel deviations plus optional line and
    stiffness/smoothness soft constraints.

residual_fn is a pure function of the parameter vector, so the LM core
differentiates it with torch.func.
"""

import dataclasses

import numpy as np
import torch

from mayamatchmovesolver_torch.scene.attrblock import AttrBlock
from mayamatchmovesolver_torch.scene import flatscene
from mayamatchmovesolver_torch.solver import bounds
from mayamatchmovesolver_torch.solver import loss as loss_mod

# Behind-camera residual inflation
# (ref: src/mmSolver/adjust/adjust_measureErrors.cpp:262-270).
BEHIND_CAMERA_ERROR_FACTOR = 1.0e6

ERRORS_PER_MARKER = 2


@dataclasses.dataclass(frozen=True)
class SolveProblem:
    """A fully-specified least-squares problem over scene attributes.

    Every tensor lies on the attributes' device; index tensors are int64.
    """

    scene: flatscene.FlatScene
    attrs: AttrBlock  # initial attribute values
    frame_indices: torch.Tensor  # (F,) into the baked frame axis

    # Parameter layout.  param_codes[i] is the packed attr code the i-th
    # parameter writes; param_frames[i] is the baked frame index for
    # animated attrs or -1 for static.
    param_codes: torch.Tensor  # (P,)
    param_frames: torch.Tensor  # (P,)
    param_min: torch.Tensor  # (P,)
    param_max: torch.Tensor  # (P,)
    param_offset: torch.Tensor  # (P,)
    param_scale: torch.Tensor  # (P,)

    # Stiffness/smoothness soft constraints with LIVE targets: mode 1
    # (stiffness) reads the previous frame's value from the current
    # attribute state, mode 2 (smoothness) the linear prediction from
    # the two previous frames, mode 0 the fixed stiff_target
    # (ref: adjust_measureErrors.cpp:311-387).
    stiff_codes: torch.Tensor  # (K,) attr codes
    stiff_frames: torch.Tensor  # (K,) baked frame index (-1 static)
    stiff_prev_frames: torch.Tensor  # (K,) previous-frame index
    stiff_prev2_frames: torch.Tensor  # (K,) frame-before-previous
    stiff_mode: torch.Tensor  # (K,) 0 fixed, 1 stiffness, 2 smooth
    stiff_weight: torch.Tensor  # (K,)
    stiff_variance: torch.Tensor  # (K,)
    stiff_target: torch.Tensor  # (K,) fixed targets (mode 0 only)

    # Line straightness constraints: each line is a padded set of marker
    # indices whose reprojected bundles must be collinear in screen
    # space (ref: src/mmSolver/node/MMLineBestFitNode.cpp:94).
    line_mkr_index: torch.Tensor  # (L, K), padded
    line_mkr_mask: torch.Tensor  # (L, K) bool, False on padding
    line_weight: torch.Tensor  # (L,)

    # Marker-frame error enablement beyond marker enable/weight
    # (ref: adjust_measureErrors.cpp:430-444).
    marker_frame_mask: torch.Tensor  # (M, F) bool

    # Optional per-camera lens bindings (models/scenelens.SceneLens);
    # None disables lens distortion in the residual path.
    lens: object

    loss_type: int
    loss_scale: float

    # Image width used to convert normalized deviation into pixels
    # (ref: adjust_measureErrors.cpp dx * imageWidth).
    image_width: float

    @property
    def num_params(self):
        return self.param_codes.shape[0]

    @property
    def num_frames(self):
        return self.frame_indices.shape[0]

    @property
    def num_marker_errors(self):
        return self.scene.num_markers * self.num_frames * ERRORS_PER_MARKER

    @property
    def num_line_errors(self):
        return (
            self.line_mkr_index.shape[0]
            * self.line_mkr_index.shape[1]
            * self.num_frames
        )


def initial_parameters(problem: SolveProblem):
    """Read current attr values and map to internal (unbounded) params.

    (ref: get_initial_parameters, adjust_base.cpp:260-300.)
    """
    codes = problem.param_codes
    idx = torch.clamp(codes, min=0) // 2
    attrs = problem.attrs
    s = attrs.static_values[torch.clamp(idx, 0, attrs.num_static - 1)]
    frame = torch.clamp(problem.param_frames, 0, attrs.num_frames - 1)
    a = attrs.anim_values[torch.clamp(idx, 0, attrs.num_anim - 1), frame]
    external = torch.where(codes % 2 == 1, a, s)
    return bounds.external_to_internal(
        external,
        problem.param_min,
        problem.param_max,
        problem.param_offset,
        problem.param_scale,
    )


def insert_parameters(problem: SolveProblem, params) -> AttrBlock:
    """Write internal parameters into a fresh AttrBlock.

    (ref: setParameters, adjust_setParameters.cpp:174-250.)  Parameters
    of the other kind write to one padding row past the end, which is
    sliced off: torch has no dropping scatter, and an out-of-range index
    fails on the device.  Out of place, so it runs under jvp and vmap.
    """
    external = bounds.internal_to_external(
        params,
        problem.param_min,
        problem.param_max,
        problem.param_offset,
        problem.param_scale,
    )
    attrs = problem.attrs
    codes = problem.param_codes
    is_static = (codes >= 0) & (codes % 2 == 0)
    is_anim = (codes >= 0) & (codes % 2 == 1)
    idx = torch.clamp(codes, min=0) // 2

    static = attrs.static_values
    sidx = torch.where(is_static, idx, attrs.num_static)
    static_values = torch.cat([static, static.new_zeros(1)]).index_put(
        (sidx,), external.to(static.dtype)
    )[:-1]
    anim = attrs.anim_values
    aidx = torch.where(is_anim, idx, attrs.num_anim)
    frame = torch.clamp(problem.param_frames, 0, attrs.num_frames - 1)
    anim_values = torch.cat(
        [anim, anim.new_zeros(1, attrs.num_frames)]
    ).index_put((aidx, frame), external.to(anim.dtype))[:-1]
    return AttrBlock(static_values=static_values, anim_values=anim_values)


def _gather_cell_values(attrs: AttrBlock, codes, frames):
    """Value of attr `codes` at baked-frame `frames` (-1 -> static)."""
    idx = torch.clamp(codes, min=0) // 2
    s = attrs.static_values[torch.clamp(idx, 0, attrs.num_static - 1)]
    a = attrs.anim_values[
        torch.clamp(idx, 0, attrs.num_anim - 1),
        torch.clamp(frames, 0, attrs.num_frames - 1),
    ]
    v = torch.where(codes % 2 == 1, a, s)
    return torch.where(codes < 0, torch.zeros_like(v), v)


def _scene_residuals(problem: SolveProblem, attrs: AttrBlock, distort_fn):
    """The residuals that come from the scene evaluation: marker
    deviations (M, F, 2) and line terms (L, K, F) (None without lines);
    then the scene eval, the lens-mapped point_xy and the (M, F) mask."""
    ev = flatscene.evaluate(problem.scene, attrs, problem.frame_indices)
    point_xy = ev.point_xy
    if distort_fn is not None:
        point_xy = distort_fn(problem, attrs, point_xy)
    elif problem.lens is not None:
        from mayamatchmovesolver_torch.models import scenelens

        point_xy = scenelens.apply_scene_lens(
            problem.lens, problem.scene, attrs, problem.frame_indices,
            point_xy, problem.scene.mkr_cam_index, direction="distort",
        )

    mask = (
        problem.marker_frame_mask
        & (ev.marker_enable > 0.5)
        & (ev.marker_weight > 0.0)
    )  # (M, F)

    weight = torch.sqrt(torch.clamp(ev.marker_weight, min=0.0))
    behind = torch.where(ev.behind_camera, BEHIND_CAMERA_ERROR_FACTOR, 1.0)

    # Signed residual; the reference uses fabs() which has the same
    # least-squares objective but a kinked derivative
    # (adjust_measureErrors.cpp:278-282).
    d = (ev.marker_xy - point_xy) * problem.image_width  # (M, F, 2)
    d = torch.where(torch.isfinite(d), d, 0.0)
    r_mkr = d * (weight * behind * mask)[..., None]

    # Line straightness: perpendicular deviation of each member's
    # reprojected bundle from the weighted TLS line fit of its group,
    # per frame (ref: MMLineBestFitNode.cpp:94, math/line.rs).
    line_res = None
    if problem.line_mkr_index.shape[0]:
        li = problem.line_mkr_index  # (L, K)
        pts = point_xy[li]  # (L, K, F, 2)
        # A member participates when it is real (not padding) and its
        # marker is enabled on that frame; marker_frame_mask governs
        # reprojection errors only.
        member = (
            problem.line_mkr_mask[:, :, None] & (ev.marker_enable > 0.5)[li]
        )  # (L, K, F)
        wf = member.to(pts.dtype)
        n = torch.clamp(torch.sum(wf, dim=1), min=1.0)  # (L, F)
        mean = torch.sum(pts * wf[..., None], dim=1) / n[..., None]
        dl = (pts - mean[:, None]) * wf[..., None]  # (L, K, F, 2)
        sxx = torch.sum(dl[..., 0] ** 2, dim=1)
        syy = torch.sum(dl[..., 1] ** 2, dim=1)
        sxy = torch.sum(dl[..., 0] * dl[..., 1], dim=1)
        theta = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)  # (L, F)
        perp = (
            dl[..., 0] * -torch.sin(theta)[:, None]
            + dl[..., 1] * torch.cos(theta)[:, None]
        )  # (L, K, F)
        line_res = (
            perp * problem.line_weight[:, None, None] * problem.image_width
        )
        line_res = torch.where(torch.isfinite(line_res), line_res, 0.0)
    return r_mkr, line_res, ev, point_xy, mask


def _soft_residuals(problem: SolveProblem, x, prev, prev2, weight):
    """Stiffness/smoothness: err = (1/gaussian(x, target, var) - 1) * w
    (ref: adjust_measureErrors.cpp:311-387), from the constrained cells'
    values and those of their one and two frames earlier."""
    target = torch.where(
        problem.stiff_mode == 1,
        prev,
        torch.where(
            problem.stiff_mode == 2, 2.0 * prev - prev2, problem.stiff_target
        ),
    )
    z = (x - target) ** 2 / (2.0 * problem.stiff_variance**2)
    return (torch.exp(z) - 1.0) * weight


def _residuals(problem: SolveProblem, attrs: AttrBlock, apply_loss,
               distort_fn):
    """(residuals, scene eval, lens-mapped point_xy, (M, F) mask)."""
    r_mkr, line_res, ev, point_xy, mask = _scene_residuals(
        problem, attrs, distort_fn
    )
    marker_residuals = r_mkr.reshape(-1)
    # Soft constraints with live targets, read from the candidate `attrs`.
    soft = _soft_residuals(
        problem,
        _gather_cell_values(attrs, problem.stiff_codes, problem.stiff_frames),
        _gather_cell_values(
            attrs, problem.stiff_codes, problem.stiff_prev_frames
        ),
        _gather_cell_values(
            attrs, problem.stiff_codes, problem.stiff_prev2_frames
        ),
        problem.stiff_weight,
    )
    if line_res is not None:
        line_residuals = line_res.reshape(-1)
    else:
        line_residuals = marker_residuals.new_zeros(0)

    residuals = torch.cat([marker_residuals, line_residuals, soft])
    if apply_loss:
        residuals = loss_mod.apply_loss_to_residuals(
            residuals, problem.loss_type, problem.loss_scale
        )
    return residuals, ev, point_xy, mask


def measure_residuals(problem: SolveProblem, attrs: AttrBlock,
                      apply_loss=True, distort_fn=None):
    """Evaluate the scene and assemble the residual vector.

    Returns (residuals, aux) where residuals is (M*F*2 + L*K*F + K,) —
    marker x/y deviations in pixels, line terms, then soft constraints —
    and aux carries the user-facing deviation stats
    (ref: measureErrors, adjust_measureErrors.cpp:392-521).

    distort_fn, if given, maps projected points through a lens model:
    (problem, attrs, point_xy) -> point_xy.
    """
    residuals, ev, point_xy, mask = _residuals(
        problem, attrs, apply_loss, distort_fn
    )
    # Deviation stats exclude weight/loss, include behind-factor
    # (ref: adjust_measureErrors.cpp:285-292).  Non-finite deviations
    # are excluded like the reference skips them (adjust_base.cpp:356).
    dist = (
        torch.linalg.norm(ev.marker_xy - point_xy, dim=-1)
        * problem.image_width
    )
    mask = mask & torch.isfinite(dist)
    dist = torch.where(torch.isfinite(dist), dist, 0.0)
    n_measured = torch.clamp(torch.sum(mask), min=1)
    error_avg = torch.sum(torch.where(mask, dist, 0.0)) / n_measured
    error_max = torch.max(torch.where(mask, dist, -torch.inf))
    error_min = torch.min(torch.where(mask, dist, torch.inf))
    aux = {
        "error_avg": error_avg,
        "error_min": error_min,
        "error_max": error_max,
        "per_marker_frame_distance": dist,
        "mask": mask,
        "num_measured": torch.sum(mask),
    }
    return residuals, aux


def residual_fn(problem: SolveProblem, distort_fn=None):
    """params -> residual vector, the function the LM core differentiates.

    (The reference equivalent is one solveFunc call: setParameters +
    measureErrors; ref: adjust_solveFunc.cpp:529-622.)  The deviation
    stats of measure_residuals are not computed here.
    """

    def fn(params):
        attrs = insert_parameters(problem, params)
        return _residuals(problem, attrs, True, distort_fn)[0]

    return fn



# ---- Per-frame solves: one problem per frame, all frames at once. --------
#
# The per-frame sweep solves, for every frame f, the problem whose only
# unknowns are the animated parameters AT f, with everything else read
# from the base attributes.  The functions below evaluate all those
# problems in one pass over the frame axis; row f of their (F, .) results
# is what the single-frame problem of f gives on its own.


def per_frame_problem(base: SolveProblem, frame_indices, full_mask):
    """`base` measured over all of `frame_indices` with the (M, F) mask."""
    return dataclasses.replace(
        base, frame_indices=frame_indices, marker_frame_mask=full_mask
    )


def per_frame_initial_parameters(base: SolveProblem, frame_indices):
    """(F, P) internal parameters: row f reads the base attributes at
    frame f.  Every parameter of `base` is animated."""
    channels = base.param_codes // 2
    external = base.attrs.anim_values[
        channels[None, :], frame_indices[:, None]
    ]
    return bounds.external_to_internal(
        external,
        base.param_min[None, :],
        base.param_max[None, :],
        base.param_offset[None, :],
        base.param_scale[None, :],
    )


def per_frame_external(base: SolveProblem, params):
    """(F, P) internal parameters as attribute values."""
    return bounds.internal_to_external(
        params,
        base.param_min[None, :],
        base.param_max[None, :],
        base.param_offset[None, :],
        base.param_scale[None, :],
    )


def scatter_frame_values(base: SolveProblem, frame_indices, external):
    """The base attributes with external[f, p] written to the animated
    cell (channel of p, frame f).  Out of place."""
    channels = base.param_codes // 2
    anim = base.attrs.anim_values
    shape = external.shape
    cells = (
        channels[None, :].expand(shape),
        frame_indices[:, None].expand(shape),
    )
    anim_values = anim.index_put(cells, external.to(anim.dtype))
    return dataclasses.replace(base.attrs, anim_values=anim_values)


def per_frame_residual_fn(base: SolveProblem, frame_indices, full_mask,
                          distort_fn=None):
    """(F, P) params -> (F, m) residuals of the F single-frame problems.

    Row f holds frame f's marker and line terms and every soft
    constraint, weighted only where the constraint sits on frame f (the
    others are constants that would pollute the ftol test).  The scene
    reads each frame's cells from that frame's column only, so one
    evaluation with every row's candidates inserted serves all rows.
    The soft constraints reach across frames: row f sees the candidate
    only in cells of frame f, and the base attributes in its neighbours
    — not the other rows' candidates — like the reference's vmap over
    single-frame problems.
    """
    eval_problem = per_frame_problem(base, frame_indices, full_mask)
    num_frames = frame_indices.shape[0]
    last = base.attrs.num_frames - 1
    cells = [
        torch.clamp(frames, 0, last)
        for frames in (base.stiff_frames, base.stiff_prev_frames,
                       base.stiff_prev2_frames)
    ]
    held = [
        _gather_cell_values(base.attrs, base.stiff_codes, c) for c in cells
    ]
    own = [c[None, :] == frame_indices[:, None] for c in cells]  # (F, K)
    weight = torch.where(
        base.stiff_frames[None, :] == frame_indices[:, None],
        base.stiff_weight[None, :], 0.0,
    )

    def fn(params):
        attrs = scatter_frame_values(
            base, frame_indices, per_frame_external(base, params)
        )
        r_mkr, line_res, _, _, _ = _scene_residuals(
            eval_problem, attrs, distort_fn
        )
        parts = [r_mkr.permute(1, 0, 2).reshape(num_frames, -1)]
        if line_res is not None:
            parts.append(line_res.permute(2, 0, 1).reshape(num_frames, -1))
        x, prev, prev2 = (
            torch.where(
                o, _gather_cell_values(attrs, base.stiff_codes, c)[None, :],
                h[None, :],
            )
            for c, h, o in zip(cells, held, own)
        )
        parts.append(_soft_residuals(base, x, prev, prev2, weight))
        return loss_mod.apply_loss_to_residuals(
            torch.cat(parts, dim=1), base.loss_type, base.loss_scale
        )

    return fn


def make_marker_frame_mask(num_markers, num_frames, enabled_pairs=None):
    """A host (markers, frames) bool mask: every pair, or only the
    (marker, frame) pairs given."""
    if enabled_pairs is None:
        return np.ones((num_markers, num_frames), dtype=bool)
    mask = np.zeros((num_markers, num_frames), dtype=bool)
    for m, f in enabled_pairs:
        mask[m, f] = True
    return mask
