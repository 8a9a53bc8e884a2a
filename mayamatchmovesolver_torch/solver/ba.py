"""Structured bundle adjustment: Schur complement over camera/bundle
blocks with a shared-parameter border (arrowhead), never forming the
dense Jacobian.

Port of mayamatchmovesolver_tpu/solver/ba.py (ref:
adjust_cminpack_lmdif.cpp:61-202, adjust_solveFunc.cpp:305-525; the
border is the reference's static-attribute coupling,
docs/source/solver_design.rst:188-218):

  * camera parameters (C*F, 6): per-(camera, frame) pose blocks, laid
    out camera-major;
  * bundle parameters (B, 3);
  * shared (border) parameters (S,): focal length(s) and solved lens
    coefficients, coupling every frame;
  * residual r_{m,f} depends on (camera block of (m, f), bundle b(m),
    shared).

Per-observation residuals carry the dense path's physics: film-fit
projection, lens distortion of the reprojected point, behind-camera
x1e6, sqrt weights and the robust-loss rescale.  Their Jacobian blocks
come from one of two assemblies, chosen per call: 'ad'
(torch.func.vmap of jacfwd of the one-observation residual, the
reference's default) or 'analytic' (per-frame Q Jacobians and the
perspective / lens / loss chain rule).  The normal equations are
assembled with einsums, bundles are eliminated in closed form (batched
3x3 inverses), and the reduced [camera | border] system

    [ S_cc  S_cs ] [dx_c]   [rhs_c]
    [ S_sc  S_ss ] [dx_s] = [rhs_s]

is solved by Cholesky or by block-Jacobi preconditioned CG.  An LM loop
with the true gain ratio and Nielsen's mu update wraps it, with the
eps1/2/3 stops of solver/lm.py.

Precision: every einsum and factorization runs in the working dtype with
TF32 off (torch's default, which this module does not change).
"""

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import jacfwd, jvp, vmap

from mayamatchmovesolver_torch.core import camera as cam_math
from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.core.constants import MM_TO_INCH
from mayamatchmovesolver_torch.models import base as lens_base
from mayamatchmovesolver_torch.models import scenelens, tde
from mayamatchmovesolver_torch.scene.flatscene import NEAR_CLIP_PLANE_CM
from mayamatchmovesolver_torch.solver import loss as loss_mod

CAM_PARAMS_POSE = 6  # tx ty tz rx ry rz

# Behind-camera residual inflation, shared with the dense path
# (ref: src/mmSolver/adjust/adjust_measureErrors.cpp:262-270).
BEHIND_CAMERA_ERROR_FACTOR = 1.0e6

# Jacobian assembly backends: per-observation forward AD, or the
# analytic chain rule.  Both give the same blocks.
ASSEMBLIES = ("ad", "analytic")

# Models whose distort direction is the iterative fixed-point inverse
# (ldpk convention: classic and anamorphic are native in the undistort
# direction); the analytic assembly differentiates them through the
# implicit-function theorem instead of through the loop.
_FIXED_POINT_DISTORT_MODELS = (
    scenelens.LENS_MODEL_CLASSIC,
    scenelens.LENS_MODEL_ANAMORPHIC_DEG4,
    scenelens.LENS_MODEL_ANAMORPHIC_DEG4_RESCALED,
)


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Tensors fully describing the structured BA problem, all on one
    device; the configuration fields are plain Python values."""

    marker_uv: torch.Tensor  # (M, F, 2) observed, film-fit-scaled space
    weight: torch.Tensor  # (M, F) sqrt-applied marker weights * mask
    mkr_bnd_index: torch.Tensor  # (M,) int64 bundle index per marker
    # Camera-block offset per marker: cam_index * F (zeros for one
    # camera); cam_params is camera-major (C*F, 6).
    mkr_cam_block: torch.Tensor  # (M,) int64
    cam_params: torch.Tensor  # (C*F, 6) initial camera pose params
    bnd_params: torch.Tensor  # (B, 3) initial bundle positions
    shared_params: torch.Tensor  # (S,) border params: [focal?] + lens
    intrinsics: torch.Tensor  # (C*F, 8) [focal, fbw_mm, fbh_mm,
    #                           offx_mm, offy_mm, far_cm, cam_scale,
    #                           render_aspect]
    lens_params: torch.Tensor  # (P_l,) full fixed lens parameter vector
    lens_pixel_aspect: torch.Tensor  # () pixel aspect for the lens model
    film_fit: int
    rotate_order: int
    image_width: float
    # Border layout: focal slots first (one per camera, if solved), then
    # the lens parameters selected by lens_solve_mask, in field order.
    solve_focal: bool
    lens_model_type: str
    lens_solve_mask: Tuple[bool, ...]
    loss_type: int
    loss_scale: float

    def _replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    @property
    def num_cameras(self):
        return self.cam_params.shape[0] // self.marker_uv.shape[1]

    @property
    def num_shared(self):
        focal_slots = self.num_cameras if self.solve_focal else 0
        return focal_slots + sum(1 for m in self.lens_solve_mask if m)


@dataclasses.dataclass(frozen=True)
class BAResult:
    cam_params: torch.Tensor
    bnd_params: torch.Tensor
    shared_params: torch.Tensor
    cost: torch.Tensor
    cost_initial: torch.Tensor
    iterations: torch.Tensor
    stop_reason: torch.Tensor  # 1 ftol, 2 xtol, 3 gtol, 4 maxiter, 5 fail
    gradient_norm: torch.Tensor
    # Counted evaluation totals: func_evals = cost-only evaluations
    # (initial cost + one trial cost per iteration); jacobian_evals =
    # block assemblies (one per iteration).  Ref: the reference's
    # measured counters in adjust_results.h:59-940.
    func_evals: torch.Tensor
    jacobian_evals: torch.Tensor


def _static_cfg(problem: BAProblem):
    return (
        problem.film_fit,
        problem.rotate_order,
        problem.image_width,
        problem.solve_focal,
        # One border focal per camera when focal is solved.
        problem.num_cameras if problem.solve_focal else 0,
        problem.lens_model_type,
        problem.lens_solve_mask,
        problem.loss_type,
        problem.loss_scale,
    )


# Forward AD and 0-dim tensors: torch.func gives the tangent of a 0-dim
# float32 tensor combined with a Python float the dtype float64 (the
# scalar loses its weak type in the derivative formula), and the next
# matmul then fails on the mixed dtypes.  The functions below that
# jacfwd differentiates therefore keep every differentiated quantity at
# least 1-dim: scalars are taken as 1-element slices, and one observation
# is a batch of one.


def _select(vec, slot):
    """vec[slot:slot+1] where slot may be batched under vmap: a masked
    sum, exact, and differentiable like indexing."""
    onehot = torch.arange(vec.shape[0], device=vec.device) == slot
    return torch.sum(torch.where(onehot, vec, 0.0), dim=0, keepdim=True)


def _lens_values(lens_solve_mask, solved_values, fixed_values):
    """Full lens parameter list as 1-element tensors: solved entries from
    `solved_values` in order, the rest from `fixed_values`."""
    values = []
    si = 0
    for pi, solved in enumerate(lens_solve_mask):
        if solved:
            values.append(solved_values[si:si + 1])
            si += 1
        else:
            values.append(fixed_values[pi:pi + 1])
    return values


def _film_back(fbw_mm, fbh_mm, offx_mm, offy_mm, pixel_aspect):
    return lens_base.FilmBack(
        film_back_width_cm=fbw_mm * 0.1,
        film_back_height_cm=fbh_mm * 0.1,
        lens_center_offset_x_cm=offx_mm * 0.1,
        lens_center_offset_y_cm=offy_mm * 0.1,
        pixel_aspect=pixel_aspect,
    )


def _camera_matrices(cam_vec, focal, intr, film_fit, rotate_order):
    """(inverse camera world matrix, projection matrix) of one camera
    block, each (1, 4, 4); focal is (1,)."""
    cam_world = tfm_math.trs_matrix(
        *(cam_vec[i:i + 1] for i in range(CAM_PARAMS_POSE)),
        1.0, 1.0, 1.0, rotate_order,
    )
    cam_inv = tfm_math.affine_inverse(cam_world)
    proj = cam_math.projection_matrix(
        focal,
        intr[1] * MM_TO_INCH,
        intr[2] * MM_TO_INCH,
        intr[3] * MM_TO_INCH,
        intr[4] * MM_TO_INCH,
        intr[7],
        1.0,
        torch.as_tensor(film_fit, device=intr.device),
        NEAR_CLIP_PLANE_CM,
        intr[5],
        intr[6],
    )
    return cam_inv, proj


def _observation_residual(cam_vec, bnd_vec, shared_vec, intr, weight,
                          lens_fixed, pixel_aspect, static_cfg, uv,
                          focal_slot=0):
    """Residual of ONE (marker, frame) observation; the unit the AD
    assembly differentiates.  cam_vec: (6,), bnd_vec: (3,), shared_vec:
    (S,), weight: scalar sqrt-weight*mask; focal_slot selects this
    observation's camera's border focal.

    Matches the dense path's marker residual (solver/problem.py):
    film-fit projection, lens distortion of the reprojected point,
    behind-camera x1e6, NaN guard, sqrt-weight scaling, then the
    robust-loss rescale."""
    (film_fit, rotate_order, image_width, solve_focal, num_focal_slots,
     lens_model_type, lens_solve_mask, loss_type, loss_scale) = static_cfg

    s_idx = 0
    if solve_focal:
        focal = _select(shared_vec[:num_focal_slots], focal_slot)
        s_idx = num_focal_slots
    else:
        focal = intr[0:1]
    cam_inv, proj = _camera_matrices(cam_vec, focal, intr, film_fit,
                                     rotate_order)
    p = torch.cat([bnd_vec, torch.ones_like(bnd_vec[:1])])
    p_cam = cam_inv @ p  # (1, 4): the observation as a batch of one
    clip = (proj @ p_cam[..., None])[..., 0]
    point_xy = clip[..., :2] / clip[..., 3:4] * 0.5

    # Lens distortion of the reprojected point, with the dense path's
    # NaN fallback (ref: adjust_measureErrors.cpp:249-270,464-480).
    if lens_model_type:
        model = scenelens._build_model(
            lens_model_type,
            _lens_values(lens_solve_mask, shared_vec[s_idx:], lens_fixed),
        )
        fb = _film_back(intr[1], intr[2], intr[3], intr[4], pixel_aspect)
        mapped = tde.distort(model, fb, point_xy)
        point_xy = torch.where(torch.isfinite(mapped), mapped, point_xy)

    # The camera looks down its local -Z: positive camera-space z is
    # behind it.
    factor = torch.where(p_cam[..., 2:3] > 0.0, BEHIND_CAMERA_ERROR_FACTOR,
                         1.0)

    d = (uv - point_xy) * image_width
    d = torch.where(torch.isfinite(d), d, 0.0)
    r = d * (factor * weight)
    return loss_mod.apply_loss_to_residuals(r, loss_type, loss_scale)[0]


def _frame_ids(num_frames, like):
    return torch.arange(num_frames, device=like.device)


def _gather_cam(x, cam_block, num_frames):
    """Per-marker view of camera-major block tensors: (C*F, ...) ->
    (M, F, ...) selecting each marker's camera's frame blocks."""
    return x[cam_block[:, None] + _frame_ids(num_frames, x)[None, :]]


def _segment_sum(data, segment_ids, num_segments):
    """Sum rows of `data` into `num_segments` rows by segment id (the
    reference's jax.ops.segment_sum)."""
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


def _scatter_frames(contrib_mf, cam_block, num_cam_blocks):
    """Scatter-add (M, F, ...) per-observation contributions into the
    camera-major block axis (C*F, ...)."""
    m, f = contrib_mf.shape[:2]
    seg = (cam_block[:, None] + _frame_ids(f, contrib_mf)[None, :])
    return _segment_sum(
        contrib_mf.reshape((m * f,) + contrib_mf.shape[2:]),
        seg.reshape(-1), num_cam_blocks,
    )


def _residual_and_blocks(problem: BAProblem, cam_params, bnd_params,
                         shared_params, assembly="ad"):
    """All residuals + per-observation Jacobian blocks, batched.

    Returns (r, j_cam, j_bnd, j_shared) shaped (M, F, 2[, ...])."""
    if assembly == "ad":
        return _residual_and_blocks_ad(
            problem, cam_params, bnd_params, shared_params
        )
    if assembly != "analytic":
        raise ValueError("assembly must be one of %r" % (ASSEMBLIES,))
    if (problem.lens_model_type
            and cam_params.shape[0] != problem.marker_uv.shape[1]):
        raise ValueError(
            "the analytic assembly does not cover a multi-camera rig "
            "with a lens; use assembly='ad'"
        )
    return _residual_and_blocks_analytic(
        problem, cam_params, bnd_params, shared_params
    )


def _residual_and_blocks_ad(problem: BAProblem, cam_params, bnd_params,
                            shared_params):
    """Per-observation forward-AD assembly: vmap over markers and
    frames of jacfwd of the one-observation residual."""
    static = _static_cfg(problem)
    bnd_per_marker = bnd_params[problem.mkr_bnd_index]  # (M, 3)
    num_frames = problem.marker_uv.shape[1]
    focal_slots = problem.mkr_cam_block // num_frames  # (M,) cam index

    def obs(cam_vec, bnd_vec, shared, intr, w, uv, slot):
        r = _observation_residual(
            cam_vec, bnd_vec, shared, intr, w, problem.lens_params,
            problem.lens_pixel_aspect, static, uv, focal_slot=slot,
        )
        return r, r

    # The residual comes back as jacfwd's aux: one pass gives both.
    jac = jacfwd(obs, argnums=(0, 1, 2), has_aux=True)

    def frame_fn(cam_vec, intr, w, uv, bnd_vec, slot):
        (jc, jb, js), r = jac(cam_vec, bnd_vec, shared_params, intr, w,
                              uv, slot)
        return r, jc, jb, js

    per_marker = vmap(frame_fn, in_dims=(0, 0, 0, 0, None, None))
    if cam_params.shape[0] == num_frames:
        # One camera: every marker shares the frame axis' camera blocks
        # and its one focal slot, passed unbatched over markers, so the
        # per-frame camera work is done once per frame and not once per
        # observation.
        return vmap(
            lambda bnd_vec, uv_row, w_row: per_marker(
                cam_params, problem.intrinsics, w_row, uv_row, bnd_vec, 0,
            )
        )(bnd_per_marker, problem.marker_uv, problem.weight)
    cam_rows = _gather_cam(cam_params, problem.mkr_cam_block, num_frames)
    intr_rows = _gather_cam(problem.intrinsics, problem.mkr_cam_block,
                            num_frames)
    return vmap(
        lambda bnd_vec, uv_row, w_row, cams, intrs, slot: per_marker(
            cams, intrs, w_row, uv_row, bnd_vec, slot,
        )
    )(bnd_per_marker, problem.marker_uv, problem.weight, cam_rows,
      intr_rows, focal_slots)


def _frame_q_system(problem: BAProblem, cam_params, shared_params):
    """Per-frame-block projection system Q_f = P_f @ inv(M_f) and its
    Jacobians wrt the 6 pose params (and the border focal when solved),
    computed once per frame block.

    The per-observation residual factors as
        clip = Q_f @ [X_m, 1],   xy = clip_{0:2} / clip_3 * 0.5,
    so every camera-side derivative is a chain through Q.  Returns
    (q, dq_dcam, dq_dfocal_or_None, minv_row2)."""
    (film_fit, rotate_order, _image_width, solve_focal,
     _slots, _lmt, _mask, _lt, _ls) = _static_cfg(problem)
    intr = problem.intrinsics  # (C*F, 8), camera-major like cam blocks
    num_frames = problem.marker_uv.shape[1]
    num_blocks = cam_params.shape[0]
    if solve_focal:
        cam_index = torch.arange(num_blocks, device=intr.device) // num_frames
        focal_vec = shared_params[cam_index, None]
    else:
        focal_vec = intr[:, 0:1]  # (CF, 1)

    def qrow(cam_vec, focal, intr_row):
        cam_inv, proj = _camera_matrices(cam_vec, focal, intr_row,
                                         film_fit, rotate_order)
        return (proj @ cam_inv)[0], cam_inv[0, 2]

    def q_only(cam_vec, focal, intr_row):
        return qrow(cam_vec, focal, intr_row)[0]

    q, row2 = vmap(qrow)(cam_params, focal_vec, intr)
    dq_dcam = vmap(jacfwd(q_only, argnums=0))(
        cam_params, focal_vec, intr)  # (CF, 4, 4, 6)
    dq_dfocal = None
    if solve_focal:
        dq_dfocal = vmap(jacfwd(q_only, argnums=1))(
            cam_params, focal_vec, intr)[..., 0]  # (CF, 4, 4)
    return q, dq_dcam, dq_dfocal, row2


def _lens_blocks(problem: BAProblem, xy, lens_solved):
    """Lens distortion of the projected points and its Jacobians:
    (mapped, dmapped/dxy, dmapped/d(solved lens params)), shaped
    (M, F, 2), (M, F, 2, 2), (M, F, 2, S_l).  Single camera only."""
    mask = problem.lens_solve_mask
    n_lens_solved = lens_solved.shape[0]

    def lens_map(direction, pt, solved_vec, fbw, fbh, ox, oy):
        model = scenelens._build_model(
            problem.lens_model_type,
            _lens_values(mask, solved_vec, problem.lens_params),
        )
        fb = _film_back(fbw, fbh, ox, oy, problem.lens_pixel_aspect)
        return getattr(tde, direction)(model, fb, pt[None])[0]

    def jac_of(direction):
        def fn(pt, solved_vec, fbw, fbh, ox, oy):
            return lens_map(direction, pt, solved_vec, fbw, fbh, ox, oy)
        return jacfwd(fn, argnums=(0, 1) if n_lens_solved else 0)

    def split(jacs, like):
        if n_lens_solved:
            return jacs
        return jacs, like.new_zeros((2, 0))

    if problem.lens_model_type in _FIXED_POINT_DISTORT_MODELS:
        # Differentiating through the 20-step fixed-point inverse is the
        # costly way; the implicit-function theorem gives the same
        # Jacobian from one jacfwd of the loop-free undistort polynomial
        # at the converged point:
        #     U(mapped; theta) = xy  =>  dmapped/dxy   = G^{-1},
        #                                dmapped/dtheta = -G^{-1} H
        # with G = dU/dpt (2x2), H = dU/dtheta.
        undistort_jac = jac_of("undistort")

        def lens_val_jac(xy_pt, fbw, fbh, ox, oy):
            mapped = lens_map("distort", xy_pt, lens_solved, fbw, fbh, ox,
                              oy)
            g, h = split(undistort_jac(mapped, lens_solved, fbw, fbh, ox,
                                       oy), xy_pt)
            inv_det = 1.0 / (g[0, 0] * g[1, 1] - g[0, 1] * g[1, 0])
            g_inv = torch.stack([
                torch.stack([g[1, 1], -g[0, 1]]),
                torch.stack([-g[1, 0], g[0, 0]]),
            ]) * inv_det
            l_sh = -(g_inv @ h) if n_lens_solved else h
            return mapped, g_inv, l_sh
    else:
        distort_jac = jac_of("distort")

        def lens_val_jac(xy_pt, fbw, fbh, ox, oy):
            mapped = lens_map("distort", xy_pt, lens_solved, fbw, fbh, ox,
                              oy)
            l_xy, l_sh = split(distort_jac(xy_pt, lens_solved, fbw, fbh,
                                           ox, oy), xy_pt)
            return mapped, l_xy, l_sh

    intr = problem.intrinsics
    per_frame = vmap(lens_val_jac, in_dims=(0, 0, 0, 0, 0))
    per_obs = vmap(per_frame, in_dims=(0, None, None, None, None))
    return per_obs(xy, intr[:, 1], intr[:, 2], intr[:, 3], intr[:, 4])


def _residual_and_blocks_analytic(problem: BAProblem, cam_params,
                                  bnd_params, shared_params):
    """Analytic-chain-rule twin of _residual_and_blocks_ad: the same
    (r, j_cam, j_bnd, j_shared) tensors, assembled from per-frame Q
    Jacobians + the perspective-divide / lens / loss chains."""
    (_film_fit, _rotate_order, image_width, solve_focal, num_focal_slots,
     lens_model_type, lens_solve_mask, loss_type,
     loss_scale) = _static_cfg(problem)
    num_markers, num_frames = problem.marker_uv.shape[:2]
    single_cam = cam_params.shape[0] == num_frames
    dtype = cam_params.dtype
    n_lens_solved = sum(1 for m in lens_solve_mask if m)
    num_shared = (num_focal_slots if solve_focal else 0) + n_lens_solved

    q, dq_dcam, dq_dfocal, row2 = _frame_q_system(
        problem, cam_params, shared_params
    )

    bnd_m = bnd_params[problem.mkr_bnd_index]  # (M, 3)
    xh = torch.cat([bnd_m, bnd_m.new_ones((num_markers, 1))], dim=-1)

    if single_cam:
        clip = torch.einsum("fij,mj->mfi", q, xh)
        dclip_dcam = torch.einsum("fijk,mj->mfik", dq_dcam, xh)
        z_cam = torch.einsum("fj,mj->mf", row2, xh)
        # dclip/dX columns come straight from Q (homogeneous linear).
        q_rows = q[None]  # (1, F, 4, 4) broadcasting over markers
        dclip_df = (torch.einsum("fij,mj->mfi", dq_dfocal, xh)
                    if solve_focal else None)
    else:
        cam_block = problem.mkr_cam_block
        q_g = _gather_cam(q, cam_block, num_frames)
        clip = torch.einsum("mfij,mj->mfi", q_g, xh)
        dclip_dcam = torch.einsum(
            "mfijk,mj->mfik", _gather_cam(dq_dcam, cam_block, num_frames),
            xh)
        z_cam = torch.einsum(
            "mfj,mj->mf", _gather_cam(row2, cam_block, num_frames), xh)
        q_rows = q_g
        dclip_df = None
        if solve_focal:
            dclip_df = torch.einsum(
                "mfij,mj->mfi",
                _gather_cam(dq_dfocal, cam_block, num_frames), xh)

    inv_w = 0.5 / clip[..., 3]  # (M, F)
    xy = clip[..., :2] * inv_w[..., None]  # (M, F, 2)

    # d(xy_i) = (dclip_i - 2 xy_i dclip_3) * 0.5 / clip_3
    j_xy_cam = (
        dclip_dcam[..., :2, :]
        - 2.0 * xy[..., :, None] * dclip_dcam[..., 3, :][..., None, :]
    ) * inv_w[..., None, None]  # (M, F, 2, 6)
    # Bundle columns: dclip/dX = Q[:, :3].
    j_xy_bnd = (
        q_rows[..., :2, :3]
        - 2.0 * xy[..., :, None] * q_rows[..., 3:4, :3]
    ) * inv_w[..., None, None]  # (M, F, 2, 3)
    j_xy_foc = None
    if solve_focal:
        j_xy_foc = (dclip_df[..., :2]
                    - 2.0 * xy * dclip_df[..., 3:4]) * inv_w[..., None]

    if lens_model_type:
        s_idx = num_focal_slots if solve_focal else 0
        mapped, l_xy, l_sh = _lens_blocks(
            problem, xy, shared_params[s_idx:s_idx + n_lens_solved]
        )
        ok = torch.isfinite(mapped)  # per component, like the AD path
        pt = torch.where(ok, mapped, xy)
        j_pt_cam = torch.where(
            ok[..., None], torch.einsum("mfij,mfjk->mfik", l_xy, j_xy_cam),
            j_xy_cam)
        j_pt_bnd = torch.where(
            ok[..., None], torch.einsum("mfij,mfjk->mfik", l_xy, j_xy_bnd),
            j_xy_bnd)
        j_pt_lens = torch.where(ok[..., None], l_sh, 0.0)
        j_pt_foc = None
        if solve_focal:
            j_pt_foc = torch.where(
                ok, torch.einsum("mfij,mfj->mfi", l_xy, j_xy_foc), j_xy_foc)
    else:
        pt = xy
        j_pt_cam = j_xy_cam
        j_pt_bnd = j_xy_bnd
        j_pt_lens = xy.new_zeros((num_markers, num_frames, 2, 0))
        j_pt_foc = j_xy_foc

    # Residual: d = (uv - pt) * W, NaN-guarded, behind-camera x1e6,
    # sqrt-weight; the conditions are piecewise constant, so AD and the
    # chain rule agree on the masks.
    d = (problem.marker_uv - pt) * image_width
    fin = torch.isfinite(d)
    d = torch.where(fin, d, 0.0)
    factor = torch.where(z_cam > 0.0, BEHIND_CAMERA_ERROR_FACTOR, 1.0)
    scale = factor * problem.weight  # (M, F)
    r_pre = d * scale[..., None]
    j_scale = -(image_width * scale)[..., None, None]
    j_cam = torch.where(fin[..., None], j_pt_cam * j_scale, 0.0)
    j_bnd = torch.where(fin[..., None], j_pt_bnd * j_scale, 0.0)
    j_lens = torch.where(fin[..., None], j_pt_lens * j_scale, 0.0)
    j_foc = None
    if solve_focal:
        j_foc = torch.where(fin, j_pt_foc * j_scale[..., 0], 0.0)

    # Robust loss g(r) = r * s(r) is elementwise: its Jacobian is the
    # diagonal alpha = dg/dr, from one jvp with a ones tangent.
    if loss_type != int(loss_mod.RobustLossType.TRIVIAL):
        r, alpha = jvp(
            lambda t: loss_mod.apply_loss_to_residuals(
                t, loss_type, loss_scale),
            (r_pre,), (torch.ones_like(r_pre),),
        )
        j_cam = alpha[..., None] * j_cam
        j_bnd = alpha[..., None] * j_bnd
        j_lens = alpha[..., None] * j_lens
        if solve_focal:
            j_foc = alpha * j_foc
    else:
        r = r_pre

    # Border columns: [focal slots | solved lens params].
    if not num_shared:
        return r, j_cam, j_bnd, r.new_zeros((num_markers, num_frames, 2, 0))
    cols = []
    if solve_focal:
        onehot = torch.nn.functional.one_hot(
            problem.mkr_cam_block // num_frames, num_focal_slots
        ).to(dtype)  # (M, num_focal_slots)
        cols.append(j_foc[..., None] * onehot[:, None, None, :])
    if n_lens_solved:
        cols.append(j_lens)
    return r, j_cam, j_bnd, torch.cat(cols, dim=-1)


def ba_residuals(problem: BAProblem, cam_params, bnd_params,
                 shared_params=None):
    """Residual tensor (M, F, 2) without Jacobians: the accept/reject
    evaluation, and the synthesis hook for tests (observations
    generated through the model itself)."""
    if shared_params is None:
        shared_params = problem.shared_params
    static = _static_cfg(problem)
    bnd_per_marker = bnd_params[problem.mkr_bnd_index]
    num_frames = problem.marker_uv.shape[1]
    focal_slots = problem.mkr_cam_block // num_frames

    def per_marker(bnd_vec, uv_row, w_row, cams, intrs, slot):
        return vmap(
            lambda cam_vec, intr, w, uv: _observation_residual(
                cam_vec, bnd_vec, shared_params, intr, w,
                problem.lens_params, problem.lens_pixel_aspect, static, uv,
                focal_slot=slot,
            )
        )(cams, intrs, w_row, uv_row)

    if cam_params.shape[0] == num_frames:  # one camera: shared blocks
        return vmap(
            lambda bnd_vec, uv_row, w_row: per_marker(
                bnd_vec, uv_row, w_row, cam_params, problem.intrinsics, 0)
        )(bnd_per_marker, problem.marker_uv, problem.weight)
    return vmap(per_marker)(
        bnd_per_marker, problem.marker_uv, problem.weight,
        _gather_cam(cam_params, problem.mkr_cam_block, num_frames),
        _gather_cam(problem.intrinsics, problem.mkr_cam_block, num_frames),
        focal_slots,
    )


def ba_cost(problem: BAProblem, cam_params, bnd_params, shared_params):
    """Cost without Jacobians (the cheaper accept/reject check)."""
    r = ba_residuals(problem, cam_params, bnd_params, shared_params)
    return 0.5 * torch.sum(r * r)


def _damp(block, mu, floor=1e-12):
    """Marquardt damping: add mu*diag to a (..., n, n) block."""
    d = torch.clamp(torch.diagonal(block, dim1=-2, dim2=-1), min=floor)
    eye = torch.eye(block.shape[-1], dtype=block.dtype, device=block.device)
    return block + mu * d[..., None] * eye


class NormalBlocks(NamedTuple):
    """Normal-equation blocks of the arrowhead system."""

    cost: torch.Tensor  # 0.5*||r||^2
    b_blocks: torch.Tensor  # (CF, 6, 6) per-frame camera blocks
    g_cam: torch.Tensor  # (CF, 6)
    a_blocks: torch.Tensor  # (B, 3, 3) per-bundle blocks
    g_bnd: torch.Tensor  # (B, 3)
    w_mf: torch.Tensor  # (M, F, 3, 6) bundle-camera coupling
    hcs: torch.Tensor  # (CF, 6, S) camera-border coupling
    hbs: torch.Tensor  # (B, 3, S) bundle-border coupling
    hss: torch.Tensor  # (S, S) border block
    g_sh: torch.Tensor  # (S,)
    hbs_m: torch.Tensor  # (M, 3, S) per-marker bundle-border coupling


def assemble_normal_blocks(problem: BAProblem, cam_params, bnd_params,
                           shared_params, assembly="ad") -> NormalBlocks:
    """Assemble every block of the arrowhead normal equations from the
    batched per-observation Jacobians."""
    r, j_cam, j_bnd, j_sh = _residual_and_blocks(
        problem, cam_params, bnd_params, shared_params, assembly
    )
    num_bundles = bnd_params.shape[0]
    num_cam_blocks = cam_params.shape[0]
    single_cam = num_cam_blocks == problem.marker_uv.shape[1]
    cam_block = problem.mkr_cam_block
    bnd_index = problem.mkr_bnd_index
    einsum = torch.einsum

    if single_cam:
        # Every marker shares the frame axis' camera blocks: plain
        # reductions over markers.
        b_blocks = einsum("mfra,mfrb->fab", j_cam, j_cam)
        g_cam = einsum("mfra,mfr->fa", j_cam, r)
        hcs = einsum("mfra,mfrs->fas", j_cam, j_sh)
    else:
        # Multi-camera rig: scatter each observation into its camera's
        # (cam*F + f) block.
        b_blocks = _scatter_frames(einsum("mfra,mfrb->mfab", j_cam, j_cam),
                                   cam_block, num_cam_blocks)
        g_cam = _scatter_frames(einsum("mfra,mfr->mfa", j_cam, r),
                                cam_block, num_cam_blocks)
        hcs = _scatter_frames(einsum("mfra,mfrs->mfas", j_cam, j_sh),
                              cam_block, num_cam_blocks)
    hbs_m = einsum("mfra,mfrs->mas", j_bnd, j_sh)  # (M, 3, S)
    return NormalBlocks(
        cost=0.5 * torch.sum(r * r),
        b_blocks=b_blocks,
        g_cam=g_cam,
        a_blocks=_segment_sum(einsum("mfra,mfrb->mab", j_bnd, j_bnd),
                              bnd_index, num_bundles),
        g_bnd=_segment_sum(einsum("mfra,mfr->ma", j_bnd, r), bnd_index,
                           num_bundles),
        # W_{m,f} = Jb^T Jc per observation (3 x 6).
        w_mf=einsum("mfra,mfrb->mfab", j_bnd, j_cam),
        hcs=hcs,
        hbs=_segment_sum(hbs_m, bnd_index, num_bundles),
        hss=einsum("mfrs,mfrt->st", j_sh, j_sh),
        g_sh=einsum("mfrs,mfr->s", j_sh, r),
        hbs_m=hbs_m,
    )


def reduce_arrowhead(blocks: NormalBlocks, mkr_bnd_index, mu):
    """Eliminate bundles from the arrowhead normal equations.

    Returns (s_dense, rhs, a_inv): the (F*6+S, F*6+S) reduced system
    over [camera blocks | border], its right-hand side, and the damped
    per-bundle inverses for back-substitution."""
    einsum = torch.einsum
    num_frames, p_c = blocks.b_blocks.shape[:2]
    num_shared = blocks.hss.shape[0]

    a_inv = tfm_math.inverse3(_damp(blocks.a_blocks, mu))  # (B, 3, 3)
    a_inv_m = a_inv[mkr_bnd_index]  # (M, 3, 3)

    # S_cc = blkdiag(B_f) - sum_m W_{m,f}^T A_m^{-1} W_{m,f'}.
    y_mf = einsum("mab,mfbc->mfac", a_inv_m, blocks.w_mf)
    s = -einsum("mfab,mgac->fbgc", blocks.w_mf, y_mf)
    idx = torch.arange(num_frames, device=s.device)
    s[idx, :, idx, :] += _damp(blocks.b_blocks, mu)
    s_cc = s.reshape(num_frames * p_c, num_frames * p_c)

    # Camera RHS: g_cam - sum_m W^T A^-1 g_bnd.
    g_bnd_pre = einsum("mab,mb->ma", a_inv_m, blocks.g_bnd[mkr_bnd_index])
    rhs_c = blocks.g_cam - einsum("mfab,ma->fb", blocks.w_mf, g_bnd_pre)
    if not num_shared:
        return s_cc, rhs_c.reshape(-1), a_inv

    # Border elimination pieces: Y_b = A_b^-1 Hbs_b.
    y_bs = einsum("bac,bcs->bas", a_inv, blocks.hbs)  # (B, 3, S)
    s_cs = blocks.hcs - einsum("mfab,mas->fbs", blocks.w_mf,
                               y_bs[mkr_bnd_index])  # (F, 6, S)
    s_ss = _damp(blocks.hss, mu) - einsum("bas,bat->st", blocks.hbs, y_bs)
    rhs_s = blocks.g_sh - einsum("bas,ba->s", y_bs, blocks.g_bnd)
    s_cs_flat = s_cs.reshape(num_frames * p_c, num_shared)
    s_dense = torch.cat([
        torch.cat([s_cc, s_cs_flat], dim=1),
        torch.cat([s_cs_flat.T, s_ss], dim=1),
    ], dim=0)
    return s_dense, torch.cat([rhs_c.reshape(-1), rhs_s]), a_inv


def _solve_spd(a, b):
    """Solve the SPD system a x = b (b a vector) by Cholesky, with
    Jacobi (diagonal) equilibration: the same system at unit diagonal,
    so mixed parameter units stay within float32's conditioning.  A
    failed factorization gives NaN, which the LM turns into stop 5."""
    tiny = torch.finfo(a.dtype).tiny
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(a), min=tiny))
    chol, info = torch.linalg.cholesky_ex(a * d[:, None] * d[None, :])
    x = torch.cholesky_solve((b * d)[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.nan) * d


def _cholesky_factor(a):
    """Cholesky factors of a (batch of) SPD matrix and whether each
    factorization succeeded."""
    chol, info = torch.linalg.cholesky_ex(a)
    return chol, info == 0


def _cholesky_apply(factor, v):
    """Solve with _cholesky_factor's factors; NaN where it failed."""
    chol, ok = factor
    x = torch.cholesky_solve(v[..., None], chol)[..., 0]
    return torch.where(ok[..., None], x, torch.nan)


def _step_summary(blocks: NormalBlocks, mu, dx_cam, dx_bnd, dx_sh):
    """(gradient inf-norm, the LM model's predicted cost reduction).

    With (H + mu D) dx = -g, pred = 0.5*(dx^T (mu D) dx - dx^T g)."""
    gnorm = torch.maximum(torch.max(torch.abs(blocks.g_cam)),
                          torch.max(torch.abs(blocks.g_bnd)))
    diag_b = torch.clamp(
        torch.diagonal(blocks.b_blocks, dim1=-2, dim2=-1), min=1e-12)
    diag_a = torch.clamp(
        torch.diagonal(blocks.a_blocks, dim1=-2, dim2=-1), min=1e-12)
    pred = 0.5 * (
        mu * torch.sum(diag_b * dx_cam * dx_cam)
        + mu * torch.sum(diag_a * dx_bnd * dx_bnd)
        - torch.sum(dx_cam * blocks.g_cam)
        - torch.sum(dx_bnd * blocks.g_bnd)
    )
    if blocks.hss.shape[0]:
        gnorm = torch.maximum(gnorm, torch.max(torch.abs(blocks.g_sh)))
        diag_s = torch.clamp(torch.diagonal(blocks.hss), min=1e-12)
        pred = pred + 0.5 * (
            mu * torch.sum(diag_s * dx_sh * dx_sh)
            - torch.sum(dx_sh * blocks.g_sh)
        )
    return gnorm, pred


def _back_substitute(blocks: NormalBlocks, a_inv, w_dx_b, dx_sh):
    """dx_b = -A^-1 (g_b + sum_f W dx_cam_f + Hbs dx_s)."""
    rhs_b = blocks.g_bnd + w_dx_b
    if blocks.hss.shape[0]:
        rhs_b = rhs_b + torch.einsum("bas,s->ba", blocks.hbs, dx_sh)
    return -torch.einsum("bij,bj->bi", a_inv, rhs_b)


def _schur_normal_step(problem: BAProblem, cam_params, bnd_params,
                       shared_params, mu, assembly="ad"):
    """One damped Gauss-Newton step via Schur elimination of bundles
    plus the shared-parameter border, the reduced system factored by
    Cholesky.

    Returns (dx_cam, dx_bnd, dx_shared, cost, gnorm, predicted)."""
    if problem.num_cameras > 1:
        raise ValueError(
            "the dense Cholesky Schur step supports one camera; "
            "multi-camera rigs solve with linear_solver='cg'"
        )
    blocks = assemble_normal_blocks(
        problem, cam_params, bnd_params, shared_params, assembly
    )
    num_frames, p_c = cam_params.shape
    s_dense, rhs, a_inv = reduce_arrowhead(blocks, problem.mkr_bnd_index,
                                           mu)
    dx_all = -_solve_spd(s_dense, rhs)
    dx_cam = dx_all[: num_frames * p_c].reshape(num_frames, p_c)
    dx_sh = dx_all[num_frames * p_c:]
    w_dx_b = _segment_sum(
        torch.einsum("mfab,fb->ma", blocks.w_mf, dx_cam),
        problem.mkr_bnd_index, bnd_params.shape[0],
    )
    dx_bnd = _back_substitute(blocks, a_inv, w_dx_b, dx_sh)
    gnorm, pred = _step_summary(blocks, mu, dx_cam, dx_bnd, dx_sh)
    return dx_cam, dx_bnd, dx_sh, blocks.cost, gnorm, pred


def _schur_cg_step(problem: BAProblem, cam_params, bnd_params,
                   shared_params, mu, cg_iterations, cg_rtol=1e-12,
                   assembly="ad"):
    """One damped Gauss-Newton step via Schur elimination of bundles,
    the reduced [camera | border] system solved by preconditioned
    conjugate gradients.

    The preconditioner is the exact per-frame Schur diagonal block plus
    the border's own reduced block, factored once per call.  CG stops
    once the preconditioned residual rz falls to cg_rtol * rz0: here it
    runs cg_iterations steps and an `active` flag, latched off at the
    tolerance, freezes the state, which gives the early-exit result with
    no read on the host."""
    blocks = assemble_normal_blocks(
        problem, cam_params, bnd_params, shared_params, assembly
    )
    return _schur_cg_solve(problem, blocks, mu, cg_iterations, cg_rtol)


def _schur_cg_solve(problem: BAProblem, blocks: NormalBlocks, mu,
                    cg_iterations, cg_rtol=1e-12):
    """_schur_cg_step from assembled blocks: the bundle elimination, the
    preconditioned CG and the back-substitution."""
    einsum = torch.einsum
    num_cam_blocks, p_c = blocks.g_cam.shape
    num_frames = problem.marker_uv.shape[1]
    single_cam = num_cam_blocks == num_frames
    num_shared = blocks.hss.shape[0]
    num_bundles = blocks.g_bnd.shape[0]
    mkr_bnd_index = problem.mkr_bnd_index
    cam_block = problem.mkr_cam_block
    dtype, device = blocks.g_cam.dtype, blocks.g_cam.device

    b_damped = _damp(blocks.b_blocks, mu)
    a_inv = tfm_math.inverse3(_damp(blocks.a_blocks, mu))
    a_inv_m = a_inv[mkr_bnd_index]
    w_mf = blocks.w_mf
    hcs = blocks.hcs

    def wt_scatter(z_m):
        """sum_m W_mf^T z_m scattered into the camera blocks."""
        if single_cam:
            return einsum("mfab,ma->fb", w_mf, z_m)
        return _scatter_frames(einsum("mfab,ma->mfb", w_mf, z_m),
                               cam_block, num_cam_blocks)

    def w_apply(x_c):
        """sum_f W_mf x_{block(m, f)} per marker."""
        if single_cam:
            return einsum("mfab,fb->ma", w_mf, x_c)
        return einsum("mfab,mfb->ma", w_mf,
                      _gather_cam(x_c, cam_block, num_frames))

    g_bnd_pre = einsum("mab,mb->ma", a_inv_m, blocks.g_bnd[mkr_bnd_index])
    rhs_c = -(blocks.g_cam - wt_scatter(g_bnd_pre))
    if num_shared:
        hss_damped = _damp(blocks.hss, mu)
        y_bs = einsum("bac,bcs->bas", a_inv, blocks.hbs)
        rhs_s = -(blocks.g_sh - einsum("bas,ba->s", y_bs, blocks.g_bnd))
    else:
        rhs_s = torch.zeros((0,), dtype=dtype, device=device)

    def matvec(x_c, x_s):
        v_b = _segment_sum(w_apply(x_c), mkr_bnd_index, num_bundles)
        if num_shared:
            v_b = v_b + einsum("bas,s->ba", blocks.hbs, x_s)
        z_b = einsum("bac,bc->ba", a_inv, v_b)
        out_c = einsum("fab,fb->fa", b_damped, x_c)
        out_c = out_c - wt_scatter(z_b[mkr_bnd_index])
        if not num_shared:
            return out_c, x_s
        out_c = out_c + einsum("fas,s->fa", hcs, x_s)
        out_s = einsum("fas,fa->s", hcs, x_c)
        out_s = out_s + hss_damped @ x_s
        out_s = out_s - einsum("bas,ba->s", blocks.hbs, z_b)
        return out_c, out_s

    # Exact per-frame Schur diagonal preconditioner (+ border block),
    # factored once.
    if single_cam:
        s_corr = einsum("mfab,mac,mfcd->fbd", w_mf, a_inv_m, w_mf)
    else:
        s_corr = _scatter_frames(
            einsum("mfab,mac,mfcd->mfbd", w_mf, a_inv_m, w_mf),
            cam_block, num_cam_blocks,
        )
    s_diag = b_damped - s_corr
    eye_c = torch.eye(p_c, dtype=dtype, device=device)
    s_diag = s_diag + 1e-8 * torch.clamp(
        torch.diagonal(s_diag, dim1=-2, dim2=-1), min=1e-12
    )[..., None] * eye_c
    factor_c = _cholesky_factor(s_diag)
    if num_shared:
        s_ss = hss_damped - einsum("bas,bat->st", blocks.hbs, y_bs)
        s_ss = s_ss + 1e-8 * torch.clamp(
            torch.diagonal(s_ss), min=1e-12
        ) * torch.eye(num_shared, dtype=dtype, device=device)
        factor_s = _cholesky_factor(s_ss)

    def precond(v_c, v_s):
        p_ss = _cholesky_apply(factor_s, v_s) if num_shared else v_s
        return _cholesky_apply(factor_c, v_c), p_ss

    def pdot(a_c, a_s, b_c, b_s):
        return torch.sum(a_c * b_c) + torch.sum(a_s * b_s)

    where = torch.where
    x_c, x_s = torch.zeros_like(rhs_c), torch.zeros_like(rhs_s)
    r_c, r_s = rhs_c, rhs_s
    z_c, z_s = precond(rhs_c, rhs_s)
    p_cv, p_sv = z_c, z_s
    rz = pdot(rhs_c, rhs_s, z_c, z_s)
    # Stop once the preconditioned residual has dropped by cg_rtol
    # (more than enough for an inexact-Newton LM step).
    rz_tol = cg_rtol * torch.clamp(rz, min=1e-300)
    active = torch.ones((), dtype=torch.bool, device=device)
    for _ in range(int(cg_iterations)):
        active = active & (rz > rz_tol)
        ap_c, ap_s = matvec(p_cv, p_sv)
        pap = pdot(p_cv, p_sv, ap_c, ap_s)
        ok = (pap > 0.0) & (rz > 0.0)
        alpha = where(ok, rz / where(ok, pap, 1.0), 0.0)
        x_c_new = x_c + alpha * p_cv
        x_s_new = x_s + alpha * p_sv
        r_c_new = where(ok, r_c - alpha * ap_c, r_c)
        r_s_new = where(ok, r_s - alpha * ap_s, r_s)
        z_c_new, z_s_new = precond(r_c_new, r_s_new)
        rz_new = pdot(r_c_new, r_s_new, z_c_new, z_s_new)
        beta = where(ok, rz_new / where(ok, rz, 1.0), 0.0)
        p_c_new = where(ok, z_c_new + beta * p_cv, p_cv)
        p_s_new = where(ok, z_s_new + beta * p_sv, p_sv)
        rz_new = where(ok, rz_new, torch.zeros_like(rz_new))
        x_c, x_s = where(active, x_c_new, x_c), where(active, x_s_new, x_s)
        r_c, r_s = where(active, r_c_new, r_c), where(active, r_s_new, r_s)
        p_cv = where(active, p_c_new, p_cv)
        p_sv = where(active, p_s_new, p_sv)
        rz = where(active, rz_new, rz)
    dx_cam, dx_sh = x_c, x_s

    w_dx_b = _segment_sum(w_apply(dx_cam), mkr_bnd_index, num_bundles)
    dx_bnd = _back_substitute(blocks, a_inv, w_dx_b, dx_sh)
    gnorm, pred = _step_summary(blocks, mu, dx_cam, dx_bnd, dx_sh)
    return dx_cam, dx_bnd, dx_sh, blocks.cost, gnorm, pred


@dataclasses.dataclass(frozen=True)
class BAState:
    """The resumable-solve state passed between ba_init / ba_run_block
    (the BA counterpart of lm.py's LMState)."""

    cam: torch.Tensor
    bnd: torch.Tensor
    sh: torch.Tensor
    cost: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    stop: torch.Tensor
    gnorm: torch.Tensor
    nfev: torch.Tensor
    njev: torch.Tensor


def _check_linear_solver(problem, linear_solver):
    if linear_solver not in ("cholesky", "cg"):
        raise ValueError("linear_solver must be 'cholesky' or 'cg'")
    if problem.num_cameras > 1 and linear_solver != "cg":
        raise ValueError("multi-camera BAProblem requires linear_solver='cg'")


def solve_ba(
    problem: BAProblem,
    max_iterations=20,
    tau=1e-3,
    eps1=1e-8,
    eps2=1e-8,
    eps3=1e-8,
    linear_solver="cholesky",
    cg_iterations=30,
    assembly="ad",
) -> BAResult:
    """LM over the arrowhead-structured normal equations.

    Stopping mirrors solver/lm.py: eps1 = gradient inf-norm (gtol), eps2
    = relative step size (xtol), eps3 = relative cost reduction on an
    accepted step (ftol).  linear_solver: 'cholesky' factors the reduced
    [camera | border] system exactly; 'cg' solves it with
    block-preconditioned conjugate gradients (the choice for long shots
    and multi-camera rigs).  assembly: 'ad' or 'analytic' (ASSEMBLIES).
    """
    init = ba_init(problem, tau)
    final = ba_run_block(
        problem, init, max_iterations, max_iterations=max_iterations,
        eps1=eps1, eps2=eps2, eps3=eps3, linear_solver=linear_solver,
        cg_iterations=cg_iterations, assembly=assembly,
    )
    return ba_finalize(final, init.cost)


def ba_init(problem: BAProblem, tau=1e-3) -> BAState:
    """Initial BA state (cost at the starting parameters)."""
    cost0 = ba_cost(problem, problem.cam_params, problem.bnd_params,
                    problem.shared_params)
    dtype, device = problem.cam_params.dtype, problem.cam_params.device

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=device)

    return BAState(
        cam=problem.cam_params,
        bnd=problem.bnd_params,
        sh=problem.shared_params,
        cost=cost0,
        mu=scalar(tau),
        nu=scalar(2.0),
        it=scalar(0, torch.int32),
        stop=scalar(0, torch.int32),
        gnorm=scalar(float("inf")),
        nfev=scalar(1, torch.int32),
        njev=scalar(0, torch.int32),
    )


def ba_run_block(problem, state, limit, max_iterations=20,
                 eps1=1e-8, eps2=1e-8, eps3=1e-8,
                 linear_solver="cholesky", cg_iterations=30,
                 assembly="ad"):
    """Run LM iterations until convergence or `limit` total iterations.
    Resumable: feed the returned state back with a larger limit.  Reads
    the stop flag and the iteration count on the host once per
    iteration, in one transfer."""
    _check_linear_solver(problem, linear_solver)
    limit = min(int(limit), max_iterations)
    body = _make_ba_body(problem, eps1, eps2, eps3, linear_solver,
                         cg_iterations, assembly)
    while True:
        stop, it = torch.stack([state.stop, state.it]).tolist()
        if stop != 0 or it >= limit:
            return state
        state = body(state)


def ba_finalize(state: BAState, cost_initial) -> BAResult:
    """Wrap a (possibly interrupted) state as a BAResult."""
    return BAResult(
        cam_params=state.cam,
        bnd_params=state.bnd,
        shared_params=state.sh,
        cost=state.cost,
        cost_initial=cost_initial,
        iterations=state.it,
        stop_reason=torch.where(state.stop == 0, 4, state.stop),
        gradient_norm=state.gnorm,
        func_evals=state.nfev,
        jacobian_evals=state.njev,
    )


def _make_ba_body(problem, eps1, eps2, eps3, linear_solver, cg_iterations,
                  assembly="ad"):
    """One gain-ratio LM iteration, shared by solve_ba and ba_run_block."""
    where = torch.where

    def body(s: BAState):
        if linear_solver == "cg":
            dx_cam, dx_bnd, dx_sh, cost, gnorm, pred = _schur_cg_step(
                problem, s.cam, s.bnd, s.sh, s.mu, cg_iterations,
                assembly=assembly,
            )
        else:
            dx_cam, dx_bnd, dx_sh, cost, gnorm, pred = _schur_normal_step(
                problem, s.cam, s.bnd, s.sh, s.mu, assembly=assembly,
            )
        ok = (torch.all(torch.isfinite(dx_cam))
              & torch.all(torch.isfinite(dx_bnd))
              & torch.all(torch.isfinite(dx_sh)))
        dx_cam = where(ok, dx_cam, 0.0)
        dx_bnd = where(ok, dx_bnd, 0.0)
        dx_sh = where(ok, dx_sh, 0.0)

        cam_new = s.cam + dx_cam
        bnd_new = s.bnd + dx_bnd
        sh_new = s.sh + dx_sh
        cost_new = ba_cost(problem, cam_new, bnd_new, sh_new)

        # True gain ratio + Nielsen's update (as in lm.py).
        pred = torch.clamp(pred, min=1e-300)
        rho = (cost - cost_new) / pred
        accept = ok & (rho > 0.0) & torch.isfinite(cost_new)

        mu_accept = s.mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                       min=1.0 / 3.0)
        mu_new = where(accept, mu_accept, s.mu * s.nu)
        nu_new = where(accept, 2.0, s.nu * 2.0)

        step_norm = torch.sqrt(torch.sum(dx_cam * dx_cam)
                               + torch.sum(dx_bnd * dx_bnd)
                               + torch.sum(dx_sh * dx_sh))
        x_norm = torch.sqrt(torch.sum(s.cam * s.cam)
                            + torch.sum(s.bnd * s.bnd)
                            + torch.sum(s.sh * s.sh))
        ftol_hit = accept & (
            (cost - cost_new) <= eps3 * torch.clamp(cost, min=1e-300))
        xtol_hit = step_norm <= eps2 * (x_norm + eps2)
        gtol_hit = gnorm <= eps1
        failed = (~ok) | (~torch.isfinite(mu_new))
        stop = where(
            failed, 5,
            where(gtol_hit, 3, where(xtol_hit, 2, where(ftol_hit, 1, 0))),
        ).to(torch.int32)
        return BAState(
            cam=where(accept, cam_new, s.cam),
            bnd=where(accept, bnd_new, s.bnd),
            sh=where(accept, sh_new, s.sh),
            cost=where(accept, cost_new, cost),
            mu=mu_new,
            nu=nu_new,
            it=s.it + 1,
            stop=stop,
            gnorm=gnorm,
            # One block assembly and one trial cost per iteration.
            nfev=s.nfev + 1,
            njev=s.njev + 1,
        )

    return body


def make_ba_problem(
    marker_uv,
    weight,
    mkr_bnd_index,
    cam_params,
    bnd_params,
    mkr_cam_index=None,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    film_offset_x_mm=0.0,
    film_offset_y_mm=0.0,
    far_clip_cm=10000.0,
    camera_scale=1.0,
    render_width=1920,
    render_height=1080,
    film_fit=1,
    rotate_order=0,
    image_width: Optional[float] = None,
    solve_focal=False,
    lens_model_type="",
    lens_params=None,
    lens_solve_names: Optional[Sequence[str]] = None,
    lens_pixel_aspect=1.0,
    loss_type=0,
    loss_scale=1.0,
    intrinsics=None,
    *,
    device,
) -> BAProblem:
    """Assemble a BAProblem on `device` from numpy arrays or tensors;
    the dtype is marker_uv's.

    Shared (border) parameters are initialized from the intrinsics'
    focal lengths and lens_params:
      * solve_focal=True puts one focal length per camera into the
        border (the reference's static focal attribute semantics);
      * lens_solve_names lists lens parameter fields to solve (any
        subset of the model's fields); the rest stay fixed.
    intrinsics may override the derived (C*F, 8) per-frame tensor.
    """
    marker_uv = torch.as_tensor(marker_uv, device=device)
    num_markers, num_frames = marker_uv.shape[:2]
    dtype = marker_uv.dtype

    def floats(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def ints(x):
        return torch.as_tensor(x, device=device).to(torch.int64)

    cam_params = floats(cam_params)
    num_cameras = cam_params.shape[0] // num_frames
    if cam_params.shape[0] % num_frames != 0:
        raise ValueError(
            "cam_params rows (%d) must be num_cameras * num_frames "
            "(F=%d)" % (cam_params.shape[0], num_frames)
        )
    if mkr_cam_index is None:
        mkr_cam_block = torch.zeros(num_markers, dtype=torch.int64,
                                    device=device)
    else:
        mkr_cam_block = ints(mkr_cam_index) * num_frames
    if intrinsics is None:
        intr_row = floats([
            focal_length_mm,
            film_back_width_mm,
            film_back_height_mm,
            film_offset_x_mm,
            film_offset_y_mm,
            far_clip_cm,
            camera_scale,
            float(render_width) / float(render_height),
        ])
        intrinsics = intr_row.expand(num_cameras * num_frames, 8).clone()
    else:
        intrinsics = floats(intrinsics)
        if intrinsics.shape[0] != num_cameras * num_frames:
            raise ValueError("intrinsics rows must match cam_params rows")

    if lens_model_type:
        fields = [n for n, _ in scenelens._MODEL_FIELDS[lens_model_type]]
        defaults = scenelens._MODEL_DEFAULTS[lens_model_type]
        if lens_params is None:
            lens_values = [float(getattr(defaults, n)) for n in fields]
        elif isinstance(lens_params, dict):
            lens_values = [
                float(lens_params.get(n, float(getattr(defaults, n))))
                for n in fields
            ]
        else:
            lens_values = [float(v) for v in lens_params]
            if len(lens_values) != len(fields):
                raise ValueError(
                    "lens_params needs %d values for %s"
                    % (len(fields), lens_model_type)
                )
        solve_names = set(lens_solve_names or ())
        unknown = solve_names - set(fields)
        if unknown:
            raise ValueError(
                "unknown lens fields for %s: %r"
                % (lens_model_type, sorted(unknown))
            )
        lens_solve_mask = tuple(n in solve_names for n in fields)
    else:
        lens_values = []
        lens_solve_mask = ()
        if lens_solve_names:
            raise ValueError("lens_solve_names without lens_model_type")

    # Border: one focal per camera (each camera's first intrinsics row),
    # then the solved lens values.
    shared = [floats([v for v, s in zip(lens_values, lens_solve_mask)
                      if s])]
    if solve_focal:
        shared.insert(0, intrinsics[::num_frames, 0])

    return BAProblem(
        marker_uv=marker_uv,
        weight=torch.sqrt(torch.clamp(floats(weight), min=0.0)),
        mkr_bnd_index=ints(mkr_bnd_index),
        mkr_cam_block=mkr_cam_block,
        cam_params=cam_params,
        bnd_params=floats(bnd_params),
        shared_params=torch.cat(shared),
        intrinsics=intrinsics,
        lens_params=floats(lens_values),
        lens_pixel_aspect=floats(lens_pixel_aspect),
        film_fit=int(film_fit),
        rotate_order=int(rotate_order),
        image_width=float(image_width or render_width),
        solve_focal=bool(solve_focal),
        lens_model_type=str(lens_model_type),
        lens_solve_mask=lens_solve_mask,
        loss_type=int(loss_type),
        loss_scale=float(loss_scale),
    )
