"""SolveProblem -> BAProblem bridge: route solve() requests with the
bundle-adjustment shape onto the structured Schur BA.

Port of mayamatchmovesolver_tpu/solver/ba_bridge.py (ref: the
solver-type registry and solveFrames dispatch,
src/mmSolver/adjust/adjust_base.cpp:80-127,713).  A request with the BA
shape (animated 6-DoF camera poses, static bundle positions, optionally
the static focal length and static lens coefficients) becomes a
solver/ba.py BAProblem on the attributes' device; any other request
falls back to the dense LM, with the reason reported.

The conversion is exact: the BA residual has the dense path's physics
(film-fit projection, lens distortion of the reprojected point,
behind-camera inflation, robust loss, sqrt-weights), so the two backends
agree to round-off.

The request is classified on the host from the scene's index tables,
fetched in one transfer per dtype; the problem's tensors are gathered on
the device and never leave it.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mayamatchmovesolver_torch.models import scenelens
from mayamatchmovesolver_torch.scene.attrblock import (
    AttrBlock,
    gather_attr_values,
)
from mayamatchmovesolver_torch.scene.flatscene import evaluate
from mayamatchmovesolver_torch.solver import ba as ba_mod


@dataclasses.dataclass
class BABridge:
    """A BAProblem plus the scatter map back into the AttrBlock; the
    index tensors live on the problem's device."""

    problem: ba_mod.BAProblem
    frame_indices: torch.Tensor  # (F,)
    pose_rows: torch.Tensor  # (C, 6) anim rows of the camera channels
    bnd_rows: torch.Tensor  # (B, 3) static rows of the bundle channels
    # Static rows of the border in border order: one focal per camera
    # (when focal is solved), then the solved lens parameters.
    border_rows: torch.Tensor  # (S,)

    def apply_result(self, attrs: AttrBlock,
                     result: ba_mod.BAResult) -> AttrBlock:
        """Scatter the BA solution into a fresh AttrBlock, on the device
        (the BA path's setParameters counterpart,
        ref: adjust_setParameters.cpp:174-250)."""
        anim = attrs.anim_values.clone()
        static = attrs.static_values.clone()
        num_cameras = self.pose_rows.shape[0]
        num_frames = self.frame_indices.shape[0]
        cam = result.cam_params.reshape(num_cameras, num_frames, -1)
        anim[self.pose_rows[:, :, None],
             self.frame_indices[None, None, :]] = cam.transpose(1, 2)
        static[self.bnd_rows] = result.bnd_params
        static[self.border_rows] = result.shared_params
        return AttrBlock(static_values=static, anim_values=anim)


def _attr_has_bounds(attr):
    return (
        np.isfinite(attr.min_value)
        or np.isfinite(attr.max_value)
        or attr.offset_value != 0.0
        or attr.scale_value != 1.0
    )


def _to_host(tensors):
    """numpy copies of `tensors`, with one device-to-host transfer per
    dtype."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]).cpu().numpy()
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].reshape(tuple(tensors[i].shape))
            start += n
    return out


def build_ba_bridge(
    scene,
    attrs: AttrBlock,
    frame_indices,
    solve_attrs,
    options,
    marker_frame_mask=None,
    stiffness=None,
    lens=None,
    lines=None,
) -> Tuple[Optional[BABridge], str]:
    """Classify a solve request; return (BABridge, "") when it has the
    BA shape, else (None, reason).

    The accepted shape (the reference's standard matchmove solve):
      * root-transform cameras with unit scale: one camera, or a
        multi-camera rig with uniform film fit / rotate order / render
        size (camera blocks lay out camera-major; multi-camera solves run
        the CG linear solver);
      * solve attrs = every camera's six animated pose channels, every
        bundle's three static translate channels, optionally the static
        focal length (of every camera) and, for one camera, static lens
        coefficients (one layer);
      * no box constraints / offsets (BA has no reparameterization);
      * no stiffness/smoothness or line constraints.
    """
    if stiffness is not None and len(stiffness.get("codes", ())):
        return None, "stiffness/smoothness constraints"
    if lines is not None and (
        np.asarray(lines.get("mkr_index", ())).size
    ):
        return None, "line constraints"
    num_cameras = int(scene.num_cameras)
    device = attrs.static_values.device
    frame_indices = np.asarray(frame_indices, dtype=np.int64)
    num_frames = len(frame_indices)
    fi = torch.as_tensor(frame_indices, device=device)

    # Camera scale, evaluated on the device; ATTR_NONE scales are 1.
    scale_codes = scene.tfm_attr_codes[scene.cam_tfm_index, 6:9]  # (C, 3)
    cam_scale_values = torch.where(
        (scale_codes < 0)[..., None], 1.0,
        gather_attr_values(attrs, scale_codes, fi))
    has_lens = lens is not None and lens.has_any()
    (cam_tfms, tfm_parent, bnd_tfms, film_fits, rot_orders_all,
     tfm_codes, cam_attr_code_table, render_sizes, static,
     cam_scale_values, lens_codes_all) = _to_host([
        scene.cam_tfm_index, scene.tfm_parent, scene.bnd_tfm_index,
        scene.cam_film_fit, scene.tfm_rotate_order, scene.tfm_attr_codes,
        scene.cam_attr_codes, scene.cam_render_size, attrs.static_values,
        cam_scale_values,
        lens.param_codes if has_lens else scene.cam_tfm_index[:0],
    ])
    if np.any(tfm_parent[cam_tfms] != -1):
        return None, "camera is not a root transform"
    if np.any(tfm_parent[bnd_tfms] != -1):
        return None, "parented bundles"
    rot_orders = rot_orders_all[cam_tfms]
    if num_cameras > 1:
        # Camera blocks are laid out camera-major; film fit and rotate
        # order are configuration fields of the one problem.
        if not (np.all(film_fits == film_fits[0])
                and np.all(rot_orders == rot_orders[0])):
            return None, "cameras differ in film fit / rotate order"
        if not np.allclose(render_sizes, render_sizes[0]):
            return None, "cameras differ in render size"

    pose_code_table = tfm_codes[cam_tfms][:, :6]  # (C, 6)
    focal_codes = cam_attr_code_table[:, 2]
    bnd_code_table = tfm_codes[bnd_tfms][:, :3]  # (B, 3)

    # The BA residual models cameras as pure rigid transforms.
    if not np.allclose(cam_scale_values, 1.0):
        return None, "camera has non-unit scale"

    # Lens layout (single camera, single layer).
    lens_model_type = ""
    lens_param_codes = None
    lens_pa_code = None
    if has_lens:
        if num_cameras > 1:
            return None, "lens distortion on a multi-camera rig"
        stacks = lens.model_types
        if len(stacks) != 1 or len(stacks[0]) != 1:
            return None, "multi-layer or multi-camera lens stack"
        lens_model_type = stacks[0][0]
        n_lp = len(scenelens._MODEL_FIELDS[lens_model_type])
        codes_row = lens_codes_all[0, 0]
        lens_param_codes = codes_row[:n_lp]
        lens_pa_code = int(codes_row[scenelens.MAX_LENS_PARAMS - 1])
        if np.any(lens_param_codes % 2 == 1):
            return None, "animated lens parameters"
        if lens_pa_code >= 0 and lens_pa_code % 2 == 1:
            return None, "animated lens pixel aspect"

    # Classify every solve attribute.
    pose_solved = {}  # (cam_index, channel) -> code
    bnd_solved = {}  # bnd_index -> set(channel)
    solve_focal = False
    focal_solved_cams = set()
    lens_solved_positions = []  # positions into the lens field order
    for attr in solve_attrs:
        if _attr_has_bounds(attr):
            return None, "box constraints on %r" % attr.name
        code = int(attr.code)
        pose_pos = np.nonzero(pose_code_table == code)
        if pose_pos[0].size:
            if code % 2 != 1:
                return None, "static camera pose attr %s" % attr.name
            pose_solved[(int(pose_pos[0][0]), int(pose_pos[1][0]))] = code
            continue
        focal_pos = np.nonzero(focal_codes == code)[0]
        if focal_pos.size:
            if code % 2 != 0:
                return None, "animated focal length"
            solve_focal = True
            focal_solved_cams.add(int(focal_pos[0]))
            continue
        bnd_pos = np.nonzero(bnd_code_table == code)
        if bnd_pos[0].size:
            if code % 2 != 0:
                return None, "animated bundle attr"
            bnd_solved.setdefault(int(bnd_pos[0][0]), set()).add(
                int(bnd_pos[1][0]))
            continue
        if lens_param_codes is not None:
            lp = np.nonzero(lens_param_codes == code)[0]
            if lp.size:
                lens_solved_positions.append(int(lp[0]))
                continue
        return None, "attribute %s.%s outside the BA shape" % (
            getattr(attr.node, "name", "?"), attr.name
        )

    if solve_focal and len(focal_solved_cams) != num_cameras:
        # The border solves one focal per camera; a partial set would
        # silently free unsolved cameras' focals too.
        return None, "focal solved on %d of %d cameras" % (
            len(focal_solved_cams), num_cameras
        )
    if len(pose_solved) != 6 * num_cameras:
        return None, "camera pose not fully solved (%d/%d channels)" % (
            len(pose_solved), 6 * num_cameras
        )
    num_bundles = bnd_code_table.shape[0]
    if len(bnd_solved) != num_bundles or any(
        len(chs) != 3 for chs in bnd_solved.values()
    ):
        return None, "bundles not fully solved (%d/%d with tx/ty/tz)" % (
            sum(1 for chs in bnd_solved.values() if len(chs) == 3),
            num_bundles,
        )

    # ---- The BAProblem tensors, gathered on the device. -----------------
    ev = evaluate(scene, attrs, fi)
    weight = ev.marker_weight * (ev.marker_enable > 0.5)
    if marker_frame_mask is not None:
        weight = weight * torch.as_tensor(
            np.asarray(marker_frame_mask, dtype=bool), device=device)

    def rows(codes):
        return torch.as_tensor(np.asarray(codes) // 2, device=device)

    pose_rows = rows(pose_code_table)
    # Camera-major pose + intrinsics blocks: (C*F, 6) / (C*F, 8).
    cam_params = attrs.anim_values[pose_rows][..., fi].transpose(1, 2)
    cv = gather_attr_values(attrs, scene.cam_attr_codes, fi)  # (C, 8, F)
    cam_scale = torch.where((scene.cam_attr_codes[:, 7] < 0)[:, None],
                            1.0, cv[:, 7])
    render_w, render_h = render_sizes[0]
    intrinsics = torch.stack([
        cv[:, 2],  # focal_length_mm
        cv[:, 0],  # sensor_width_mm
        cv[:, 1],  # sensor_height_mm
        cv[:, 3],  # lens_offset_x_mm
        cv[:, 4],  # lens_offset_y_mm
        cv[:, 6],  # far_clip_cm
        cam_scale,
        torch.full_like(cam_scale, float(render_w) / float(render_h)),
    ], dim=-1)
    bnd_rows = rows(bnd_code_table)

    lens_values = None
    lens_solve_names = None
    lens_pixel_aspect = 1.0
    lens_codes_border = []
    if lens_model_type:
        fields = [n for n, _ in scenelens._MODEL_FIELDS[lens_model_type]]
        defaults = scenelens._MODEL_DEFAULTS[lens_model_type]
        lens_values = [
            float(static[c // 2]) if c >= 0
            else float(getattr(defaults, fields[i]))
            for i, c in enumerate(lens_param_codes)
        ]
        if lens_pa_code is not None and lens_pa_code >= 0:
            lens_pixel_aspect = float(static[lens_pa_code // 2])
        solved = sorted(set(lens_solved_positions))
        lens_solve_names = [fields[p] for p in solved]
        lens_codes_border = [int(lens_param_codes[p]) for p in solved]

    problem = ba_mod.make_ba_problem(
        marker_uv=ev.marker_xy,
        weight=weight.to(attrs.static_values.dtype),
        mkr_bnd_index=scene.mkr_bnd_index,
        cam_params=cam_params.reshape(num_cameras * num_frames, 6),
        bnd_params=attrs.static_values[bnd_rows],
        mkr_cam_index=scene.mkr_cam_index,
        film_fit=int(film_fits[0]),
        rotate_order=int(rot_orders[0]),
        render_width=float(render_w),
        render_height=float(render_h),
        image_width=float(options.image_width),
        solve_focal=solve_focal,
        lens_model_type=lens_model_type,
        lens_params=lens_values,
        lens_solve_names=lens_solve_names,
        lens_pixel_aspect=lens_pixel_aspect,
        loss_type=int(options.robust_loss_type),
        loss_scale=float(options.robust_loss_scale),
        intrinsics=intrinsics.reshape(num_cameras * num_frames, 8),
        device=device,
    )
    border_codes = (list(focal_codes) if solve_focal else [])
    border_codes += lens_codes_border
    bridge = BABridge(
        problem=problem,
        frame_indices=fi,
        pose_rows=pose_rows,
        bnd_rows=bnd_rows,
        border_rows=rows(np.asarray(border_codes, dtype=np.int64)),
    )
    return bridge, ""
