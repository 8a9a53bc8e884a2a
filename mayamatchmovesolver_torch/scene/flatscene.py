"""Flattened scene representation and its batched evaluator.

Port of mayamatchmovesolver_tpu/scene/flatscene.py
(ref: lib/rust/mmscenegraph/src/scene/flat.rs:41-358): the editable DAG
is baked (scenegraph.py) into flat index tensors, and evaluate() produces
world matrices and reprojected marker/point pairs for every (node,
frame) at once.  World matrices are composed by pointer doubling over
the parent array: log2(depth) batched 4x4 matmul sweeps.
"""

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from mayamatchmovesolver_torch.core import camera as cam_math
from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.core.constants import MM_TO_INCH
from mayamatchmovesolver_torch.scene.attrblock import (
    AttrBlock,
    gather_attr_values,
)

# The reference hard-codes the near clip plane during scene-graph
# evaluation (ref: lib/rust/mmscenegraph/src/math/dag.rs:150-154).
NEAR_CLIP_PLANE_CM = 0.1

# Column layout of tfm_attr_codes.
TFM_ATTRS = ("tx", "ty", "tz", "rx", "ry", "rz", "sx", "sy", "sz")
# Column layout of cam_attr_codes.
CAM_ATTRS = (
    "sensor_width_mm",
    "sensor_height_mm",
    "focal_length_mm",
    "lens_offset_x_mm",
    "lens_offset_y_mm",
    "near_clip_cm",
    "far_clip_cm",
    "camera_scale",
)
# Column layout of mkr_attr_codes.  overscan_x/y come from the marker's
# MarkerGroup (shared attr codes; ATTR_NONE evaluates as 1.0).
MKR_ATTRS = ("tx", "ty", "weight", "enable", "overscan_x", "overscan_y")


@dataclasses.dataclass(frozen=True)
class FlatScene:
    """Baked, static-shape scene structure.

    Index tensors are int64; cam_render_size has the attribute dtype.
    """

    # Transforms, topologically sorted (parent index < child index).
    tfm_attr_codes: torch.Tensor  # (T, 9)
    tfm_rotate_order: torch.Tensor  # (T,)
    tfm_parent: torch.Tensor  # (T,), -1 for roots

    # Cameras.
    cam_tfm_index: torch.Tensor  # (C,)
    cam_attr_codes: torch.Tensor  # (C, 8)
    cam_film_fit: torch.Tensor  # (C,)
    cam_render_size: torch.Tensor  # (C, 2) float (width, height) pixels

    # Bundles.
    bnd_tfm_index: torch.Tensor  # (B,)

    # Markers.
    mkr_cam_index: torch.Tensor  # (M,)
    mkr_bnd_index: torch.Tensor  # (M,)
    mkr_attr_codes: torch.Tensor  # (M, 6)

    doubling_steps: int

    @property
    def num_transforms(self):
        return self.tfm_attr_codes.shape[0]

    @property
    def num_cameras(self):
        return self.cam_tfm_index.shape[0]

    @property
    def num_bundles(self):
        return self.bnd_tfm_index.shape[0]

    @property
    def num_markers(self):
        return self.mkr_cam_index.shape[0]


class SceneEval(NamedTuple):
    """Everything evaluate() produces, shaped (N, F, ...)."""

    tfm_world: torch.Tensor  # (T, F, 4, 4)
    cam_world: torch.Tensor  # (C, F, 4, 4)
    cam_world_inv: torch.Tensor  # (C, F, 4, 4)
    cam_proj: torch.Tensor  # (C, F, 4, 4)
    bnd_world_point: torch.Tensor  # (B, F, 3)
    point_xy: torch.Tensor  # (M, F, 2) reprojected bundle, marker space
    marker_xy: torch.Tensor  # (M, F, 2) film-fit-scaled marker position
    marker_weight: torch.Tensor  # (M, F)
    marker_enable: torch.Tensor  # (M, F)
    behind_camera: torch.Tensor  # (M, F) bool


def doubling_steps_for_depth(max_depth):
    """Pointer-doubling sweeps needed for a hierarchy of given depth
    (number of edges on the longest root-to-leaf path)."""
    if max_depth <= 0:
        return 0
    return max(1, int(math.ceil(math.log2(max_depth + 1))))


def compute_world_matrices(scene: FlatScene, local_matrices):
    """Compose local matrices up parent chains via pointer doubling.

    local_matrices: (T, F, 4, 4).  Returns world matrices, same shape.
    """
    world = local_matrices
    parent = scene.tfm_parent
    for _ in range(scene.doubling_steps):
        has_parent = parent >= 0
        pidx = torch.clamp(parent, min=0)
        composed = torch.matmul(world[pidx], world)
        world = torch.where(has_parent[:, None, None, None], composed, world)
        parent = torch.where(has_parent, parent[pidx], -1)
    return world


def _default_one(codes, values):
    """Attribute values where set, 1.0 where the code is ATTR_NONE."""
    return torch.where((codes < 0)[:, None], 1.0, values)


def evaluate(scene: FlatScene, attrs: AttrBlock, frame_indices) -> SceneEval:
    """Evaluate the whole scene for all frames at once.

    frame_indices: (F,) int tensor into the baked frame axis.
    """
    # ---- Transform local + world matrices. -------------------------------
    tv = gather_attr_values(attrs, scene.tfm_attr_codes, frame_indices)
    codes = scene.tfm_attr_codes
    local = tfm_math.trs_matrix(
        tv[:, 0], tv[:, 1], tv[:, 2], tv[:, 3], tv[:, 4], tv[:, 5],
        # Scale attrs default to 1.0 when absent (ATTR_NONE gathers to 0).
        _default_one(codes[:, 6], tv[:, 6]),
        _default_one(codes[:, 7], tv[:, 7]),
        _default_one(codes[:, 8], tv[:, 8]),
        scene.tfm_rotate_order[:, None],
    )  # (T, F, 4, 4)
    tfm_world = compute_world_matrices(scene, local)

    # ---- Cameras. --------------------------------------------------------
    cam_world = tfm_world[scene.cam_tfm_index]  # (C, F, 4, 4)
    cam_world_inv = tfm_math.affine_inverse(cam_world)

    cv = gather_attr_values(attrs, scene.cam_attr_codes, frame_indices)
    cvals = {name: cv[:, i, :] for i, name in enumerate(CAM_ATTRS)}
    camera_scale = _default_one(
        scene.cam_attr_codes[:, 7], cvals["camera_scale"]
    )
    render_w = scene.cam_render_size[:, 0:1]
    render_h = scene.cam_render_size[:, 1:2]
    cam_proj = cam_math.projection_matrix(
        cvals["focal_length_mm"],
        cvals["sensor_width_mm"] * MM_TO_INCH,
        cvals["sensor_height_mm"] * MM_TO_INCH,
        cvals["lens_offset_x_mm"] * MM_TO_INCH,
        cvals["lens_offset_y_mm"] * MM_TO_INCH,
        render_w,
        render_h,
        scene.cam_film_fit[:, None],
        NEAR_CLIP_PLANE_CM,
        cvals["far_clip_cm"],
        camera_scale,
    )  # (C, F, 4, 4)

    # ---- Bundles. --------------------------------------------------------
    bnd_world_point = tfm_world[scene.bnd_tfm_index][..., :3, 3]  # (B, F, 3)

    # ---- Markers: reproject + film-fit-scaled marker positions. ----------
    view_proj = torch.matmul(cam_proj, cam_world_inv)
    mkr_vp = view_proj[scene.mkr_cam_index]  # (M, F, 4, 4)
    mkr_bnd_pos = bnd_world_point[scene.mkr_bnd_index]  # (M, F, 3)
    p_h = torch.cat([mkr_bnd_pos, torch.ones_like(mkr_bnd_pos[..., :1])], -1)
    clip = torch.matmul(mkr_vp, p_h[..., None])[..., 0]
    point_xy = clip[..., :2] / clip[..., 3:4] * 0.5

    # Behind-camera detection: dot(camera forward, camera->bundle) < 0
    # (ref: src/mmSolver/adjust/adjust_measureErrors.cpp:262-270).  The
    # camera looks down its local -Z axis.
    mkr_cam_world = cam_world[scene.mkr_cam_index]  # (M, F, 4, 4)
    cam_forward = -mkr_cam_world[..., :3, 2]
    to_bnd = mkr_bnd_pos - mkr_cam_world[..., :3, 3]
    behind_camera = torch.sum(cam_forward * to_bnd, dim=-1) < 0.0

    # Marker attr values; MarkerGroup overscan scales the raw position.
    mv = gather_attr_values(attrs, scene.mkr_attr_codes, frame_indices)
    mcodes = scene.mkr_attr_codes
    marker_weight = _default_one(mcodes[:, 2], mv[:, 2, :])
    marker_enable = _default_one(mcodes[:, 3], mv[:, 3, :])
    mkr_tx = mv[:, 0, :] * _default_one(mcodes[:, 4], mv[:, 4, :])
    mkr_ty = mv[:, 1, :] * _default_one(mcodes[:, 5], mv[:, 5, :])

    # Film-fit scaling of the marker position so marker and reprojected
    # point live in the same space (ref: scene/flat.rs:73-97, 330-344).
    sensor_aspect = cvals["sensor_width_mm"] / cvals["sensor_height_mm"]
    fit_sx, fit_sy = cam_math.marker_film_fit_scale(
        scene.cam_film_fit[:, None], sensor_aspect, render_w / render_h
    )  # (C, F)
    mkr_xy = torch.stack(
        [
            mkr_tx * fit_sx[scene.mkr_cam_index],
            mkr_ty * fit_sy[scene.mkr_cam_index],
        ],
        dim=-1,
    )

    return SceneEval(
        tfm_world=tfm_world,
        cam_world=cam_world,
        cam_world_inv=cam_world_inv,
        cam_proj=cam_proj,
        bnd_world_point=bnd_world_point,
        point_xy=point_xy,
        marker_xy=mkr_xy,
        marker_weight=marker_weight,
        marker_enable=marker_enable,
        behind_camera=behind_camera,
    )


def marker_fit_scale(scene: FlatScene, attrs: AttrBlock, frame_indices):
    """Per-marker film-fit scale factors, shaped ((M, F), (M, F))."""
    cv = gather_attr_values(attrs, scene.cam_attr_codes, frame_indices)
    sensor_aspect = (
        cv[:, CAM_ATTRS.index("sensor_width_mm"), :]
        / cv[:, CAM_ATTRS.index("sensor_height_mm"), :]
    )
    render_aspect = scene.cam_render_size[:, 0:1] / scene.cam_render_size[:, 1:2]
    fit_sx, fit_sy = cam_math.marker_film_fit_scale(
        scene.cam_film_fit[:, None], sensor_aspect, render_aspect
    )
    return fit_sx[scene.mkr_cam_index], fit_sy[scene.mkr_cam_index]


def set_marker_screen_positions(
    scene: FlatScene, attrs: AttrBlock, frame_indices, screen_xy
):
    """Write screen-space positions into the raw marker tx/ty attributes.

    screen_xy: (M, F, 2) in the reprojected-point screen space.  The
    inverse film-fit and overscan scales are applied so that a
    subsequent evaluate() reproduces marker_xy == screen_xy.  Host-side;
    returns a new AttrBlock on the attributes' device.
    """
    fsx, fsy = marker_fit_scale(scene, attrs, frame_indices)
    codes_t = scene.mkr_attr_codes
    ov = gather_attr_values(attrs, codes_t[:, 4:6], frame_indices)
    osx = _default_one(codes_t[:, 4], ov[:, 0, :])
    osy = _default_one(codes_t[:, 5], ov[:, 1, :])
    raw = torch.stack(
        [screen_xy[..., 0] / (fsx * osx), screen_xy[..., 1] / (fsy * osy)],
        dim=-1,
    ).cpu().numpy()  # (M, F, 2)
    fi = np.asarray(torch.as_tensor(frame_indices).cpu())
    anim = attrs.anim_values.cpu().numpy().copy()
    static = attrs.static_values.cpu().numpy().copy()
    codes = codes_t.cpu().numpy()
    for m in range(codes.shape[0]):
        for ci in (0, 1):  # tx, ty columns of MKR_ATTRS
            code = int(codes[m, ci])
            if code < 0:
                continue
            if code % 2 == 1:
                anim[code // 2, fi] = raw[m, :, ci]
            else:
                static[code // 2] = raw[m, 0, ci]
    device = attrs.static_values.device
    return AttrBlock(
        static_values=torch.as_tensor(static, device=device),
        anim_values=torch.as_tensor(anim, device=device),
    )


def flat_scene_from_numpy(
    tfm_attr_codes,
    tfm_rotate_order,
    tfm_parent,
    cam_tfm_index,
    cam_attr_codes,
    cam_film_fit,
    cam_render_size,
    bnd_tfm_index,
    mkr_cam_index,
    mkr_bnd_index,
    mkr_attr_codes,
    *,
    device,
    dtype,
):
    """Assemble a FlatScene on `device` from host arrays, deriving
    doubling_steps; cam_render_size is stored in `dtype`."""
    tfm_parent = np.asarray(tfm_parent, dtype=np.int64)
    depth = np.zeros(tfm_parent.shape[0], dtype=np.int64)
    for i, p in enumerate(tfm_parent):
        depth[i] = 0 if p < 0 else depth[p] + 1
    max_depth = int(depth.max()) if depth.size else 0

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return FlatScene(
        tfm_attr_codes=ints(tfm_attr_codes),
        tfm_rotate_order=ints(tfm_rotate_order),
        tfm_parent=ints(tfm_parent),
        cam_tfm_index=ints(cam_tfm_index),
        cam_attr_codes=ints(cam_attr_codes),
        cam_film_fit=ints(cam_film_fit),
        cam_render_size=torch.as_tensor(
            np.asarray(cam_render_size), dtype=dtype, device=device
        ),
        bnd_tfm_index=ints(bnd_tfm_index),
        mkr_cam_index=ints(mkr_cam_index),
        mkr_bnd_index=ints(mkr_bnd_index),
        mkr_attr_codes=ints(mkr_attr_codes),
        doubling_steps=doubling_steps_for_depth(max_depth),
    )
