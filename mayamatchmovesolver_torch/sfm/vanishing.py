"""Camera calibration from one/two vanishing points.

Port of mayamatchmovesolver_tpu/sfm/vanishing.py, itself the port of the
reference's calibrate module
(ref: src/mmSolver/calibrate/calibrate_common.cpp:109-385,
vanishing_point.cpp:50-150), which implements Guillou et al. 2000 and
Orghidan et al. 2012.  Coordinates: 'image normalized' space — x in
[-0.5, 0.5] horizontally, y scaled by the film back aspect, principal
point near (0,0) — exactly the space the reference's mmCameraCalibrate
node feeds in.  Points are tensors (..., 2); everything is elementwise
and runs on their device in their dtype.
"""

import enum
from typing import NamedTuple

import torch


class SceneScaleMode(enum.IntEnum):
    """(ref: calibrate_common.h SceneScaleMode.)"""

    UNIFORM_SCALE = 0
    CAMERA_HEIGHT = 1


class CameraCalibration(NamedTuple):
    focal_length_factor: torch.Tensor  # 2 * focal_mm / filmback_w_mm
    focal_length_mm: torch.Tensor
    rotation_matrix: torch.Tensor  # (3, 3) camera orientation (world from cam)
    translation: torch.Tensor  # (3,) camera position
    ok: torch.Tensor  # bool validity


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def focal_length_from_two_vanishing_points(vp_a, vp_b, principal_point):
    """(ref: calcFocalLength, calibrate_common.cpp:109-139.)

    Returns (focal_factor, ok).  All points (..., 2).
    """
    d = vp_a - vp_b
    d_dir = d / torch.clamp(_norm(d), min=1e-12)
    p_vpb = principal_point - vp_b
    proj = (d_dir * p_vpb).sum(dim=-1)
    puv = proj[..., None] * d_dir + vp_b
    pp_uv = torch.linalg.vector_norm(principal_point - puv, dim=-1)
    # Signed distances along the line: for a valid configuration the
    # foot Puv lies BETWEEN the vanishing points, so the signed product
    # is negative and -product equals the reference's unsigned
    # |vpA-Puv|*|vpB-Puv| (calibrate_common.cpp:126-136); when both VPs
    # fall on the same side the signed form correctly yields
    # focal^2 < 0 where the unsigned form would not.
    ta = ((vp_a - puv) * d_dir).sum(dim=-1)
    tb = ((vp_b - puv) * d_dir).sum(dim=-1)
    focal_sq = -(ta * tb) - pp_uv * pp_uv
    ok = focal_sq > 0
    return torch.sqrt(torch.clamp(focal_sq, min=1e-12)), ok


def rotation_from_two_vanishing_points(vp_a, vp_b, principal_point,
                                       focal_factor):
    """(ref: calcCameraRotationMatrix, calibrate_common.cpp:151-191.)
    Columns: x-axis toward vpA direction, y-axis toward vpB direction,
    z-axis their cross product; camera looks down -z."""
    f = focal_factor
    o_vpa = torch.cat([vp_a - principal_point, -f[..., None]], dim=-1)
    o_vpb = torch.cat([vp_b - principal_point, -f[..., None]], dim=-1)
    a_dir = o_vpa / _norm(o_vpa)
    b_dir = o_vpb / _norm(o_vpb)
    w = torch.linalg.cross(a_dir, b_dir, dim=-1)
    return torch.stack([a_dir, b_dir, w], dim=-1)  # columns


def second_vanishing_point_from_horizon(
    vp_a, principal_point, horizon_a, horizon_b, focal_factor
):
    """Derive the second VP for one-point perspective: it lies along the
    horizon direction and satisfies (vpA-P).(vpB-P) = -f^2
    (ref: oneVanishingPoint, vanishing_point.cpp:50-101)."""
    d = horizon_b - horizon_a
    d = d / torch.clamp(_norm(d), min=1e-12)
    u = vp_a - principal_point
    denom = (u * d).sum(dim=-1)
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    s = (-(focal_factor**2) - (u * u).sum(dim=-1)) / denom
    return vp_a + s[..., None] * d


def translation_from_origin_point(origin_point, principal_point,
                                  focal_factor):
    """(ref: calcTranslationVector, calibrate_common.cpp:267-281) —
    the camera sits at unit distance along -z from the chosen world
    origin; the origin's screen position fixes x/y."""
    inv_f = 1.0 / focal_factor  # tan(aov/2) = fbw/(2*focal)
    rel = origin_point - principal_point
    return torch.stack(
        [
            inv_f * rel[..., 0],
            inv_f * rel[..., 1],
            -torch.ones_like(rel[..., 0]),
        ],
        dim=-1,
    )


def apply_scene_scale(translation, mode, distance_cm):
    """(ref: applySceneScale, calibrate_common.cpp:285-311.)"""
    mode = int(mode)
    if mode == SceneScaleMode.UNIFORM_SCALE:
        return translation * distance_cm
    if mode == SceneScaleMode.CAMERA_HEIGHT:
        factor = distance_cm / torch.clamp(
            translation[..., 1].abs(), min=1e-12
        )
        return translation * factor[..., None]
    raise ValueError("invalid SceneScaleMode: %r" % mode)


def _user_focal_factor(focal_length_mm, film_back_width_mm, like):
    """(focal length as a tensor like the points, 2 * focal / film back
    width)."""
    focal_mm = torch.as_tensor(focal_length_mm, dtype=like.dtype,
                               device=like.device)
    return focal_mm, 2.0 * (focal_mm / film_back_width_mm)


def _camera_position(rot, origin_point, principal_point, focal_factor,
                     scene_scale_mode, scene_scale_distance_cm):
    """Camera position in world space: R @ t_cam, scene scale applied.
    The rotation is world-from-camera-axes (the reference multiplies
    through the inverse transform; ref: calcCameraParameters:340-358)."""
    t_cam = translation_from_origin_point(
        origin_point, principal_point, focal_factor
    )
    position = torch.einsum("...ij,...j->...i", rot, t_cam)
    return apply_scene_scale(
        position, scene_scale_mode, scene_scale_distance_cm
    )


def calibrate_two_vanishing_points(
    focal_length_mm,
    film_back_width_mm,
    film_back_height_mm,
    origin_point,
    principal_point,
    vanishing_point_a,
    vanishing_point_b,
    scene_scale_mode=SceneScaleMode.UNIFORM_SCALE,
    scene_scale_distance_cm=1.0,
) -> CameraCalibration:
    """(ref: twoVanishingPoints, vanishing_point.cpp:103-150.)  Solves
    focal length + rotation + position from two orthogonal VPs."""
    focal_factor, ok = focal_length_from_two_vanishing_points(
        vanishing_point_a, vanishing_point_b, principal_point
    )
    # Fall back to the user's focal length when the VP pair is invalid
    # (the reference errors out; we keep it branchless).
    _, user_factor = _user_focal_factor(
        focal_length_mm, film_back_width_mm, vanishing_point_a
    )
    focal_factor = torch.where(ok, focal_factor, user_factor)

    rot = rotation_from_two_vanishing_points(
        vanishing_point_a, vanishing_point_b, principal_point, focal_factor
    )
    position = _camera_position(
        rot, origin_point, principal_point, focal_factor,
        scene_scale_mode, scene_scale_distance_cm,
    )
    focal_mm = focal_factor * film_back_width_mm / 2.0
    return CameraCalibration(
        focal_length_factor=focal_factor,
        focal_length_mm=focal_mm,
        rotation_matrix=rot,
        translation=position,
        ok=ok,
    )


def calibrate_one_vanishing_point(
    focal_length_mm,
    film_back_width_mm,
    film_back_height_mm,
    origin_point,
    principal_point,
    vanishing_point_a,
    horizon_point_a,
    horizon_point_b,
    scene_scale_mode=SceneScaleMode.UNIFORM_SCALE,
    scene_scale_distance_cm=1.0,
) -> CameraCalibration:
    """(ref: oneVanishingPoint, vanishing_point.cpp:50-101) — focal
    length is taken from the user; the second VP comes from the horizon
    line."""
    focal_mm, focal_factor = _user_focal_factor(
        focal_length_mm, film_back_width_mm, vanishing_point_a
    )
    vp_b = second_vanishing_point_from_horizon(
        vanishing_point_a, principal_point, horizon_point_a,
        horizon_point_b, focal_factor,
    )
    rot = rotation_from_two_vanishing_points(
        vanishing_point_a, vp_b, principal_point, focal_factor
    )
    position = _camera_position(
        rot, origin_point, principal_point, focal_factor,
        scene_scale_mode, scene_scale_distance_cm,
    )
    return CameraCalibration(
        focal_length_factor=focal_factor,
        focal_length_mm=focal_mm,
        rotation_matrix=rot,
        translation=position,
        ok=torch.ones((), dtype=torch.bool, device=focal_mm.device),
    )
