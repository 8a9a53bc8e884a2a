"""Batch 3D -> 2D reprojection utility.

Port of mayamatchmovesolver_tpu/utils/reproject.py: the capability of
the reference's mmReprojection command + node
(ref: src/mmSolver/cmd/MMReprojectionCmd.cpp, node/MMReprojectionNode.cpp:119,
core/reprojection.cpp) and the Python rig helper
(ref: python/mmSolver/utils/reproject.py:90): given camera transforms
and intrinsics, map world points into marker space [-0.5, 0.5],
normalized [0, 1] coords, or pixels.  Tensors in; the result on their
device and in the camera matrix's dtype.
"""

import torch

from mayamatchmovesolver_torch.core import camera as cam_math
from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.core.constants import MM_TO_INCH, FilmFit


def reproject_points(
    points_world,
    camera_world_matrix,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    film_offset_x_mm=0.0,
    film_offset_y_mm=0.0,
    render_width=1920,
    render_height=1080,
    film_fit=FilmFit.HORIZONTAL,
    near_clip_cm=0.1,
    far_clip_cm=10000.0,
    camera_scale=1.0,
    as_pixels=False,
    as_normalized=False,
):
    """points_world (..., 3), camera_world_matrix (..., 4, 4) tensors,
    broadcast; the intrinsics are numbers or tensors.

    Default output is marker space [-0.5, 0.5]; as_normalized gives
    [0, 1]; as_pixels gives pixel coordinates (y up).
    """
    like = dict(dtype=camera_world_matrix.dtype,
                device=camera_world_matrix.device)

    def value(v):
        return torch.as_tensor(v, **like)

    proj = cam_math.projection_matrix(
        value(focal_length_mm),
        value(film_back_width_mm) * MM_TO_INCH,
        value(film_back_height_mm) * MM_TO_INCH,
        value(film_offset_x_mm) * MM_TO_INCH,
        value(film_offset_y_mm) * MM_TO_INCH,
        value(float(render_width)),
        value(float(render_height)),
        torch.as_tensor(int(film_fit), device=like["device"]),
        near_clip_cm,
        far_clip_cm,
        camera_scale,
    )
    cam_inv = tfm_math.affine_inverse(camera_world_matrix)
    points_world = points_world.to(**like)
    p = torch.cat([points_world, torch.ones_like(points_world[..., :1])],
                  dim=-1)
    clip = torch.einsum(
        "...ij,...j->...i", proj,
        torch.einsum("...ij,...j->...i", cam_inv, p),
    )
    marker_xy = clip[..., :2] / clip[..., 3:4] * 0.5
    if as_pixels:
        return (marker_xy + 0.5) * value(
            [float(render_width), float(render_height)]
        )
    if as_normalized:
        return marker_xy + 0.5
    return marker_xy


def camera_world_matrix_from_trs(tx, ty, tz, rx, ry, rz, rotate_order=0):
    """Convenience: camera world matrix from TRS tensors (degrees)."""
    return tfm_math.trs_matrix(
        tx, ty, tz, rx, ry, rz, 1.0, 1.0, 1.0, rotate_order
    )
