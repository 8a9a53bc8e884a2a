"""Pin-hole camera projection mathematics (Maya-compatible).

Port of mayamatchmovesolver_tpu/core/camera.py: frustum from focal
length/film back, the four film-fit modes, and the final projection
matrix (ref: lib/rust/mmscenegraph/src/math/camera.rs:123-327), as
branchless, batched torch functions.  film_fit is an integer tensor.

Units follow Maya: film back in inches, focal length in millimetres,
world/clip planes in centimetres.
"""

import torch

from mayamatchmovesolver_torch.core.constants import (
    FilmFit,
    INCH_TO_MM,
    MM_TO_CM,
)


def angle_of_view_radians(film_back_size_mm, focal_length_mm):
    """(ref: lib/rust/mmscenegraph/src/math/camera.rs:124-131.)  Tensors
    in, broadcast; the result on their device and in their dtype."""
    return 2.0 * torch.atan(film_back_size_mm * (0.5 / focal_length_mm))


def frustum_coordinates(
    focal_length_mm,
    film_back_width_inch,
    film_back_height_inch,
    film_offset_x_inch,
    film_offset_y_inch,
    near_clip_plane_cm,
    camera_scale,
):
    """Near-plane frustum (right, left, top, bottom) in cm."""
    film_width_mm = film_back_width_inch * INCH_TO_MM
    film_height_mm = film_back_height_inch * INCH_TO_MM
    offset_x_mm = film_offset_x_inch * INCH_TO_MM
    offset_y_mm = film_offset_y_inch * INCH_TO_MM
    focal_to_near = (near_clip_plane_cm / focal_length_mm) * camera_scale
    right = focal_to_near * (0.5 * film_width_mm + offset_x_mm)
    left = focal_to_near * (-0.5 * film_width_mm + offset_x_mm)
    top = focal_to_near * (0.5 * film_height_mm + offset_y_mm)
    bottom = focal_to_near * (-0.5 * film_height_mm + offset_y_mm)
    return right, left, top, bottom


def film_fit_logic(
    right, left, top, bottom, image_aspect_ratio, film_aspect_ratio, film_fit
):
    """Apply the film-fit mode; returns (scale_x, scale_y, screen dict).

    film_fit broadcasts as an integer tensor of FilmFit values.
    """
    fit = film_fit
    one = torch.ones_like(image_aspect_ratio)
    where = torch.where

    is_horizontal = fit == FilmFit.HORIZONTAL
    is_vertical = fit == FilmFit.VERTICAL
    is_fill = fit == FilmFit.FILL
    is_overscan = fit == FilmFit.OVERSCAN
    film_gt_image = film_aspect_ratio > image_aspect_ratio

    width = right - left
    height = top - bottom

    # FILL: wide film letterboxes horizontally, else scales Y.
    fill_x = where(film_gt_image, film_aspect_ratio / image_aspect_ratio, one)
    fill_y = where(film_gt_image, one, image_aspect_ratio / film_aspect_ratio)
    fill_sx = where(film_gt_image, height * image_aspect_ratio, width)
    fill_sy = where(
        film_gt_image,
        height,
        (width * (film_aspect_ratio / image_aspect_ratio)) / film_aspect_ratio,
    )

    # OVERSCAN
    over_x = where(film_gt_image, one, film_aspect_ratio / image_aspect_ratio)
    over_y = where(film_gt_image, image_aspect_ratio / film_aspect_ratio, one)
    over_sx = where(
        film_gt_image, width, width * (image_aspect_ratio / film_aspect_ratio)
    )
    over_sy = where(film_gt_image, width / image_aspect_ratio, height)

    scale_x = where(
        is_horizontal,
        image_aspect_ratio / film_aspect_ratio,
        where(
            is_vertical,
            1.0 / (image_aspect_ratio / film_aspect_ratio),
            where(is_fill, fill_x, where(is_overscan, over_x, one)),
        ),
    )
    scale_y = where(is_fill, fill_y, where(is_overscan, over_y, one))
    size_x = where(
        is_horizontal,
        width,
        where(
            is_vertical,
            height * image_aspect_ratio,
            where(is_fill, fill_sx, over_sx),
        ),
    )
    size_y = where(
        is_horizontal,
        width / image_aspect_ratio,
        where(is_vertical, height, where(is_fill, fill_sy, over_sy)),
    )

    return (
        scale_x,
        scale_y,
        {
            "size_x_mm": size_x,
            "size_y_mm": size_y,
            "right": right * scale_x,
            "left": left * scale_x,
            "top": top * scale_y,
            "bottom": bottom * scale_y,
        },
    )


def projection_matrix(
    focal_length_mm,
    film_back_width_inch,
    film_back_height_inch,
    film_offset_x_inch,
    film_offset_y_inch,
    image_width_pixels,
    image_height_pixels,
    film_fit,
    near_clip_plane_cm,
    far_clip_plane_cm,
    camera_scale,
):
    """Maya-compatible 4x4 projection matrix, batched over leading dims.

    The film-offset terms sit at their column-convention positions so
    that `proj @ p` matches Maya's `p_row @ M` (see the reference
    package's projection_matrix for the derivation).
    """
    film_aspect = film_back_width_inch / film_back_height_inch
    image_aspect = image_width_pixels / image_height_pixels
    right, left, top, bottom = frustum_coordinates(
        focal_length_mm,
        film_back_width_inch,
        film_back_height_inch,
        film_offset_x_inch,
        film_offset_y_inch,
        near_clip_plane_cm,
        camera_scale,
    )
    scale_x, scale_y, screen = film_fit_logic(
        right, left, top, bottom, image_aspect, film_aspect, film_fit
    )

    size_x = screen["size_x_mm"]
    zero = torch.zeros_like(size_x)
    near = zero + near_clip_plane_cm
    far = zero + far_clip_plane_cm

    m00 = 1.0 / (size_x * 0.5) * MM_TO_CM
    m11 = 1.0 / (screen["size_y_mm"] * 0.5) * MM_TO_CM
    m20 = (
        (screen["right"] + screen["left"]) / (screen["right"] - screen["left"])
    ) * scale_x
    m21 = (
        (screen["top"] + screen["bottom"]) / (screen["top"] - screen["bottom"])
    ) * scale_y
    m22 = (far + near) / (far - near)
    m23 = 2.0 * far * near / (far - near)

    rows = [
        torch.stack([m00, zero, m20, zero], dim=-1),
        torch.stack([zero, m11, m21, zero], dim=-1),
        torch.stack([zero, zero, m22, m23], dim=-1),
        torch.stack([zero, zero, zero - 1.0, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def marker_film_fit_scale(film_fit, film_aspect_ratio, render_aspect_ratio):
    """Per-axis multipliers applied to marker positions so they live in the
    same screen space as reprojected points.

    Returns (scale_x, scale_y) broadcasting with the inputs.
    """
    fit = film_fit
    ratio = render_aspect_ratio / film_aspect_ratio
    one = torch.ones_like(ratio)
    film_gt_render = film_aspect_ratio > render_aspect_ratio
    where = torch.where

    scale_x = where(
        fit == FilmFit.VERTICAL,
        1.0 / ratio,
        where(
            (fit == FilmFit.FILL) & film_gt_render,
            1.0 / ratio,
            where((fit == FilmFit.OVERSCAN) & ~film_gt_render, 1.0 / ratio, one),
        ),
    )
    scale_y = where(
        fit == FilmFit.HORIZONTAL,
        ratio,
        where(
            (fit == FilmFit.FILL) & ~film_gt_render,
            ratio,
            where((fit == FilmFit.OVERSCAN) & film_gt_render, ratio, one),
        ),
    )
    return scale_x, scale_y
