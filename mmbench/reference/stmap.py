"""Plain ST maps of the classic lens, and the compositor's bilinear warp
through them.

An ST map holds, for every pixel of the output image, the [0, 1] UV of
the input sample: pixel (row j, column i) sits at unit film coordinates
((i + 0.5) / W, (j + 0.5) / H), its map value is that point mapped
through the lens (distorted or undistorted) plus 0.5, in channels S and
T, with B = 0 and A = 1.

The warp reads the map with v up (map row 0 samples the image's last
row), pixel centres at half-integers, clamps the two taps' indices to
the image and blends by the unclamped fractions; so samples left of or
above the image blend its first two columns or rows.
"""

import torch

from mmbench.reference import lens


def stmap(distortion, film_back_cm, width, height, direction, *, dtype,
          device):
    """(H, W, 4) map in `dtype` of the classic lens with this
    distortion."""
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) / height
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    marker = torch.stack([gx - 0.5, gy - 0.5], -1)
    mapped = (lens.distort if direction == "distort" else lens.undistort)(
        marker, distortion, film_back_cm)
    uv = mapped + 0.5
    return torch.cat([uv, torch.zeros_like(uv[..., :1]),
                      torch.ones_like(uv[..., :1])], -1)


def positions(st_map, width, height):
    """(x, y) pixel positions, centres at whole numbers, at which the
    warp samples an image of this size through the map."""
    return (st_map[..., 0] * width - 0.5,
            (1.0 - st_map[..., 1]) * height - 0.5)


def interior(st_map, width, height, margin):
    """(H', W') True where the map samples the image at least `margin`
    pixels inside its first and last centres: both taps in the image,
    none clamped, so the warp there moves smoothly with the map."""
    x, y = positions(st_map, width, height)
    return ((x >= margin) & (x <= width - 1 - margin)
            & (y >= margin) & (y <= height - 1 - margin))


def warp(image, st_map, dtype):
    """`image` (H, W, C) resampled through `st_map` (H', W', >=2).  The
    sample positions are worked out in the map's own precision (they are
    a function of the stored UV); the taps are blended in `dtype`."""
    h, w = image.shape[:2]
    x, y = positions(st_map, w, h)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0).to(dtype)[..., None]
    fy = (y - y0).to(dtype)[..., None]
    xa = torch.clamp(x0.long(), 0, w - 1)
    xb = torch.clamp(xa + 1, 0, w - 1)
    ya = torch.clamp(y0.long(), 0, h - 1)
    yb = torch.clamp(ya + 1, 0, h - 1)
    img = image.to(dtype)
    top = img[ya, xa] * (1.0 - fx) + img[ya, xb] * fx
    bottom = img[yb, xa] * (1.0 - fx) + img[yb, xb] * fx
    return top * (1.0 - fy) + bottom * fy
