"""TRS transform mathematics, batched and differentiable.

Port of mayamatchmovesolver_tpu/core/transform.py: Maya-style
matrix = T @ R @ S with Euler rotate orders, angles in degrees
(ref: lib/rust/mmscenegraph/src/math/transform.rs:338-453).  All
functions broadcast over leading batch dimensions.

Convention: column vectors, world_point = world_matrix @ [x, y, z, 1]^T.
A child's world matrix is parent_world @ local.
"""

import torch

from mayamatchmovesolver_torch.core.constants import (
    DEGREES_TO_RADIANS,
    ROTATE_ORDER_PERMS,
)


def _axis_rotation_matrices(rx_rad, ry_rad, rz_rad):
    """Stacked (..., 3, 3, 3) rotation matrices about X, Y and Z."""
    rx_rad, ry_rad, rz_rad = torch.broadcast_tensors(rx_rad, ry_rad, rz_rad)
    shape = rx_rad.shape
    zero = torch.zeros_like(rx_rad)
    one = zero + 1.0
    sx, cx = torch.sin(rx_rad), torch.cos(rx_rad)
    sy, cy = torch.sin(ry_rad), torch.cos(ry_rad)
    sz, cz = torch.sin(rz_rad), torch.cos(rz_rad)
    mx = torch.stack(
        [one, zero, zero, zero, cx, -sx, zero, sx, cx], dim=-1
    ).reshape(shape + (3, 3))
    my = torch.stack(
        [cy, zero, sy, zero, one, zero, -sy, zero, cy], dim=-1
    ).reshape(shape + (3, 3))
    mz = torch.stack(
        [cz, -sz, zero, sz, cz, zero, zero, zero, one], dim=-1
    ).reshape(shape + (3, 3))
    return torch.stack([mx, my, mz], dim=-3)


def euler_to_rotation_matrix(rx_deg, ry_deg, rz_deg, rotate_order):
    """3x3 rotation from Euler angles in degrees with per-element rotate order.

    rotate_order is an integer tensor in [0, 6) following RotateOrder.
    For apply-order (first, second, third), the combined matrix acting on
    column vectors is M[third] @ M[second] @ M[first].
    """
    mats = _axis_rotation_matrices(
        rx_deg * DEGREES_TO_RADIANS,
        ry_deg * DEGREES_TO_RADIANS,
        rz_deg * DEGREES_TO_RADIANS,
    )
    perms = torch.as_tensor(ROTATE_ORDER_PERMS, device=mats.device).long()
    perms = perms[rotate_order].expand(mats.shape[:-3] + (3,))

    def pick(k):
        return torch.take_along_dim(
            mats, perms[..., k:k + 1, None, None], dim=-3
        ).squeeze(-3)

    return torch.matmul(pick(2), torch.matmul(pick(1), pick(0)))


def trs_matrix(tx, ty, tz, rx, ry, rz, sx, sy, sz, rotate_order):
    """4x4 Maya-style transform matrix: T @ R @ S.

    Angles are degrees.  Broadcasts over leading dims; returns (..., 4, 4).
    """
    r3 = euler_to_rotation_matrix(rx, ry, rz, rotate_order)
    shape = r3.shape[:-2]
    tx, ty, tz, sx, sy, sz = (
        torch.as_tensor(v, dtype=r3.dtype, device=r3.device).expand(shape)
        for v in (tx, ty, tz, sx, sy, sz)
    )
    # The upper 3x3 is R * diag(s) (columns scaled), the last column the
    # translation: T @ R @ S without three explicit 4x4 products.
    rs = r3 * torch.stack([sx, sy, sz], dim=-1)[..., None, :]
    zero = torch.zeros_like(tx)
    one = zero + 1.0
    t_col = torch.stack([tx, ty, tz], dim=-1)[..., None]
    top = torch.cat([rs, t_col], dim=-1)  # (..., 3, 4)
    bottom = torch.stack([zero, zero, zero, one], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def inverse3(m):
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            co_a, -(b * i - c * h), (b * f - c * e),
            co_b, (a * i - c * g), -(a * f - c * d),
            co_c, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(m.shape)
    return adj / det[..., None, None]


def affine_inverse(matrix4):
    """Inverse of (..., 4, 4) affine matrices (bottom row 0,0,0,1)."""
    r_inv = inverse3(matrix4[..., :3, :3])
    t_inv = -torch.matmul(r_inv, matrix4[..., :3, 3:4])  # (..., 3, 1)
    top = torch.cat([r_inv, t_inv], dim=-1)
    zero = torch.zeros_like(matrix4[..., 3, :3])
    bottom = torch.cat([zero, torch.ones_like(zero[..., :1])], dim=-1)
    return torch.cat([top, bottom[..., None, :]], dim=-2)
