"""Ray ↔ triangle-mesh intersection.

Counterpart of the reference's raytrace utility
(ref: python/mmSolver/utils/raytrace.py:51-279 — `closest_intersect`
and `closest_intersect_with_normal` via Maya's MFnMesh
closestIntersection): here the mesh is plain arrays (vertices,
triangles) and intersection is a fully batched Moller-Trumbore test
over every (ray, triangle) pair — the backing op for the
ray-cast-marker capability (ref: python/mmSolver/tools/raycastmarker).

Port of mayamatchmovesolver_tpu/utils/raytrace.py: the same algorithm
on tensors, computed on the device of the first tensor argument (the
CPU when none is a tensor).  Arrays and lists join it in its dtype,
float64 when no argument is a tensor.  It materialises several
(R, T, 3) tensors, as the reference does.
"""

import numpy as np
import torch

__all__ = [
    "intersect_rays_mesh",
    "closest_intersect",
    "closest_intersect_with_normal",
]


def _float_tensors(*values):
    """The values as float tensors of one dtype on one device, both
    taken from the first tensor among them."""
    like = next((v for v in values if torch.is_tensor(v)), None)
    dtype = torch.float64 if like is None else like.dtype
    device = None if like is None else like.device
    return [
        v.to(device=device, dtype=dtype) if torch.is_tensor(v)
        else torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                             device=device)
        for v in values
    ]


def intersect_rays_mesh(
    origins,
    directions,
    vertices,
    triangles,
    max_dist=9999.9,
    tolerance=1e-7,
    test_both_directions=False,
):
    """Batched Moller-Trumbore intersection.

    origins: (R, 3) ray origins; directions: (R, 3) (need not be unit).
    vertices: (V, 3); triangles: (T, 3) int vertex indices.
    max_dist/tolerance mirror the reference's flags
    (ref: utils/raytrace.py:181-234).

    Returns (hit_point (R, 3), hit_normal (R, 3), hit_dist (R,),
    hit_mask (R,) bool).  Distances are in units of |direction|.
    """
    origins, directions, vertices = _float_tensors(
        origins, directions, vertices
    )
    origins = torch.atleast_2d(origins)
    directions = torch.atleast_2d(directions)
    triangles = torch.as_tensor(
        triangles if torch.is_tensor(triangles) else np.asarray(triangles),
        device=vertices.device,
    ).long()

    v0 = vertices[triangles[:, 0]]  # (T, 3)
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0

    d = directions[:, None, :]  # (R, 1, 3)
    o = origins[:, None, :]

    pvec = torch.linalg.cross(d, e2[None, :, :])  # (R, T, 3)
    det = torch.sum(e1[None, :, :] * pvec, dim=-1)  # (R, T)
    small = torch.abs(det) < tolerance
    inv_det = torch.where(small, torch.zeros_like(det), 1.0 / det)

    tvec = o - v0[None, :, :]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None, :, :])
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None, :, :] * qvec, dim=-1) * inv_det

    valid = ~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    if test_both_directions:
        # Accept hits behind the origin too, ranked by |t|
        # (ref: utils/raytrace.py test_both_directions flag).
        dist = torch.abs(t)
        valid = valid & (dist <= max_dist) & (dist > tolerance)
    else:
        dist = t
        valid = valid & (t > tolerance) & (t <= max_dist)

    ranked = torch.where(valid, torch.abs(dist),
                         torch.full_like(dist, float("inf")))
    # torch.argmin, like jnp.argmin, picks the first of equal minima: a
    # ray with no hit reports triangle 0 and a false mask.
    best = torch.argmin(ranked, dim=-1)  # (R,)
    hit_mask = torch.gather(valid, -1, best[:, None])[:, 0]

    t_best = torch.gather(t, -1, best[:, None])[:, 0]
    hit_point = origins + t_best[:, None] * directions
    n = torch.linalg.cross(e1, e2)  # (T, 3) geometric normal
    n = n / torch.clamp(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=tolerance
    )
    hit_normal = n[best]
    return hit_point, hit_normal, t_best, hit_mask


def closest_intersect(
    point,
    direction,
    vertices,
    triangles,
    test_both_directions=False,
    max_dist=9999.9,
    tolerance=1e-7,
):
    """Single-ray convenience wrapper; returns the hit point or None
    (ref: python/mmSolver/utils/raytrace.py:181)."""
    hit, _, _, ok = intersect_rays_mesh(
        point,
        direction,
        vertices,
        triangles,
        max_dist=max_dist,
        tolerance=tolerance,
        test_both_directions=test_both_directions,
    )
    if not bool(ok[0]):
        return None
    return hit[0]


def closest_intersect_with_normal(
    point,
    direction,
    vertices,
    triangles,
    test_both_directions=False,
    max_dist=9999.9,
    tolerance=1e-7,
):
    """Returns (hit_point, hit_normal) or (None, None)
    (ref: python/mmSolver/utils/raytrace.py:235)."""
    hit, normal, _, ok = intersect_rays_mesh(
        point,
        direction,
        vertices,
        triangles,
        max_dist=max_dist,
        tolerance=tolerance,
        test_both_directions=test_both_directions,
    )
    if not bool(ok[0]):
        return None, None
    return hit[0], normal[0]
