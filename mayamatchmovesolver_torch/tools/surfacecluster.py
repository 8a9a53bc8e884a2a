"""Surface-cluster / rivet data capabilities.

The reference builds mesh rivets (a locator glued to a surface point
that follows the deforming mesh) and surface clusters (a cluster
deformer whose control follows the surface via a rivet, so edits stay
surface-relative):
  * nearest point on mesh       (ref: python/mmSolver/utils/rivet/
    nearestpointonmesh.py:40 get_nearest_point_on_mesh)
  * point-on-poly rivet          (ref: utils/rivet/pointonpoly.py —
    position + normal + tangent driven by the face point)
  * two-edge rivet               (ref: utils/rivet/meshtwoedge.py:58 —
    the classic rivet.mel construction from two edges)
  * surface cluster              (ref: python/mmSolver/tools/
    surfacecluster/lib.py:351-457
    create_surface_cluster_on_mesh_and_component — cluster deformer +
    rivet follow + per-vertex weights)

Here meshes are arrays (vertices (V, 3) or animated (F, V, 3),
triangles (T, 3) int); every operation is batched NumPy and returns
data, not nodes.

Port of mayamatchmovesolver_tpu/tools/surfacecluster.py: a copy of the
reference's host code.
"""

import numpy as np


def closest_point_on_triangles(vertices, triangles, pos):
    """Closest point on a triangle mesh to `pos`.

    Returns (point (3,), tri_index, barycentric (3,)) — the
    nearestPointOnMesh capability (ref: utils/rivet/
    nearestpointonmesh.py:40, which returns position, normal, face
    index and barycentric coordinates)."""
    v = np.asarray(vertices, float)
    tris = np.asarray(triangles, int)
    p = np.asarray(pos, float)
    a, b, c = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]  # (T, 3)

    # Ericson-style closest point on triangle, vectorized over T.
    ab = b - a
    ac = c - a
    ap = p[None] - a
    d1 = np.sum(ab * ap, axis=-1)
    d2 = np.sum(ac * ap, axis=-1)
    bp = p[None] - b
    d3 = np.sum(ab * bp, axis=-1)
    d4 = np.sum(ac * bp, axis=-1)
    cp = p[None] - c
    d5 = np.sum(ab * cp, axis=-1)
    d6 = np.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    denom = np.where(np.abs(denom) < 1e-30, 1e-30, denom)
    u = va / denom
    w_ = vc / denom
    vbar = vb / denom
    # Clamp to the triangle: handle vertex/edge regions.
    bary = np.stack([u, vbar, w_], axis=-1)  # (T, 3) raw

    # Vertex regions.
    bary = np.where((d1 <= 0)[:, None] & (d2 <= 0)[:, None],
                    np.array([1.0, 0.0, 0.0]), bary)
    bary = np.where((d3 >= 0)[:, None] & (d4 <= d3)[:, None],
                    np.array([0.0, 1.0, 0.0]), bary)
    bary = np.where((d6 >= 0)[:, None] & (d5 <= d6)[:, None],
                    np.array([0.0, 0.0, 1.0]), bary)
    # Edge regions.
    v_ab = d1 / np.where(np.abs(d1 - d3) < 1e-30, 1e-30, d1 - d3)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    bary = np.where(
        on_ab[:, None],
        np.stack([1.0 - v_ab, v_ab, np.zeros_like(v_ab)], axis=-1),
        bary,
    )
    v_ac = d2 / np.where(np.abs(d2 - d6) < 1e-30, 1e-30, d2 - d6)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    bary = np.where(
        on_ac[:, None],
        np.stack([1.0 - v_ac, np.zeros_like(v_ac), v_ac], axis=-1),
        bary,
    )
    v_bc = (d4 - d3) / np.where(
        np.abs((d4 - d3) + (d5 - d6)) < 1e-30, 1e-30,
        (d4 - d3) + (d5 - d6),
    )
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    bary = np.where(
        on_bc[:, None],
        np.stack([np.zeros_like(v_bc), 1.0 - v_bc, v_bc], axis=-1),
        bary,
    )
    bary = np.clip(bary, 0.0, 1.0)
    bary = bary / np.sum(bary, axis=-1, keepdims=True)

    points = (bary[:, 0:1] * a + bary[:, 1:2] * b + bary[:, 2:3] * c)
    d2_all = np.sum((points - p[None]) ** 2, axis=-1)
    ti = int(np.argmin(d2_all))
    return points[ti], ti, bary[ti]


def rivet_frames(vertices, triangles, tri_index, barycentric):
    """Point-on-poly rivet: surface-glued position + orthonormal frame
    per animation frame.

    vertices: (V, 3) or (F, V, 3) animated.  Returns dict with
    'position' (..., 3), 'normal', 'tangent', 'bitangent', and
    'matrix' (..., 4, 4) — what the reference's rivet locator
    hierarchy exposes (ref: utils/rivet/pointonpoly.py PointOnPolyNode:
    position + normal constraints from the face point)."""
    v = np.asarray(vertices, float)
    tris = np.asarray(triangles, int)
    bary = np.asarray(barycentric, float)
    a = v[..., tris[tri_index, 0], :]
    b = v[..., tris[tri_index, 1], :]
    c = v[..., tris[tri_index, 2], :]
    pos = bary[0] * a + bary[1] * b + bary[2] * c
    t1 = b - a
    normal = np.cross(t1, c - a)
    normal = normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-30
    )
    tangent = t1 / np.maximum(
        np.linalg.norm(t1, axis=-1, keepdims=True), 1e-30
    )
    bitangent = np.cross(normal, tangent)
    mat = np.zeros(pos.shape[:-1] + (4, 4))
    mat[..., :3, 0] = tangent
    mat[..., :3, 1] = normal
    mat[..., :3, 2] = bitangent
    mat[..., :3, 3] = pos
    mat[..., 3, 3] = 1.0
    return {
        "position": pos,
        "normal": normal,
        "tangent": tangent,
        "bitangent": bitangent,
        "matrix": mat,
    }


def two_edge_rivet(vertices, edge_a, edge_b):
    """The classic two-edge rivet (ref: utils/rivet/meshtwoedge.py:58):
    anchored at the mean of both edge midpoints, oriented by the
    midpoint axis and the edge directions.  vertices may be animated
    (F, V, 3).  Returns the same dict shape as rivet_frames."""
    v = np.asarray(vertices, float)
    ea = np.asarray(edge_a, int)
    eb = np.asarray(edge_b, int)
    mid_a = 0.5 * (v[..., ea[0], :] + v[..., ea[1], :])
    mid_b = 0.5 * (v[..., eb[0], :] + v[..., eb[1], :])
    pos = 0.5 * (mid_a + mid_b)
    up = mid_b - mid_a
    up = up / np.maximum(
        np.linalg.norm(up, axis=-1, keepdims=True), 1e-30
    )
    edge_dir = v[..., ea[1], :] - v[..., ea[0], :]
    normal = np.cross(up, edge_dir)
    normal = normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-30
    )
    tangent = np.cross(normal, up)
    mat = np.zeros(pos.shape[:-1] + (4, 4))
    mat[..., :3, 0] = tangent
    mat[..., :3, 1] = up
    mat[..., :3, 2] = normal
    mat[..., :3, 3] = pos
    mat[..., 3, 3] = 1.0
    return {
        "position": pos,
        "normal": normal,
        "tangent": tangent,
        "bitangent": up,
        "matrix": mat,
    }


def surface_cluster_weights(vertices, component_index, falloff_radius):
    """Per-vertex cluster weights: 1 at the component, smooth-step
    falloff to 0 at the radius (the reference paints/edits weights on
    the cluster deformer; ref: surfacecluster/lib.py:441
    set_cluster_deformer_weights — weights are arbitrary per-vertex
    scalars, this is the default shape)."""
    v = np.asarray(vertices, float)
    center = v[int(component_index)]
    d = np.linalg.norm(v - center, axis=-1)
    t = np.clip(1.0 - d / max(float(falloff_radius), 1e-30), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)  # smoothstep


def create_surface_cluster(vertices, triangles, component_index,
                           falloff_radius=1.0):
    """Build a surface cluster binding on a mesh component
    (ref: create_surface_cluster_on_mesh_and_component,
    surfacecluster/lib.py:351-441: rivet at the component + cluster
    with weights).  Returns dict(tri_index, barycentric, weights)."""
    v = np.asarray(vertices, float)
    pos = v[int(component_index)]
    _, tri_index, bary = closest_point_on_triangles(
        v, triangles, pos
    )
    weights = surface_cluster_weights(
        v, component_index, falloff_radius
    )
    return {
        "tri_index": tri_index,
        "barycentric": bary,
        "weights": weights,
    }


def apply_surface_cluster(cluster, vertices, triangles, control_delta):
    """Deform the mesh by the cluster's control offset, expressed in
    the rivet's surface-local frame so the edit follows the surface
    (the reference's whole point: the cluster control is constrained
    to the rivet; ref: surfacecluster/lib.py:130-152
    _create_constraint_to + the cluster deformer).

    vertices: (V, 3) or (F, V, 3).  control_delta: (3,) offset in
    rivet-local (tangent, normal, bitangent) coordinates.  Returns the
    deformed vertices."""
    v = np.asarray(vertices, float)
    frames = rivet_frames(
        v, triangles, cluster["tri_index"], cluster["barycentric"]
    )
    basis = np.stack(
        [frames["tangent"], frames["normal"], frames["bitangent"]],
        axis=-1,
    )  # (..., 3, 3)
    delta_world = np.einsum(
        "...ij,j->...i", basis, np.asarray(control_delta, float)
    )
    w = np.asarray(cluster["weights"], float)
    return v + w[..., :, None] * delta_world[..., None, :]
