"""Two-view geometry: essential matrix, RANSAC, pose, triangulation,
homography.

Port of mayamatchmovesolver_tpu/sfm/twoview.py, the counterpart of the
reference's SfM layer
(ref: src/mmSolver/sfm/camera_relative_pose.cpp:94-157
`robust_relative_pose` via openMVG ACRANSAC 8-point essential;
sfm/homography.cpp; vendored external/openMVG solvers).  Design, as in
the JAX package:

  * RANSAC is hypothesis-parallel — all minimal samples are drawn up
    front and every model is estimated and scored in one batched call
    (every function here broadcasts over leading axes);
  * null spaces come from solver/linalg.py (torch.linalg.eigh), so only
    quantities that do not depend on an eigenvector's sign, or on the
    basis of a repeated eigenvalue, leave a function.

The draws are explicit: the robust estimators take a torch.Generator,
or the (hypotheses, sample) index tensor itself.

Points are in normalized camera coordinates (undistorted, focal-divided
bearing directions with z=1 implied), matching what the reference feeds
openMVG after marker-to-bearing conversion.
"""

from typing import NamedTuple

import torch

from mayamatchmovesolver_torch.core.transform import inverse3
from mayamatchmovesolver_torch.solver import linalg


class RelativePose(NamedTuple):
    rotation: torch.Tensor  # (3, 3) camera2-from-camera1
    translation: torch.Tensor  # (3,) unit norm
    essential: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor


def draw_samples(num_points, num_hypotheses, sample_size, generator,
                 weights=None):
    """(num_hypotheses, sample_size) indices, each row drawn without
    replacement with probability proportional to `weights` (uniform when
    None): a point of weight zero is never drawn.  The draw is made on
    the generator's device."""
    if weights is None:
        weights = torch.ones(num_points, device=generator.device)
    weights = torch.as_tensor(weights).to(
        device=generator.device, dtype=torch.float64
    )
    return torch.multinomial(
        weights.expand(num_hypotheses, num_points), sample_size,
        replacement=False, generator=generator,
    )


def _sample_indices(sample_indices, generator, num_points, num_hypotheses,
                    sample_size, weights, device):
    """The estimators' draws: the given indices, else a draw from the
    given generator, else from a CPU generator seeded 0."""
    if sample_indices is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sample_indices = draw_samples(num_points, num_hypotheses,
                                      sample_size, generator, weights)
    return torch.as_tensor(sample_indices).to(device=device,
                                              dtype=torch.int64)


def _normalize_points(pts):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    mean = pts.mean(dim=-2, keepdim=True)
    centered = pts - mean
    scale = 2.0 ** 0.5 / torch.clamp(
        torch.linalg.vector_norm(centered, dim=-1).mean(dim=-1), min=1e-12
    )
    zero = torch.zeros_like(scale)
    t = torch.stack(
        [
            torch.stack([scale, zero, -scale * mean[..., 0, 0]], dim=-1),
            torch.stack([zero, scale, -scale * mean[..., 0, 1]], dim=-1),
            torch.stack([zero, zero, zero + 1.0], dim=-1),
        ],
        dim=-2,
    )
    return centered * scale[..., None, None], t


def _essential_rows(pts1, pts2):
    """Hartley-normalized constraint rows p2^T E p1 = 0, (..., N, 9), and
    the two normalizing transforms."""
    n1, t1 = _normalize_points(pts1)
    n2, t2 = _normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    ones = torch.ones_like(x1)
    a = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
        dim=-1,
    )
    return a, t1, t2


def _essential_from_normal(ata, t1, t2):
    e_vec = linalg.smallest_eigenvector(ata)
    e = e_vec.reshape(e_vec.shape[:-1] + (3, 3))
    # Denormalize: E = T2^T E_n T1.
    e = t2.transpose(-1, -2) @ e @ t1
    return project_to_essential(e)


def eight_point_essential(pts1, pts2):
    """Essential matrix from >=8 correspondences (normalized coords).

    Linear 8-point with Hartley normalization, then projection onto the
    essential manifold (two equal singular values, third zero) — the
    same pipeline openMVG's solver uses
    (ref: external/openMVG essential-matrix solvers).
    pts1, pts2: (..., N, 2).  The result's sign is arbitrary.
    """
    a, t1, t2 = _essential_rows(pts1, pts2)
    return _essential_from_normal(a.transpose(-1, -2) @ a, t1, t2)


def project_to_essential(e):
    """Project onto the essential manifold: singular values (s, s, 0)."""
    # Eigendecompose E^T E = V diag(s^2) V^T.
    w, v = linalg.eigh(e.transpose(-1, -2) @ e)
    s = torch.sqrt(torch.clamp(w, min=0.0))  # ascending
    # U columns = E v / s (guard the null direction).
    u = e @ v / torch.clamp(s[..., None, :], min=1e-12)
    s_avg = 0.5 * (s[..., 1] + s[..., 2])
    target = torch.stack([torch.zeros_like(s_avg), s_avg, s_avg], dim=-1)
    return u @ (target[..., :, None] * v.transpose(-1, -2))


def _homogeneous(pts):
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def sampson_error(e, pts1, pts2):
    """First-order geometric (Sampson) distance, per correspondence."""
    p1 = _homogeneous(pts1)
    p2 = _homogeneous(pts2)
    ep1 = torch.einsum("...ij,...nj->...ni", e, p1)
    etp2 = torch.einsum("...ji,...nj->...ni", e, p2)
    num = torch.einsum("...ni,...ni->...n", p2, ep1) ** 2
    den = (
        ep1[..., 0] ** 2
        + ep1[..., 1] ** 2
        + etp2[..., 0] ** 2
        + etp2[..., 1] ** 2
    )
    return num / torch.clamp(den, min=1e-30)


def triangulate_linear(r1, t1, r2, t2, pts1, pts2):
    """DLT triangulation for projections P_i = [R_i | t_i].

    pts: (..., N, 2) normalized camera coords.  Returns (..., N, 3)
    world points.  (ref capability: openMVG triangulation used by
    mmSolverCmd triangulation paths and triangulatebundle.py.)
    """

    def row_pair(r, t, pts):
        # For P = [R|t] and x = (u, v): rows u*P3-P1, v*P3-P2.
        p = torch.cat([r, t[..., :, None]], dim=-1)  # (..., 3, 4)
        u = pts[..., 0:1]
        v = pts[..., 1:2]
        ra = u * p[..., None, 2, :] - p[..., None, 0, :]
        rb = v * p[..., None, 2, :] - p[..., None, 1, :]
        return ra, rb

    ra1, rb1 = row_pair(r1, t1, pts1)
    ra2, rb2 = row_pair(r2, t2, pts2)
    a = torch.stack(torch.broadcast_tensors(ra1, rb1, ra2, rb2),
                    dim=-2)  # (..., N, 4, 4)
    ata = a.transpose(-1, -2) @ a
    x = linalg.smallest_eigenvector(ata)  # (..., N, 4)
    return x[..., :3] / torch.where(
        x[..., 3:].abs() < 1e-12, 1e-12, x[..., 3:]
    )


def decompose_essential(e, pts1, pts2, inlier_mask=None):
    """The four (R, t) factorizations of E; pick the one with the most
    points in front of both cameras (cheirality), like openMVG's
    RelativePoseFromEssential."""
    _, v = linalg.eigh(e.transpose(-1, -2) @ e)
    # Reorder to descending singular values (eigh gives ascending).
    v = v.flip(-1)
    u = e @ v
    # The third column of U corresponds to E's (near-)zero singular
    # value, so dividing by it amplifies noise; rebuild U with
    # Gram-Schmidt on the two well-conditioned columns plus a cross
    # product — guaranteed proper rotation.
    u0 = u[..., :, 0]
    u0 = u0 / torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    u1 = u[..., :, 1]
    u1 = u1 - (u1 * u0).sum(dim=-1, keepdim=True) * u0
    u1 = u1 / torch.linalg.vector_norm(u1, dim=-1, keepdim=True)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    u = torch.stack([u0, u1, u2], dim=-1)
    v = torch.cat(
        [v[..., :, :2],
         v[..., :, 2:] * torch.sign(linalg.det3(v))[..., None, None]],
        dim=-1,
    )

    w = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=e.dtype, device=e.device,
    )
    vt = v.transpose(-1, -2)
    r_a = u @ w @ vt
    r_b = u @ w.transpose(-1, -2) @ vt
    t_u = u[..., :, 2]

    candidates = [
        (r_a, t_u),
        (r_a, -t_u),
        (r_b, t_u),
        (r_b, -t_u),
    ]
    if inlier_mask is None:
        inlier_mask = torch.ones(pts1.shape[:-1], dtype=torch.bool,
                                 device=e.device)

    def count_front(rt):
        r, t = rt
        eye = torch.eye(3, dtype=e.dtype, device=e.device).expand(r.shape)
        zero = torch.zeros_like(t)
        x = triangulate_linear(eye, zero, r, t, pts1, pts2)
        z1 = x[..., 2]
        x2 = torch.einsum("...ij,...nj->...ni", r, x) + t[..., None, :]
        z2 = x2[..., 2]
        ok = (z1 > 0) & (z2 > 0) & inlier_mask
        return ok.sum(dim=-1)

    counts = torch.stack([count_front(c) for c in candidates], dim=-1)
    best = torch.argmax(counts, dim=-1)
    rs = torch.stack([c[0] for c in candidates], dim=-3)
    ts = torch.stack([c[1] for c in candidates], dim=-2)
    r_best = torch.take_along_dim(
        rs, best[..., None, None, None], dim=-3
    ).squeeze(-3)
    t_best = torch.take_along_dim(
        ts, best[..., None, None], dim=-2
    ).squeeze(-2)
    return r_best, t_best


def robust_relative_pose(
    pts1,
    pts2,
    generator=None,
    num_hypotheses=256,
    sample_size=8,
    inlier_threshold=1e-4,
    sample_indices=None,
) -> RelativePose:
    """RANSAC 8-point essential + cheirality pose selection.

    (ref: robust_relative_pose, sfm/camera_relative_pose.cpp:94-157.)
    All hypotheses are estimated and scored in one batched call;
    threshold is squared Sampson distance in normalized coords.  The
    minimal samples are `sample_indices` ((num_hypotheses, sample_size)
    integers, used as given) or drawn from `generator`.
    """
    n = pts1.shape[-2]
    idx = _sample_indices(sample_indices, generator, n, num_hypotheses,
                          sample_size, None, pts1.device)

    es = eight_point_essential(pts1[idx], pts2[idx])  # (H, 3, 3)
    errors = sampson_error(es, pts1, pts2)  # (H, N)
    inliers = errors < inlier_threshold
    scores = inliers.sum(dim=-1)
    best = torch.argmax(scores)
    e_best = es[best]
    inl = inliers[best]

    # Refit on all inliers of the best model (weighted LSQ refit).
    weights = inl.to(pts1.dtype)
    e_refit = _weighted_essential(pts1, pts2, weights)
    err_refit = sampson_error(e_refit, pts1, pts2)
    inl_refit = err_refit < inlier_threshold
    use_refit = inl_refit.sum() >= inl.sum()
    e_final = torch.where(use_refit, e_refit, e_best)
    inl_final = torch.where(use_refit, inl_refit, inl)

    r, t = decompose_essential(e_final, pts1, pts2, inl_final)
    return RelativePose(
        rotation=r,
        translation=t,
        essential=e_final,
        inliers=inl_final,
        num_inliers=inl_final.sum(),
    )


def _weighted_essential(pts1, pts2, weights):
    a, t1, t2 = _essential_rows(pts1, pts2)
    aw = a * weights[..., None]
    return _essential_from_normal(aw.transpose(-1, -2) @ a, t1, t2)


def estimate_homography(pts1, pts2, weights=None):
    """Linear DLT homography (ref: sfm/homography.cpp capability)."""
    n1, t1 = _normalize_points(pts1)
    n2, t2 = _normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    row1 = torch.stack(
        [-x1, -y1, -one, zero, zero, zero, x2 * x1, x2 * y1, x2], dim=-1
    )
    row2 = torch.stack(
        [zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1
    )
    a = torch.cat([row1, row2], dim=-2)
    if weights is not None:
        w2 = torch.cat([weights, weights], dim=-1)
        a_w = a * w2[..., None]
    else:
        a_w = a
    ata = a_w.transpose(-1, -2) @ a
    h_vec = linalg.smallest_eigenvector(ata)
    h = h_vec.reshape(h_vec.shape[:-1] + (3, 3))
    h = inverse3(t2) @ h @ t1
    return h / h[..., 2:3, 2:3]


def homography_transfer_error(h, pts1, pts2):
    hp = torch.einsum("...ij,...nj->...ni", h, _homogeneous(pts1))
    proj = hp[..., :2] / torch.where(
        hp[..., 2:].abs() < 1e-12, 1e-12, hp[..., 2:]
    )
    return ((proj - pts2) ** 2).sum(dim=-1)


class ResectionPose(NamedTuple):
    rotation: torch.Tensor  # (3, 3) world-to-camera
    translation: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor


def reprojection_error_sq(r, t, points3d, points2d):
    """Squared reprojection error in normalized camera coords; points
    behind the camera score +inf (never inliers)."""
    pc = torch.einsum("...ij,...nj->...ni", r, points3d) + t[..., None, :]
    z = pc[..., 2]
    proj = pc[..., :2] / torch.where(z[..., None].abs() < 1e-12,
                                     1e-12, z[..., None])
    err = ((proj - points2d) ** 2).sum(dim=-1)
    return torch.where(z > 0, err, float("inf"))


def robust_resection_pose(
    points3d,
    points2d,
    generator=None,
    num_hypotheses=256,
    sample_size=6,
    inlier_threshold=1e-4,
    weights=None,
    sample_indices=None,
) -> ResectionPose:
    """RANSAC camera resection: hypothesis-parallel 6-point DLT minimal
    samples, reprojection-error inlier scoring, weighted refit on the
    winning consensus set.

    The reference's pose-from-known-points is ACRANSAC-robust
    (ref: src/mmSolver/sfm/camera_from_known_points.cpp:97-202, the
    ACRANSAC call at :129) — plain DLT (resection_pose) breaks under
    outlier correspondences; this is the robust equivalent, with every
    hypothesis estimated and scored in one batched call.

    weights, if given, mask the valid observations: zero-weight points
    are never sampled and never counted as inliers (fixed shapes, like
    robust_relative_pose).  The minimal samples are `sample_indices`
    ((num_hypotheses, sample_size) integers, used as given) or drawn
    from `generator` in proportion to the weights.
    """
    n = points3d.shape[-2]
    if weights is None:
        weights = torch.ones(n, dtype=points3d.dtype,
                             device=points3d.device)
    valid = weights > 0
    idx = _sample_indices(sample_indices, generator, n, num_hypotheses,
                          sample_size, weights, points3d.device)

    rs, ts = resection_pose(points3d[idx], points2d[idx])  # (H, 3, 3), (H, 3)
    errors = reprojection_error_sq(rs, ts, points3d, points2d)  # (H, N)
    inliers = (errors < inlier_threshold) & valid
    scores = inliers.sum(dim=-1)
    best = torch.argmax(scores)
    r_best, t_best, inl = rs[best], ts[best], inliers[best]

    # Weighted-DLT refit on the winning consensus set.
    w_refit = inl.to(points3d.dtype) * weights
    r_refit, t_refit = resection_pose(points3d, points2d,
                                      weights=w_refit)
    err_refit = reprojection_error_sq(r_refit, t_refit, points3d,
                                      points2d)
    inl_refit = (err_refit < inlier_threshold) & valid
    use_refit = inl_refit.sum() >= inl.sum()
    r_final = torch.where(use_refit, r_refit, r_best)
    t_final = torch.where(use_refit, t_refit, t_best)
    inl_final = torch.where(use_refit, inl_refit, inl)
    return ResectionPose(
        rotation=r_final,
        translation=t_final,
        inliers=inl_final,
        num_inliers=inl_final.sum(),
    )


def resection_pose(points3d, points2d, weights=None):
    """Camera pose from known 3D points (DLT + nearest-rotation),
    normalized 2D coords.  (ref: camera_from_known_points resection,
    sfm/camera_from_known_points.cpp.)

    weights, if given, mask/weight observations — pass the full padded
    point set with zero weights for missing data so the shapes stay
    fixed.  The leading axes of the three arguments broadcast: one point
    set resects many frames in one call.
    """
    lead = torch.broadcast_shapes(points3d.shape[:-1], points2d.shape[:-1])
    points3d = points3d.expand(lead + (3,))
    points2d = points2d.expand(lead + (2,))
    x, y, z = points3d[..., 0], points3d[..., 1], points3d[..., 2]
    u, v = points2d[..., 0], points2d[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row1 = torch.stack(
        [x, y, z, one, zero, zero, zero, zero,
         -u * x, -u * y, -u * z, -u],
        dim=-1,
    )
    row2 = torch.stack(
        [zero, zero, zero, zero, x, y, z, one,
         -v * x, -v * y, -v * z, -v],
        dim=-1,
    )
    a = torch.cat([row1, row2], dim=-2)  # (..., 2N, 12)
    if weights is not None:
        w2 = torch.cat([weights, weights], dim=-1)[..., None]
        a = a * w2
    ata = a.transpose(-1, -2) @ a
    p_vec = linalg.smallest_eigenvector(ata)
    p = p_vec.reshape(p_vec.shape[:-1] + (3, 4))
    m = p[..., :3]
    # Fix the sign so that points land in front of the camera.
    depths = torch.einsum("...ij,...nj->...ni", m, points3d)[..., 2] \
        + p[..., 2, 3][..., None]
    depth_votes = torch.sign(depths)
    if weights is not None:
        depth_votes = depth_votes * (weights > 0)
    sign = torch.sign(depth_votes.sum(dim=-1))
    sign = torch.where(sign == 0, 1.0, sign)
    p = p * sign[..., None, None]
    m = p[..., :3]
    scale = linalg.det3(m).abs().pow(1.0 / 3.0)
    m_n = m / scale[..., None, None]
    r = linalg.svd3_rotation(m_n)
    t = p[..., 3] / scale[..., None]
    return r, t
