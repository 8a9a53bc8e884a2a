"""Camera solve from scratch: incremental SfM bootstrap + BA refine.

Port of mayamatchmovesolver_tpu/sfm/camerasolve.py, the counterpart of
the reference's camera_solve pipeline
(ref: python/mmSolver/_api/solvercamerautils.py:958-1290):
  1. score frames by shared-marker connectivity (_compute_connected_
     frame_scores, solvercamerautils.py:135);
  2. robust relative pose between the best-connected frame pair
     (mmCameraRelativePose command -> our robust_relative_pose);
  3. triangulate bundles (solvercamerautils.py:690);
  4. resection the remaining frames from triangulated points;
  5. full bundle adjustment over all poses + bundles (our solver);
  6. origin-frame normalization (_set_camera_origin_frame,
     solvercamerautils.py:730).

Marker input is (M, F, 2) in the solver's [-0.5, 0.5] screen space plus
an (M, F) enable mask; intrinsics are focal length + film back.

Stages 1-4 run in float64 on the given device whatever the caller's
dtype (DLT null spaces of A^T A).  Poses and points stay on the device;
only the masks (enabled, solved, valid) live on the host, so the frame
loop reads nothing back: one read for the anchor pair's inliers and one
per refinement round for the bad-bundle filter.
"""

from typing import NamedTuple

import numpy as np
import torch

from mayamatchmovesolver_torch.sfm import twoview
from mayamatchmovesolver_torch.solver import linalg


class CameraSolveResult(NamedTuple):
    # Camera pose per frame: world-from-camera rotation + position, on
    # the device; the masks are numpy arrays on the host.
    rotations: torch.Tensor  # (F, 3, 3)
    positions: torch.Tensor  # (F, 3)
    points3d: torch.Tensor  # (M, 3)
    point_valid: np.ndarray  # (M,) bool
    frame_solved: np.ndarray  # (F,) bool


# The RANSAC sizes of the bootstrap: (hypotheses, sample size).
PAIR_DRAW = (128, 8)
FRAME_DRAW = (64, 6)


def seeded_sampler(frame, num_hypotheses, sample_size, weights):
    """The default draws of camera_solve: a CPU generator seeded 42 for
    the anchor pair (`frame` is None) and `frame` for the resection of
    frame `frame`, so a solve repeats on any device.  weights: (N,) host
    array, zero for a point that must not be drawn.  Returns
    (num_hypotheses, sample_size) indices."""
    generator = torch.Generator().manual_seed(
        42 if frame is None else int(frame)
    )
    return twoview.draw_samples(len(weights), num_hypotheses, sample_size,
                                generator, np.asarray(weights, np.float64))


def _tensor(values):
    """A tensor of its own from a tensor or anything numpy can read."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.as_tensor(np.array(values))


def _host_mask(mask):
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return np.asarray(mask) > 0.5


def markers_to_bearings(marker_xy, focal_length_mm, film_back_width_mm,
                        render_aspect):
    """Marker space [-0.5, 0.5] -> normalized CV-convention bearings.

    From the projection matrix derivation (core/camera.py, horizontal
    film fit): x_cam/(-z_cam) = marker_x * film_back_w / focal and
    y_cam/(-z_cam) = marker_y * film_back_w / (render_aspect * focal)
    (the y projection scale carries the image aspect; the film-fit
    marker scaling keeps observations in the same space).  The SfM math
    runs in the right-handed OpenCV frame (x right, y DOWN, z forward),
    hence the sign flip on v.

    Two input conventions are valid and give identical bearings under
    horizontal film fit: film-fit-scaled screen space paired with the
    true render aspect, or raw marker space paired with the film-back
    aspect (fbw/fbh) — because raw marker y is film-back-normalized
    (y_cam/(-z) = marker_y * fbh / focal).  Mixing them distorts the
    y bearings anisotropically.
    """
    u = marker_xy[..., 0] * film_back_width_mm / focal_length_mm
    v = -marker_xy[..., 1] * film_back_width_mm / (
        render_aspect * focal_length_mm
    )
    return torch.stack([u, v], dim=-1)


def connected_frame_scores(enable_mask):
    """(ref: _compute_connected_frame_scores,
    solvercamerautils.py:135) — per-frame count of enabled markers."""
    return np.asarray(enable_mask).sum(axis=0)


def best_frame_pair(enable_mask, min_separation=5):
    """Pick the pair of frames sharing the most markers with at least
    min_separation frames between them (baseline heuristic like the
    reference's start/end-frame choice).  Vectorized: the full F x F
    co-visibility matrix is one matmul, fine at 1000+ frames."""
    enable = (np.asarray(enable_mask) > 0.5).astype(np.float64)
    num_frames = enable.shape[1]
    shared = enable.T @ enable  # (F, F) co-visible marker counts
    sep = np.abs(np.arange(num_frames)[:, None] - np.arange(num_frames))
    shared = np.where(
        (sep >= min_separation) & (np.arange(num_frames)[:, None]
                                   < np.arange(num_frames)),
        shared, -1.0,
    )
    flat = int(np.argmax(shared))
    a, b = divmod(flat, num_frames)
    if shared[a, b] < 0:
        return (0, min(num_frames - 1, min_separation))
    return (int(a), int(b))


def triangulate_multiview(cam_r, cam_t, bearings, weights):
    """DLT triangulation of every marker from ALL solved frames at once.

    cam_r: (F, 3, 3) camera-from-world rotations, cam_t: (F, 3),
    bearings: (M, F, 2) normalized CV coords, weights: (M, F)
    observation weights (zero = unseen/unsolved).  Returns (M, 3) CV
    world points.  This is the per-bundle refinement the reference runs
    as _triangulate_bundles (ref: solvercamerautils.py:690) — here each
    bundle sees every camera simultaneously instead of a pair.
    """
    p = torch.cat([cam_r, cam_t[:, :, None]], dim=-1)  # (F, 3, 4)
    u = bearings[..., 0:1]
    v = bearings[..., 1:2]
    ra = u * p[None, :, 2] - p[None, :, 0]  # (M, F, 4)
    rb = v * p[None, :, 2] - p[None, :, 1]
    w = weights[..., None]
    rows = torch.cat([ra * w, rb * w], dim=1)  # (M, 2F, 4)
    ata = rows.transpose(-1, -2) @ rows
    x = linalg.smallest_eigenvector(ata)
    denom = torch.where(x[..., 3:].abs() < 1e-12, 1e-12, x[..., 3:])
    return x[..., :3] / denom


def reprojection_errors_cv(cam_r, cam_t, points3d, bearings):
    """Per-(marker, frame) bearing-space reprojection error + depth.

    Returns (error (M, F), depth (M, F)); depth <= 0 means behind the
    camera (CV convention: z forward)."""
    pc = (
        torch.einsum("fij,mj->mfi", cam_r, points3d) + cam_t[None]
    )  # (M, F, 3)
    depth = pc[..., 2]
    proj = pc[..., :2] / torch.where(
        depth[..., None].abs() < 1e-12, 1e-12, depth[..., None]
    )
    err = torch.linalg.vector_norm(proj - bearings, dim=-1)
    return err, depth


def filter_bad_bundles(
    cam_r, cam_t, points3d, bearings, enable, solved, valid,
    focal_length_mm=35.0, film_back_width_mm=36.0,
    image_width=1920.0, max_error_px=9.0,
):
    """Invalidate bundles with high reprojection error or observations
    behind the camera (ref: the bad-bundle filtering of camera_solve,
    solvercamerautils.py:182-227 — reprojection-error and
    behind-camera culls).  Poses, points and bearings are tensors, the
    three masks host arrays; returns the updated valid mask (one read
    of the errors and depths)."""
    err, depth = reprojection_errors_cv(cam_r, cam_t, points3d, bearings)
    err, depth = torch.stack([err, depth]).cpu().numpy()
    obs = np.asarray(enable, bool) & np.asarray(solved, bool)[None, :]
    # bearing error -> pixels: marker_x = u * focal/fbw; px = marker*W.
    err_px = err * (focal_length_mm / film_back_width_mm) * image_width
    n_obs = np.maximum(obs.sum(axis=1), 1)
    mean_err = np.where(obs, err_px, 0.0).sum(axis=1) / n_obs
    behind = np.any(obs & (depth <= 0.0), axis=1)
    ok = (mean_err <= max_error_px) & ~behind & (obs.sum(axis=1) >= 2)
    return np.asarray(valid, bool) & ok


def camera_solve(
    marker_xy,
    enable_mask,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    render_aspect=None,
    sampler=None,
    min_pair_separation=5,
    refine_rounds=2,
    image_width=1920.0,
    max_bundle_error_px=9.0,
    *,
    device,
) -> CameraSolveResult:
    """Incremental SfM over all frames on `device`; returns per-frame
    poses and triangulated points in an arbitrary (origin-normalized)
    scale.

    render_aspect defaults to the film-back aspect (square-pixel
    aspect-matched delivery, the common case).  sampler supplies the
    RANSAC draws of the anchor pair and of every frame's resection
    (seeded_sampler by default; see there for its arguments)."""
    f64 = dict(dtype=torch.float64, device=device)
    marker_xy = _tensor(marker_xy).to(**f64)
    enable = _host_mask(enable_mask)
    num_markers, num_frames = enable.shape
    if sampler is None:
        sampler = seeded_sampler
    if render_aspect is None:
        render_aspect = film_back_width_mm / film_back_height_mm

    def on_device(mask):
        return torch.as_tensor(np.ascontiguousarray(mask), device=device)

    bearings = markers_to_bearings(
        marker_xy, focal_length_mm, film_back_width_mm, render_aspect
    )  # (M, F, 2)

    f0, f1 = best_frame_pair(enable, min_pair_separation)
    shared = enable[:, f0] & enable[:, f1]
    if shared.sum() < 8:
        raise ValueError(
            "not enough shared markers (%d) between frames %d and %d"
            % (int(shared.sum()), f0, f1)
        )

    shared_idx = on_device(np.nonzero(shared)[0])
    pose = twoview.robust_relative_pose(
        bearings[shared_idx, f0],
        bearings[shared_idx, f1],
        num_hypotheses=PAIR_DRAW[0],
        sample_size=PAIR_DRAW[1],
        inlier_threshold=1e-5,
        sample_indices=sampler(None, *PAIR_DRAW,
                               np.ones(int(shared.sum()))),
    )

    # Camera-from-world per frame: frame f0 = identity.
    eye = torch.eye(3, **f64)
    cam_r = torch.zeros((num_frames, 3, 3), **f64)
    cam_t = torch.zeros((num_frames, 3), **f64)
    solved = np.zeros(num_frames, bool)
    cam_r[f0] = eye
    cam_r[f1] = pose.rotation
    cam_t[f1] = pose.translation
    solved[f0] = solved[f1] = True

    # Triangulate every marker seen in both anchor frames (full padded
    # set; invalid rows are masked out afterwards).
    valid = np.zeros(num_markers, bool)
    tri = twoview.triangulate_linear(
        eye, torch.zeros(3, **f64), pose.rotation, pose.translation,
        bearings[:, f0], bearings[:, f1],
    )
    pts3d = torch.where(on_device(shared)[:, None], tri,
                        torch.zeros_like(tri))
    valid[shared] = pose.inliers.cpu().numpy()

    # Incremental resection of remaining frames, most-connected first
    # (ref: _solve_relative_poses loop, solvercamerautils.py:574).
    # All calls use the full padded point set with zero weights for
    # missing observations.  Resection is RANSAC-robust like the
    # reference's ACRANSAC pose-from-known-points
    # (ref: camera_from_known_points.cpp:97-202): an outlier track or a
    # badly-triangulated bundle must not poison the frame's pose.
    order = np.argsort(-connected_frame_scores(enable & valid[:, None]))
    for f in order:
        if solved[f]:
            continue
        seen = enable[:, f] & valid
        if seen.sum() < 6:
            continue
        weights = seen.astype(np.float64)
        pose_f = twoview.robust_resection_pose(
            pts3d, bearings[:, f],
            num_hypotheses=FRAME_DRAW[0], sample_size=FRAME_DRAW[1],
            weights=on_device(weights), inlier_threshold=4e-4,
            sample_indices=sampler(int(f), *FRAME_DRAW, weights),
        )
        cam_r[f] = pose_f.rotation
        cam_t[f] = pose_f.translation
        solved[f] = True

        # Triangulate new points against the anchor frame.
        new = enable[:, f] & enable[:, f0] & ~valid
        if new.sum() > 0:
            tri = twoview.triangulate_linear(
                eye, torch.zeros(3, **f64), cam_r[f], cam_t[f],
                bearings[:, f0], bearings[:, f],
            )
            pts3d = torch.where(on_device(new)[:, None], tri, pts3d)
            valid[new] = True

    # Refinement rounds (ref: the reference iterates relative poses,
    # per-bundle adjusts, filters bad bundles and triangulates more,
    # solvercamerautils.py:574-726): multi-view retriangulation of every
    # marker seen from >= 2 solved frames, bad-bundle culling, then
    # re-resection of all frames (including previously unsolvable ones)
    # from the improved structure.
    for _ in range(max(int(refine_rounds), 0)):
        obs = enable & solved[None, :]  # (M, F)
        seen2 = obs.sum(axis=1) >= 2
        if not seen2.any():
            break
        w = (obs & seen2[:, None]).astype(np.float64)
        tri = triangulate_multiview(cam_r, cam_t, bearings, on_device(w))
        pts3d = torch.where(on_device(seen2)[:, None], tri, pts3d)
        valid = valid | seen2
        valid = filter_bad_bundles(
            cam_r, cam_t, pts3d, bearings, enable, solved, valid,
            focal_length_mm=focal_length_mm,
            film_back_width_mm=film_back_width_mm,
            image_width=image_width,
            max_error_px=max_bundle_error_px,
        )
        if valid.sum() < 6:
            # Over-aggressive cull (e.g. very noisy input): keep the
            # pre-cull structure rather than collapse the solve.
            valid = valid | seen2
        # Re-resect every frame from the refined, filtered structure —
        # one batched resection over the frame axis.
        seen_f = enable & valid[:, None]  # (M, F)
        resectable = seen_f.sum(axis=0) >= 6
        rs, ts = twoview.resection_pose(
            pts3d, bearings.transpose(0, 1),
            weights=on_device(seen_f.T.astype(np.float64)),
        )
        pick = on_device(resectable)
        cam_r = torch.where(pick[:, None, None], rs, cam_r)
        cam_t = torch.where(pick[:, None], ts, cam_t)
        solved = solved | resectable

    # Convert from the CV frame back to the Maya camera convention.
    # With S = diag(1,-1,-1) mapping CV camera axes (y down, z forward)
    # to Maya camera axes (y up, z backward):
    #   maya camera world rotation R_m = S R_cv^T S
    #   maya camera position       c_m = S (-R_cv^T t_cv)
    #   maya world points          p_m = S p_cv
    s = torch.diag(torch.tensor([1.0, -1.0, -1.0], **f64))
    centers = -torch.einsum("fji,fj->fi", cam_r, cam_t)
    world_r = torch.einsum(
        "ij,fkj,kl->fil", s, cam_r, s
    )  # S @ R_cv^T @ S
    world_t = centers @ s.T
    points_m = pts3d @ s.T

    return CameraSolveResult(
        rotations=world_r,
        positions=world_t,
        points3d=points_m,
        point_valid=valid,
        frame_solved=solved,
    )


def refine_with_bundle_adjustment(
    result: CameraSolveResult,
    marker_xy,
    enable_mask,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    render_aspect=None,
    image_width=1920.0,
    max_iterations=25,
    solve_focal=False,
    dtype=None,
):
    """Full BA polish of the incremental SfM result — the reference's
    final per-bundle + global bundle-adjust passes
    (ref: _bundle_adjust, solvercamerautils.py:380) via our structured
    Schur solver, on the result's device in `dtype` (marker_xy's when
    None).

    Returns (refined CameraSolveResult, BAResult).
    """
    from mayamatchmovesolver_torch.core.transform import (
        euler_to_rotation_matrix,
        matrix_to_euler,
    )
    from mayamatchmovesolver_torch.solver import ba

    if render_aspect is None:
        render_aspect = film_back_width_mm / film_back_height_mm

    device = result.rotations.device
    marker_xy = _tensor(marker_xy).to(device=device)
    if dtype is not None:
        marker_xy = marker_xy.to(dtype)
    enable = _host_mask(enable_mask)
    num_markers, num_frames = enable.shape
    # Camera params: tx ty tz rx ry rz from the recovered poses.
    eulers = matrix_to_euler(result.rotations, 0)
    cam_params = torch.cat([result.positions, eulers], dim=-1)

    weight = enable.astype(np.float64) * result.point_valid[:, None]
    problem = ba.make_ba_problem(
        marker_uv=marker_xy,
        weight=weight,
        mkr_bnd_index=np.arange(num_markers),
        cam_params=cam_params,
        bnd_params=result.points3d,
        focal_length_mm=focal_length_mm,
        film_back_width_mm=film_back_width_mm,
        film_back_height_mm=film_back_height_mm,
        render_width=int(image_width),
        render_height=int(round(image_width / render_aspect)),
        image_width=image_width,
        solve_focal=solve_focal,
        device=device,
    )
    ba_result = ba.solve_ba(problem, max_iterations=max_iterations)

    cam_out = ba_result.cam_params
    rotations = euler_to_rotation_matrix(
        cam_out[:, 3], cam_out[:, 4], cam_out[:, 5],
        torch.zeros(num_frames, dtype=torch.int64, device=device),
    )
    refined = CameraSolveResult(
        rotations=rotations,
        positions=cam_out[:, :3],
        points3d=ba_result.bnd_params,
        point_valid=result.point_valid,
        frame_solved=result.frame_solved,
    )
    return refined, ba_result


def camera_solve_full(
    marker_xy,
    enable_mask,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    render_aspect=None,
    image_width=1920.0,
    solve_focal=False,
    sampler=None,
    min_pair_separation=5,
    refine_rounds=2,
    max_bundle_error_px=9.0,
    ba_iterations=50,
    origin_frame=0,
    scene_scale=1.0,
    *,
    device,
    dtype=None,
):
    """The complete from-scratch camera solve on `device`: incremental
    SfM (float64), bad-bundle filtering, global bundle adjustment in
    `dtype` (marker_xy's when None; optionally solving focal length), and
    origin-frame normalization — the counterpart of the reference's
    camera_solve routine
    (ref: python/mmSolver/_api/solvercamerautils.py:958-1290).

    Returns (CameraSolveResult, BAResult, solved_focal_length_mm).

    Focal solving (ref: the focal attrs passed into _bundle_adjust,
    solvercamerautils.py:380-520): ONE shared focal parameter is freed
    in the BA's arrowhead border in a first pass (a matchmove shot has
    one physical lens — the reference's static-attribute semantics),
    then a fixed-focal BA polishes poses and structure at the solved
    value.
    """
    enable = _host_mask(enable_mask)
    result = camera_solve(
        marker_xy, enable,
        focal_length_mm=focal_length_mm,
        film_back_width_mm=film_back_width_mm,
        film_back_height_mm=film_back_height_mm,
        render_aspect=render_aspect,
        sampler=sampler,
        min_pair_separation=min_pair_separation,
        refine_rounds=refine_rounds,
        image_width=image_width,
        max_bundle_error_px=max_bundle_error_px,
        device=device,
    )
    focal = float(focal_length_mm)
    ba_kwargs = dict(
        film_back_width_mm=film_back_width_mm,
        film_back_height_mm=film_back_height_mm,
        render_aspect=render_aspect,
        image_width=image_width,
        max_iterations=ba_iterations,
        dtype=dtype,
    )
    if solve_focal:
        result, ba_result = refine_with_bundle_adjustment(
            result, marker_xy, enable, focal_length_mm=focal,
            solve_focal=True, **ba_kwargs,
        )
        # solve_focal puts ONE focal in the BA border (the reference's
        # static-attribute semantics) — read it back directly.
        focal = float(ba_result.shared_params[0])
    refined, ba_result = refine_with_bundle_adjustment(
        result, marker_xy, enable, focal_length_mm=focal,
        solve_focal=False, **ba_kwargs,
    )
    refined = set_origin_frame(
        refined, origin_frame=origin_frame, scene_scale=scene_scale
    )
    return refined, ba_result, focal


def set_origin_frame(result: CameraSolveResult, origin_frame=0,
                     scene_scale=1.0) -> CameraSolveResult:
    """Normalize so the origin frame's camera sits at the world origin
    with identity orientation, and scale the scene
    (ref: _set_camera_origin_frame, solvercamerautils.py:730)."""
    r0_inv = result.rotations[origin_frame].T
    p0 = result.positions[origin_frame]
    return result._replace(
        rotations=r0_inv @ result.rotations,
        positions=(result.positions - p0) @ r0_inv.T * scene_scale,
        points3d=(result.points3d - p0) @ r0_inv.T * scene_scale,
    )
