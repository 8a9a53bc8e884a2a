"""Agreement of the port's from-scratch camera solve with the JAX
package, float64 on the CPU, on the shot of
tests/test_solver/test_camera_solver.py (16 frames x 24 points) with
holes in its tracks.

The building blocks agree at 1e-10.  camera_solve is fed the JAX
package's own RANSAC draws (`jax_sampler`) and must solve the same
frames and keep the same points, with poses and points at 1e-6 (measured
2e-10).  camera_solve_full frees every camera and bundle in its BA, so
its result is defined up to scale even after set_origin_frame: focal at
1e-6 relative, equal iterations and stop reason, rotations, and
positions and points divided by the camera path's length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.sfm.camerasolve as t_cs
import mayamatchmovesolver_tpu.sfm.camerasolve as j_cs
from _torch_port_cases import camera_shot_tracks, jax_sampler, to_numpy

TOL = 1e-10
KW = dict(focal_length_mm=35.0, render_aspect=1.5, image_width=1500.0,
          refine_rounds=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shot():
    """Tracks and an enable mask with holes: marker 0 ends at frame 7,
    marker 1 starts at frame 8, marker 2 is seen on frames 0-4 only (so
    it is in no anchor pair and is triangulated during the frame loop)."""
    tracks, _ = camera_shot_tracks()
    enable = np.ones(tracks.shape[:2], bool)
    enable[0, 8:] = False
    enable[1, :8] = False
    enable[2, 5:] = False
    return tracks, enable


@pytest.fixture(scope="module")
def bootstraps(shot):
    tracks, enable = shot
    want = j_cs.camera_solve(tracks, enable, **KW)
    got = t_cs.camera_solve(tracks, enable, sampler=jax_sampler,
                            device="cpu", **KW)
    return want, got


def test_markers_to_bearings_matches(shot):
    tracks, _ = shot
    want = j_cs.markers_to_bearings(jnp.asarray(tracks), 35.0, 36.0, 1.5)
    got = t_cs.markers_to_bearings(torch.as_tensor(np.array(tracks)), 35.0,
                                   36.0, 1.5)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-14)


@pytest.mark.parametrize("separation", [5, 3, 40])
def test_best_frame_pair_and_scores_match(shot, separation):
    _, enable = shot
    assert t_cs.best_frame_pair(enable, separation) == j_cs.best_frame_pair(
        enable, separation)
    np.testing.assert_array_equal(t_cs.connected_frame_scores(enable),
                                  j_cs.connected_frame_scores(enable))
    if separation == 40:  # no pair that far apart: the fallback
        assert t_cs.best_frame_pair(enable, separation) == (0, 15)


def _poses_and_points(seed=2, frames=6, markers=10):
    rng = np.random.RandomState(seed)
    from mayamatchmovesolver_tpu.core.transform import (
        euler_to_rotation_matrix,
    )
    cam_r = np.array(euler_to_rotation_matrix(
        jnp.asarray(rng.uniform(-3, 3, frames)),
        jnp.asarray(np.linspace(0, -15, frames)),
        jnp.asarray(rng.uniform(-2, 2, frames)), 0))
    cam_t = np.stack([np.linspace(0, -3, frames),
                      rng.uniform(-0.2, 0.2, frames),
                      rng.uniform(-0.3, 0.3, frames)], -1)
    x = np.stack([rng.uniform(-2, 2, markers), rng.uniform(-1, 1, markers),
                  rng.uniform(5, 9, markers)], -1)
    pc = np.einsum("fij,mj->mfi", cam_r, x) + cam_t[None]
    bearings = pc[..., :2] / pc[..., 2:]
    weights = (rng.uniform(size=(markers, frames)) > 0.2).astype(np.float64)
    weights[:, :2] = 1.0
    return cam_r, cam_t, x, bearings, weights


def test_triangulate_multiview_matches_and_recovers_the_points():
    cam_r, cam_t, x, bearings, weights = _poses_and_points()
    args = (cam_r, cam_t, bearings, weights)
    want = j_cs.triangulate_multiview(*[jnp.asarray(a) for a in args])
    got = t_cs.triangulate_multiview(*[torch.as_tensor(a) for a in args])
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(to_numpy(got), x, atol=1e-8)


def test_reprojection_errors_and_filter_bad_bundles_match():
    cam_r, cam_t, x, bearings, weights = _poses_and_points(3)
    x = x.copy()
    x[1] += 0.4  # a bundle off its tracks: culled by its error
    x[2, 2] = -3.0  # a bundle behind the cameras
    enable = weights > 0
    enable[3, 1:] = False  # seen from one solved frame only
    solved = np.array([True, True, True, False, True, True])
    valid = np.ones(len(x), bool)
    valid[4] = False
    args = (cam_r, cam_t, x, bearings)
    j_err, j_depth = j_cs.reprojection_errors_cv(
        *[jnp.asarray(a) for a in args])
    t_err, t_depth = t_cs.reprojection_errors_cv(
        *[torch.as_tensor(a) for a in args])
    np.testing.assert_allclose(to_numpy(t_err), np.asarray(j_err), atol=TOL)
    np.testing.assert_allclose(to_numpy(t_depth), np.asarray(j_depth),
                               atol=TOL)
    kw = dict(focal_length_mm=35.0, image_width=1500.0, max_error_px=9.0)
    want = j_cs.filter_bad_bundles(*args, enable, solved, valid, **kw)
    got = t_cs.filter_bad_bundles(*[torch.as_tensor(a) for a in args],
                                  enable, solved, valid, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert not got[[1, 2, 3, 4]].any() and got[[0, 5, 6]].all()


def test_set_origin_frame_matches():
    cam_r, cam_t, x, _, _ = _poses_and_points(4)
    masks = (np.ones(len(x), bool), np.ones(len(cam_r), bool))
    want = j_cs.set_origin_frame(
        j_cs.CameraSolveResult(cam_r, cam_t, x, *masks), origin_frame=2,
        scene_scale=2.5)
    got = t_cs.set_origin_frame(
        t_cs.CameraSolveResult(torch.as_tensor(cam_r), torch.as_tensor(cam_t),
                               torch.as_tensor(x), *masks),
        origin_frame=2, scene_scale=2.5)
    for field in ("rotations", "positions", "points3d"):
        np.testing.assert_allclose(to_numpy(getattr(got, field)),
                                   getattr(want, field), atol=TOL,
                                   err_msg=field)
    np.testing.assert_allclose(to_numpy(got.rotations[2]), np.eye(3),
                               atol=1e-12)
    assert float(got.positions[2].abs().max()) == 0.0
    assert got.point_valid is masks[0] and got.frame_solved is masks[1]


def test_camera_solve_with_the_jax_draws_matches(bootstraps):
    want, got = bootstraps
    np.testing.assert_array_equal(got.frame_solved, want.frame_solved)
    np.testing.assert_array_equal(got.point_valid, want.point_valid)
    assert got.frame_solved.all() and got.point_valid[:3].all()
    assert got.point_valid.sum() >= 20
    assert got.rotations.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got.rotations), want.rotations,
                               atol=1e-6)
    np.testing.assert_allclose(to_numpy(got.positions), want.positions,
                               atol=1e-6)
    valid = want.point_valid
    np.testing.assert_allclose(to_numpy(got.points3d)[valid],
                               want.points3d[valid], atol=1e-6)


def test_camera_solve_repeats_with_its_own_draws_and_takes_float32(shot):
    """The default sampler seeds a generator per stage, so a solve
    repeats; the bootstrap is float64 whatever the tracks' dtype."""
    tracks, enable = shot
    runs = [t_cs.camera_solve(torch.as_tensor(tracks.astype(np.float32)),
                              enable, device="cpu", **KW) for _ in range(2)]
    assert runs[0].rotations.dtype == torch.float64
    assert torch.equal(runs[0].rotations, runs[1].rotations)
    assert torch.equal(runs[0].points3d, runs[1].points3d)
    assert runs[0].frame_solved.all()
    with pytest.raises(ValueError, match="not enough shared markers"):
        t_cs.camera_solve(tracks[:7], enable[:7], device="cpu", **KW)


def _gauge_free(result, origin):
    """Rotations, and positions and points over the camera path's
    length: what a similarity-free BA leaves defined once the origin
    frame is fixed."""
    positions = to_numpy(result.positions)
    length = np.linalg.norm(positions[-1] - positions[origin])
    return (to_numpy(result.rotations), positions / length,
            to_numpy(result.points3d) / length)


@pytest.mark.parametrize("solve_focal", [False, True])
def test_camera_solve_full_matches(shot, bootstraps, monkeypatch,
                                   solve_focal):
    """The whole solve: the bootstraps of the fixture (the JAX package's
    is served to its camera_solve_full in place of a second identical
    run), then each package's own BA passes and origin frame."""
    tracks, enable = shot
    monkeypatch.setattr(j_cs, "camera_solve", lambda *a, **k: bootstraps[0])
    kw = dict(KW, solve_focal=solve_focal, ba_iterations=20, origin_frame=3)
    want, j_ba, j_focal = j_cs.camera_solve_full(tracks, enable, **kw)
    got, t_ba, t_focal = t_cs.camera_solve_full(
        tracks, enable, sampler=jax_sampler, device="cpu", **kw)
    assert isinstance(t_focal, float)
    assert abs(t_focal - j_focal) <= 1e-6 * j_focal
    if solve_focal:
        assert abs(t_focal - 40.0) < 1e-3  # the truth, from a guess of 35
    else:
        assert t_focal == 35.0
    assert int(t_ba.iterations) == int(j_ba.iterations)
    assert int(t_ba.stop_reason) == int(j_ba.stop_reason)
    np.testing.assert_allclose(float(t_ba.cost), float(j_ba.cost),
                               rtol=1e-6, atol=1e-18)
    np.testing.assert_array_equal(got.frame_solved, want.frame_solved)
    np.testing.assert_array_equal(got.point_valid, want.point_valid)
    valid = want.point_valid
    for g, w, name in zip(_gauge_free(got, 3), _gauge_free(want, 3),
                          ("rotations", "positions", "points3d")):
        if name == "points3d":
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(to_numpy(got.rotations[3]), np.eye(3),
                               atol=1e-9)


def test_camera_solve_full_runs_its_ba_in_the_dtype_asked(shot):
    """dtype= is the BA's; the bootstrap before it stays float64.  (What
    a float32 BA with every camera and bundle free reaches is not held
    here: its Cholesky step can break down, stop reason 5.)"""
    tracks, enable = shot
    got, ba_result, focal = t_cs.camera_solve_full(
        tracks, enable, solve_focal=False, ba_iterations=3, device="cpu",
        dtype=torch.float32, **KW)
    assert ba_result.cam_params.dtype == torch.float32
    assert got.positions.dtype == torch.float32
    assert got.points3d.dtype == torch.float32
    assert focal == 35.0 and bool(got.rotations.isfinite().all())
