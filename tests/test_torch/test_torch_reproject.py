"""Agreement of the port's reprojection (core/reprojection.py and
utils/reproject.py) with the JAX package's, at 1e-10 in float64.

Seeded cameras over all six rotate orders and every film fit, points
broadcast against several frames; then the reference's check that the
batch reprojection equals the scene engine
(tests/test_core/test_line_reproject.py::test_reproject_matches_scene_engine),
on the port's SceneGraph and evaluate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.core.camera as t_camera
import mayamatchmovesolver_torch.core.reprojection as t_reprojection
import mayamatchmovesolver_torch.utils.reproject as t_reproject
import mayamatchmovesolver_tpu.core.camera as j_camera
import mayamatchmovesolver_tpu.core.reprojection as j_reprojection
import mayamatchmovesolver_tpu.utils.reproject as j_reproject
from _torch_port_cases import to_numpy
from mayamatchmovesolver_tpu.core.constants import FilmFit, RotateOrder

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras(seed, frames=4):
    """Per-frame TRS channels of a camera near z=10 looking at the
    origin, and 5 points near the origin."""
    rng = np.random.RandomState(seed)
    trs = [rng.uniform(-1, 1, frames), rng.uniform(-1, 1, frames),
           rng.uniform(9, 11, frames)] + [rng.uniform(-15, 15, frames)
                                          for _ in range(3)]
    points = rng.uniform(-2, 2, (5, 3))
    return trs, points


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize("order", list(RotateOrder), ids=lambda o: o.name)
def test_camera_world_matrix_from_trs_matches(order):
    trs, _ = _cameras(int(order))
    want = j_reproject.camera_world_matrix_from_trs(
        *[jnp.asarray(c) for c in trs], rotate_order=int(order))
    got = t_reproject.camera_world_matrix_from_trs(
        *[_t(c) for c in trs], rotate_order=int(order))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("space", ["marker", "normalized", "pixels"])
@pytest.mark.parametrize("fit", list(FilmFit), ids=lambda f: f.name)
@pytest.mark.parametrize("order", list(RotateOrder), ids=lambda o: o.name)
def test_reproject_points_matches(order, fit, space):
    trs, points = _cameras(10 + int(order))
    kwargs = dict(focal_length_mm=42.0, film_back_width_mm=24.0,
                  film_back_height_mm=18.0, film_offset_x_mm=0.3,
                  film_offset_y_mm=-0.2, render_width=1000,
                  render_height=800, film_fit=fit,
                  as_pixels=space == "pixels",
                  as_normalized=space == "normalized")
    j_world = j_reproject.camera_world_matrix_from_trs(
        *[jnp.asarray(c) for c in trs], rotate_order=int(order))
    want = j_reproject.reproject_points(
        jnp.asarray(points)[:, None, :], j_world[None], **kwargs)
    t_world = t_reproject.camera_world_matrix_from_trs(
        *[_t(c) for c in trs], rotate_order=int(order))
    got = t_reproject.reproject_points(_t(points)[:, None, :],
                                       t_world[None], **kwargs)
    assert got.shape == (5, 4, 2) and got.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("order", list(RotateOrder), ids=lambda o: o.name)
def test_core_reprojection_matches(order):
    trs, points = _cameras(20 + int(order))
    proj_args = (35.0, 36.0 / 25.4, 24.0 / 25.4, 0.01, -0.02, 1920.0,
                 1080.0, int(FilmFit.HORIZONTAL), 0.1, 10000.0, 1.0)
    j_proj = j_camera.projection_matrix(*proj_args)
    t_proj = t_camera.projection_matrix(
        *[_t(v) for v in proj_args[:7]],
        torch.as_tensor(proj_args[7]), *proj_args[8:])
    j_inv = j_reprojection.camera_inverse(
        j_reproject.camera_world_matrix_from_trs(
            *[jnp.asarray(c) for c in trs], rotate_order=int(order)))
    t_inv = t_reprojection.camera_inverse(
        t_reproject.camera_world_matrix_from_trs(
            *[_t(c) for c in trs], rotate_order=int(order)))
    np.testing.assert_allclose(to_numpy(t_inv), np.asarray(j_inv), rtol=0,
                               atol=TOL)
    j_pts, t_pts = jnp.asarray(points)[:, None], _t(points)[:, None]
    for name in ("reproject_homogeneous", "reproject",
                 "reproject_as_normalized_coord"):
        want = getattr(j_reprojection, name)(j_proj, j_inv, j_pts)
        got = getattr(t_reprojection, name)(t_proj, t_inv, t_pts)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=name)


def test_reproject_matches_scene_engine():
    """The reference's case, on the port: utils.reproject must agree
    with the scene evaluator."""
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate

    sg = SceneGraph(frame_range=(1, 1))
    cam = sg.create_camera(
        "cam", tx=1.0, ty=0.5, tz=9.0, ry=12.0,
        film_fit=FilmFit.HORIZONTAL,
        render_width=1920, render_height=1080,
    )
    bnd = sg.create_bundle("b", tx=0.4, ty=-0.2, tz=-4.0)
    sg.create_marker("m", camera=cam, bundle=bnd)
    scene, attrs = sg.bake(device="cpu")
    ev = evaluate(scene, attrs, torch.as_tensor([0]))

    cam_world = t_reproject.camera_world_matrix_from_trs(
        *[_t(v) for v in (1.0, 0.5, 9.0, 0.0, 12.0, 0.0)])
    xy = t_reproject.reproject_points(
        _t([0.4, -0.2, -4.0]), cam_world,
        render_width=1920, render_height=1080,
        film_fit=FilmFit.HORIZONTAL,
    )
    np.testing.assert_allclose(
        to_numpy(xy), to_numpy(ev.point_xy[0, 0]), atol=1e-12
    )
    px = t_reproject.reproject_points(
        _t([0.4, -0.2, -4.0]), cam_world,
        render_width=1920, render_height=1080,
        film_fit=FilmFit.HORIZONTAL, as_pixels=True,
    )
    np.testing.assert_allclose(
        to_numpy(px),
        (to_numpy(ev.point_xy[0, 0]) + 0.5) * [1920, 1080],
        atol=1e-9,
    )
