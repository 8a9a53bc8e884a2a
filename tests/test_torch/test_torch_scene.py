"""Agreement of the torch port's scene evaluation with the JAX package.

The same scene, built from numpy seeds in both packages, must evaluate
to the same SceneEval in float64 (the conftest turns on JAX x64).
Tolerance 1e-10: both sides run the same f64 arithmetic in a different
operation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.core.camera as t_camera
import mayamatchmovesolver_torch.core.transform as t_transform
import mayamatchmovesolver_torch.scene as t_scene
import mayamatchmovesolver_tpu.core.camera as j_camera
import mayamatchmovesolver_tpu.core.transform as j_transform
import mayamatchmovesolver_tpu.scene as j_scene
from _torch_port_cases import rich_scene, to_numpy
from mayamatchmovesolver_torch.scene.flatscene import (
    set_marker_screen_positions as t_set_markers,
)
from mayamatchmovesolver_tpu.core.constants import FilmFit, RotateOrder
from mayamatchmovesolver_tpu.scene.flatscene import evaluate_jit as j_evaluate
from mayamatchmovesolver_tpu.scene.flatscene import (
    set_marker_screen_positions as j_set_markers,
)

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    return rich_scene("jax"), rich_scene("torch")


@pytest.fixture(scope="module")
def evals(scenes):
    (_, j_sc, j_at, _, _), (_, t_sc, t_at, _, _) = scenes
    n = j_at.num_frames
    return (
        j_evaluate(j_sc, j_at, jnp.arange(n)),
        t_scene.evaluate(t_sc, t_at, torch.arange(n)),
    )


@pytest.mark.parametrize("order", list(RotateOrder))
def test_trs_matrix_each_rotate_order(order):
    rng = np.random.RandomState(int(order))
    v = rng.uniform(-90, 90, (9, 5))
    v[6:] = rng.uniform(0.5, 2.0, (3, 5))
    j = j_transform.trs_matrix(*[jnp.asarray(x) for x in v], int(order))
    t = t_transform.trs_matrix(
        *[torch.as_tensor(x) for x in v], torch.tensor(int(order)))
    np.testing.assert_allclose(to_numpy(t), np.asarray(j), atol=ATOL)
    np.testing.assert_allclose(
        to_numpy(t_transform.affine_inverse(t)),
        np.asarray(j_transform.affine_inverse(j)), atol=ATOL)


@pytest.mark.parametrize("fit", list(FilmFit))
def test_projection_matrix_each_film_fit(fit):
    rng = np.random.RandomState(10 + int(fit))
    focal, fbw, fbh = rng.uniform(20, 80, 3), rng.uniform(0.8, 1.5, 3), \
        rng.uniform(0.5, 1.0, 3)
    offx, offy = rng.uniform(-0.1, 0.1, 3), rng.uniform(-0.1, 0.1, 3)
    args = (focal, fbw, fbh, offx, offy, 1920.0, 1080.0)
    j = j_camera.projection_matrix(
        *[jnp.asarray(a) for a in args], int(fit), 0.1, 1e4, 1.0)
    t = t_camera.projection_matrix(
        *[torch.as_tensor(a) for a in args], torch.tensor(int(fit)),
        0.1, torch.tensor(1e4), 1.0)
    np.testing.assert_allclose(to_numpy(t), np.asarray(j), atol=ATOL)
    js = j_camera.marker_film_fit_scale(int(fit), fbw / fbh, 1920 / 1080)
    ts = t_camera.marker_film_fit_scale(
        torch.tensor(int(fit)), torch.as_tensor(fbw / fbh),
        torch.tensor(1920 / 1080))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("field", j_scene.SceneEval._fields)
def test_scene_eval_field_matches(evals, field):
    j_ev, t_ev = evals
    got, want = to_numpy(getattr(t_ev, field)), np.asarray(
        getattr(j_ev, field))
    assert got.shape == want.shape
    if field == "behind_camera":
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_scene_covers_what_it_claims(scenes):
    (_, j_sc, _, _, _), (_, t_sc, _, _, _) = scenes
    assert t_sc.doubling_steps == j_sc.doubling_steps == 2
    assert set(np.asarray(j_sc.tfm_rotate_order)) == set(range(6))
    assert len(set(np.asarray(j_sc.cam_film_fit))) == 2
    assert np.all(np.asarray(j_sc.mkr_attr_codes)[1::2, 4:] >= 0)


def test_evaluate_frame_subset(scenes):
    (_, j_sc, j_at, _, _), (_, t_sc, t_at, _, _) = scenes
    frames = np.array([3, 1])
    j_ev = j_evaluate(j_sc, j_at, jnp.asarray(frames))
    t_ev = t_scene.evaluate(t_sc, t_at, torch.as_tensor(frames))
    np.testing.assert_allclose(
        to_numpy(t_ev.point_xy), np.asarray(j_ev.point_xy), atol=ATOL)


def test_set_marker_screen_positions_matches(scenes):
    (_, j_sc, j_at, _, _), (_, t_sc, t_at, _, _) = scenes
    n = j_at.num_frames
    rng = np.random.RandomState(3)
    xy = rng.uniform(-0.4, 0.4, (j_sc.num_markers, n, 2))
    j_new = j_set_markers(j_sc, j_at, jnp.arange(n), jnp.asarray(xy))
    t_new = t_set_markers(t_sc, t_at, torch.arange(n), torch.as_tensor(xy))
    np.testing.assert_allclose(
        to_numpy(t_new.anim_values), np.asarray(j_new.anim_values),
        atol=ATOL)
    np.testing.assert_allclose(
        to_numpy(t_new.static_values), np.asarray(j_new.static_values),
        atol=ATOL)
    ev = t_scene.evaluate(t_sc, t_new, torch.arange(n))
    np.testing.assert_allclose(to_numpy(ev.marker_xy), xy, atol=ATOL)
