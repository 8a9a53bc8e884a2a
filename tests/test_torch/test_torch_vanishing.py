"""Agreement of the port's vanishing-point calibration with the JAX
package: every function of sfm/vanishing.py, both scene-scale modes and
the invalid-pair fallback, at 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.sfm.vanishing as t_van
import mayamatchmovesolver_tpu.sfm.vanishing as j_van
from _torch_port_cases import to_numpy

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(seed=0, n=4):
    """A batch of configurations: vanishing points on either side of the
    principal point (valid), origin, principal point and a horizon."""
    rng = np.random.RandomState(seed)
    return dict(
        vp_a=np.stack([rng.uniform(0.6, 1.5, n),
                       rng.uniform(-0.1, 0.2, n)], -1),
        vp_b=np.stack([rng.uniform(-1.5, -0.6, n),
                       rng.uniform(-0.1, 0.2, n)], -1),
        principal=rng.uniform(-0.02, 0.02, (n, 2)),
        origin=rng.uniform(-0.2, 0.2, (n, 2)),
        horizon_a=np.stack([np.full(n, -0.5), rng.uniform(0.0, 0.1, n)], -1),
        horizon_b=np.stack([np.full(n, 0.5), rng.uniform(0.0, 0.1, n)], -1),
        focal=rng.uniform(0.8, 2.5, n),
    )


def _both(name, *keys, extra=()):
    p = _points()
    j_out = getattr(j_van, name)(*[jnp.asarray(p[k]) for k in keys], *extra)
    t_out = getattr(t_van, name)(*[torch.as_tensor(p[k]) for k in keys],
                                 *extra)
    return j_out, t_out


def _assert_same(t_out, j_out):
    if not isinstance(j_out, tuple):
        t_out, j_out = (t_out,), (j_out,)
    assert len(t_out) == len(j_out)
    for g, w in zip(t_out, j_out):
        w = np.asarray(w)
        assert to_numpy(g).shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(to_numpy(g), w)
        else:
            np.testing.assert_allclose(to_numpy(g), w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name, keys", [
    ("focal_length_from_two_vanishing_points",
     ("vp_a", "vp_b", "principal")),
    ("rotation_from_two_vanishing_points",
     ("vp_a", "vp_b", "principal", "focal")),
    ("second_vanishing_point_from_horizon",
     ("vp_a", "principal", "horizon_a", "horizon_b", "focal")),
    ("translation_from_origin_point", ("origin", "principal", "focal")),
])
def test_building_blocks_match(name, keys):
    j_out, t_out = _both(name, *keys)
    _assert_same(t_out, j_out)


@pytest.mark.parametrize("mode", list(t_van.SceneScaleMode))
def test_apply_scene_scale_matches(mode):
    t = np.random.RandomState(1).uniform(-2, 2, (5, 3))
    want = j_van.apply_scene_scale(jnp.asarray(t), int(mode), 2.5)
    got = t_van.apply_scene_scale(torch.as_tensor(t), mode, 2.5)
    _assert_same(got, want)
    with pytest.raises(ValueError, match="invalid SceneScaleMode"):
        t_van.apply_scene_scale(torch.as_tensor(t), 7, 1.0)


def _calibrate(pkg, which, p, mode, conv):
    args = (36.0, 24.0, conv(p["origin"]), conv(p["principal"]),
            conv(p["vp_a"]))
    if which == "two":
        return pkg.calibrate_two_vanishing_points(
            35.0, *args, conv(p["vp_b"]), scene_scale_mode=int(mode),
            scene_scale_distance_cm=1.7)
    # With one vanishing point the focal length is the user's: a batch of
    # points takes a focal length each (a scalar serves one configuration,
    # in both packages).
    return pkg.calibrate_one_vanishing_point(
        np.full(len(p["origin"]), 35.0), *args, conv(p["horizon_a"]),
        conv(p["horizon_b"]),
        scene_scale_mode=int(mode), scene_scale_distance_cm=1.7)


@pytest.mark.parametrize("mode", list(t_van.SceneScaleMode))
@pytest.mark.parametrize("which", ["two", "one"])
def test_calibrations_match(which, mode):
    p = _points(3)
    want = _calibrate(j_van, which, p, mode, jnp.asarray)
    got = _calibrate(t_van, which, p, mode, torch.as_tensor)
    assert type(got).__name__ == "CameraCalibration"
    assert got._fields == want._fields
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = to_numpy(getattr(got, field))
        g = np.broadcast_to(g, w.shape) if g.shape != w.shape else g
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=field)
    assert bool(np.all(to_numpy(got.ok)))
    assert got.rotation_matrix.dtype == torch.float64


def test_invalid_pair_falls_back_to_the_users_focal_length():
    """Both vanishing points on one side of the principal point: focal^2
    comes out negative, ok is False and the user's focal length stands."""
    p = _points(4)
    p["vp_b"] = p["vp_a"] + np.array([0.3, 0.0])
    want = _calibrate(j_van, "two", p, t_van.SceneScaleMode.UNIFORM_SCALE,
                      jnp.asarray)
    got = _calibrate(t_van, "two", p, t_van.SceneScaleMode.UNIFORM_SCALE,
                     torch.as_tensor)
    assert not bool(np.any(to_numpy(got.ok)))
    np.testing.assert_array_equal(to_numpy(got.ok), np.asarray(want.ok))
    np.testing.assert_allclose(to_numpy(got.focal_length_mm), 35.0, atol=TOL)
    for field in ("focal_length_factor", "rotation_matrix", "translation"):
        np.testing.assert_allclose(to_numpy(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   atol=TOL, rtol=TOL, err_msg=field)


def test_calibration_keeps_the_points_dtype():
    p = {k: v.astype(np.float32) for k, v in _points(5).items()}
    got = _calibrate(t_van, "two", p, t_van.SceneScaleMode.CAMERA_HEIGHT,
                     torch.as_tensor)
    assert got.translation.dtype == torch.float32
    assert got.focal_length_mm.dtype == torch.float32
