"""Agreement of the torch port's 3DE lens models with the JAX package.

distort/undistort of every model, and apply_scene_lens over a scene with
a single-layer lens on one camera and a two-layer stack on the other,
in float64 at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.models.scenelens as t_scenelens
import mayamatchmovesolver_torch.scene as t_scene
import mayamatchmovesolver_tpu.models as j_models
import mayamatchmovesolver_tpu.models.scenelens as j_scenelens
from _torch_port_cases import rich_scene, to_numpy
from mayamatchmovesolver_tpu.scene.flatscene import evaluate_jit as j_evaluate

ATOL = 1e-10

MODELS = {
    "passthrough": ("Passthrough", {}),
    "classic": ("TdeClassic", dict(
        distortion=0.15, anamorphic_squeeze=1.05, curvature_x=0.02,
        curvature_y=-0.01, quartic_distortion=0.03)),
    "radial_deg4": ("TdeRadialStdDeg4", dict(
        degree2_distortion=0.12, degree2_u=0.01, degree2_v=-0.02,
        degree4_distortion=0.04, degree4_u=-0.005, degree4_v=0.008,
        cylindric_direction=25.0, cylindric_bending=0.1)),
    "anamorphic_deg4": ("TdeAnamorphicStdDeg4", dict(
        degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
        degree2_cy22=-0.01, degree4_cx04=0.01, degree4_cy04=-0.005,
        degree4_cx24=0.004, degree4_cy24=0.002, degree4_cx44=-0.003,
        degree4_cy44=0.001, lens_rotation=4.0, squeeze_x=1.1,
        squeeze_y=0.95)),
    "anamorphic_deg4_rescaled": ("TdeAnamorphicStdDeg4Rescaled", dict(
        degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
        degree2_cy22=-0.01, degree4_cx04=0.01, degree4_cy04=-0.005,
        lens_rotation=-3.0, squeeze_x=1.05, squeeze_y=1.0, rescale=1.1)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_model(pkg, name):
    """(model, film back) of MODELS[name] in float64 in either package."""
    cls_name, params = MODELS[name]
    fb = dict(width_cm=3.6, height_cm=2.4, offset_x_cm=0.05,
              offset_y_cm=-0.02, pixel_aspect=1.2)
    if pkg == "jax":
        cls = getattr(j_models, cls_name)
        model = cls() if not params else cls.create(**params)
        return model, j_models.FilmBack.create(**fb)
    kw = dict(device="cpu", dtype=torch.float64)
    return (getattr(t_models, cls_name).create(**params, **kw),
            t_models.FilmBack.create(**fb, **kw))


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_direction_matches(name, direction):
    rng = np.random.RandomState(7)
    xy = rng.uniform(-0.5, 0.5, (40, 3, 2))
    j_model, j_fb = make_model("jax", name)
    t_model, t_fb = make_model("torch", name)
    want = getattr(j_models, direction)(j_model, j_fb, jnp.asarray(xy))
    got = getattr(t_models, direction)(t_model, t_fb, torch.as_tensor(xy))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", sorted(set(MODELS) - {"passthrough"}))
def test_distort_inverts_undistort(name):
    """The port's own round trip: the 20-step fixed point inverts the
    polynomial to well below a pixel of a 4K plate."""
    t_model, t_fb = make_model("torch", name)
    xy = torch.as_tensor(np.random.RandomState(1).uniform(-0.4, 0.4, (64, 2)))
    back = t_models.undistort(t_model, t_fb,
                              t_models.distort(t_model, t_fb, xy))
    np.testing.assert_allclose(to_numpy(back), to_numpy(xy), atol=1e-6)


def test_create_rejects_unknown_parameter():
    with pytest.raises(TypeError, match="unknown TdeClassic parameters"):
        t_models.TdeClassic.create(distorsion=0.1, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return rich_scene("jax"), rich_scene("torch")


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_apply_scene_lens_matches(scenes, direction):
    (_, j_sc, j_at, j_lens, _), (_, t_sc, t_at, t_lens, _) = scenes
    assert t_lens.model_types == j_lens.model_types
    assert t_lens.model_types[1] == (
        t_scenelens.LENS_MODEL_RADIAL_DEG4,
        t_scenelens.LENS_MODEL_ANAMORPHIC_DEG4,
    )
    n = j_at.num_frames
    j_pts = j_evaluate(j_sc, j_at, jnp.arange(n)).point_xy
    t_pts = t_scene.evaluate(t_sc, t_at, torch.arange(n)).point_xy
    want = jax.jit(j_scenelens.apply_scene_lens, static_argnames="direction")(
        j_lens, j_sc, j_at, jnp.arange(n), j_pts, j_sc.mkr_cam_index,
        direction=direction)
    got = t_scenelens.apply_scene_lens(
        t_lens, t_sc, t_at, torch.arange(n), t_pts, t_sc.mkr_cam_index,
        direction=direction)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL)
    assert not np.allclose(to_numpy(got), to_numpy(t_pts))


def test_bake_scene_lens_codes_match(scenes):
    (_, _, _, j_lens, _), (_, _, _, t_lens, _) = scenes
    np.testing.assert_array_equal(
        to_numpy(t_lens.param_codes), np.asarray(j_lens.param_codes))
    assert t_scenelens.MAX_LENS_PARAMS == j_scenelens.MAX_LENS_PARAMS
