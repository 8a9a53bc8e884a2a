"""Shared inputs for the agreement tests between the JAX package and the
torch port.

Each builder makes the same scene in either package from numpy seeds:
the two SceneGraph APIs are the same apart from the port's explicit
`device` on bake.  Nothing here runs a solve.
"""

import dataclasses

import numpy as np

import mayamatchmovesolver_torch.models.scenelens as t_scenelens
import mayamatchmovesolver_torch.scene as t_scene
import mayamatchmovesolver_tpu.models.scenelens as j_scenelens
import mayamatchmovesolver_tpu.scene as j_scene
from mayamatchmovesolver_tpu.core.constants import FilmFit, RotateOrder

PACKAGES = {
    "jax": (j_scene, j_scenelens),
    "torch": (t_scene, t_scenelens),
}


def _bake(pkg, sg):
    if pkg == "torch":
        return sg.bake(device="cpu")
    return sg.bake()


def _bake_lens(pkg, sg):
    if pkg == "torch":
        return t_scenelens.bake_scene_lens(sg, device="cpu")
    return j_scenelens.bake_scene_lens(sg)


def rich_scene(pkg):
    """Every rotate order, a 3-deep parent chain, two cameras with
    different film fits (one parented), a marker group with animated
    overscan, disabled and weighted markers, a bundle behind camera 0,
    and lenses: classic on camera 0, a radial + anamorphic stack on
    camera 1.  Returns (sg, scene, attrs, lens, handles)."""
    scene_mod, lens_mod = PACKAGES[pkg]
    rng = np.random.RandomState(0)
    n = 4
    sg = scene_mod.SceneGraph(frame_range=(1, n))
    a = sg.create_transform(
        "a", rotate_order=RotateOrder.XYZ, tx=0.3, ry=rng.uniform(-20, 20, n),
        sx=1.1,
    )
    b = sg.create_transform(
        "b", parent=a, rotate_order=RotateOrder.YZX, ty=rng.uniform(-1, 1, n),
        rx=12.0, rz=-7.0, sy=rng.uniform(0.9, 1.1, n),
    )
    c = sg.create_transform(
        "c", parent=b, rotate_order=RotateOrder.ZXY, tz=-0.5,
        rx=rng.uniform(-10, 10, n), ry=5.0, rz=rng.uniform(-10, 10, n),
    )
    cam0 = sg.create_camera(
        "cam0", rotate_order=RotateOrder.ZXY, film_fit=FilmFit.HORIZONTAL,
        render_width=1920, render_height=1080,
        tx=np.linspace(-1, 1, n), ty=0.5, tz=12.0 + np.linspace(0, 1, n),
        rx=rng.uniform(-3, 3, n), ry=rng.uniform(-5, 5, n), rz=1.0,
        focal_length_mm=np.linspace(34.0, 36.0, n),
    )
    cam1 = sg.create_camera(
        "cam1", parent=a, rotate_order=RotateOrder.XZY,
        film_fit=FilmFit.VERTICAL, render_width=1000, render_height=800,
        tx=2.0, ty=-0.3, tz=14.0, ry=8.0, focal_length_mm=50.0,
        sensor_width_mm=24.0, sensor_height_mm=18.0,
        lens_offset_x_mm=0.4, lens_offset_y_mm=-0.2,
    )
    orders = [RotateOrder.XZY, RotateOrder.YXZ, RotateOrder.ZYX,
              RotateOrder.XYZ, RotateOrder.YZX, RotateOrder.ZXY]
    bundles = []
    for i, order in enumerate(orders):
        bundles.append(sg.create_bundle(
            "bnd%d" % i, parent=c if i % 2 else None, rotate_order=order,
            tx=rng.uniform(-3, 3), ty=rng.uniform(-2, 2),
            tz=rng.uniform(-6, -2), rx=rng.uniform(-30, 30),
        ))
    # In front of camera 1, behind camera 0 (which sits at tz ~ 12).
    bundles.append(sg.create_bundle("behind", tx=0.5, ty=0.2, tz=13.5))
    group = sg.create_marker_group(
        "grp", camera=cam1, overscan_x=rng.uniform(0.9, 1.1, n),
        overscan_y=1.05,
    )
    markers = []
    for i, bnd in enumerate(bundles):
        values = dict(tx=rng.uniform(-0.4, 0.4, n),
                      ty=rng.uniform(-0.3, 0.3, n))
        if i == 1:
            values["weight"] = 0.5
        if i == 2:
            values["enable"] = np.array([1.0, 0.0] * (n // 2))
        markers.append(sg.create_marker("m0_%d" % i, camera=cam0,
                                        bundle=bnd, **values))
        markers.append(sg.create_marker(
            "m1_%d" % i, camera=cam1, bundle=bnd, group=group,
            tx=rng.uniform(-0.4, 0.4, n), ty=rng.uniform(-0.3, 0.3, n),
        ))
    lens_mod.attach_lens(sg, cam0, lens_mod.LENS_MODEL_CLASSIC,
                         distortion=0.05, curvature_x=0.01,
                         quartic_distortion=0.01)
    lens_mod.attach_lens(sg, cam1, lens_mod.LENS_MODEL_RADIAL_DEG4,
                         degree2_distortion=0.03, degree2_u=0.002,
                         cylindric_direction=10.0, cylindric_bending=0.02)
    lens_mod.attach_lens(sg, cam1, lens_mod.LENS_MODEL_ANAMORPHIC_DEG4,
                         degree2_cx02=0.02, degree2_cy02=0.01,
                         lens_rotation=2.0, squeeze_x=1.02,
                         pixel_aspect=1.1)
    scene, attrs = _bake(pkg, sg)
    lens = _bake_lens(pkg, sg)
    handles = dict(cams=(cam0, cam1), bundles=bundles, markers=markers,
                   chain=(a, b, c))
    return sg, scene, attrs, lens, handles


def lens_focal_scene(pkg):
    """A tracked shot through a 3DE classic lens: an animated camera,
    static bundles, markers at the exact lens-distorted projections.
    Then the camera's tx/ry animation, focal length and distortion are
    perturbed.  8 frames, 6 bundles, float64.  Returns (scene, attrs,
    lens, solve_attrs, truth) where truth holds the true focal length and
    distortion and their static attribute indices."""
    scene_mod, lens_mod = PACKAGES[pkg]
    rng = np.random.RandomState(5)
    n = 8
    sg = scene_mod.SceneGraph(frame_range=(1, n))
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=1920,
        render_height=1080,
        tx=np.linspace(-3, 3, n),
        ty=1.5 + 0.3 * np.sin(np.linspace(0, 6, n)),
        tz=12.0 + np.linspace(0, 2, n),
        rx=2.0 * np.sin(np.linspace(0, 3, n)),
        ry=np.linspace(-8, 8, n), rz=np.zeros(n),
        focal_length_mm=35.0,
    )
    lens_mod.attach_lens(sg, cam, lens_mod.LENS_MODEL_CLASSIC,
                         distortion=0.08)
    bundles = [
        sg.create_bundle("b%d" % i, tx=rng.uniform(-5, 5),
                         ty=rng.uniform(-2, 4), tz=rng.uniform(-14, -6))
        for i in range(6)
    ]
    for i, bnd in enumerate(bundles):
        sg.create_marker("m%d" % i, camera=cam, bundle=bnd,
                         tx=np.zeros(n), ty=np.zeros(n))
    scene, attrs = _bake(pkg, sg)
    lens = _bake_lens(pkg, sg)
    frames = np.arange(n)
    if pkg == "torch":
        import torch

        fi = torch.as_tensor(frames)
        ev = t_scene.evaluate(scene, attrs, fi)
        pts = t_scenelens.apply_scene_lens(
            lens, scene, attrs, fi, ev.point_xy, scene.mkr_cam_index)
        from mayamatchmovesolver_torch.scene.flatscene import (
            set_marker_screen_positions,
        )
        attrs = set_marker_screen_positions(scene, attrs, fi, pts)
        static = attrs.static_values.numpy().copy()
        anim = attrs.anim_values.numpy().copy()
    else:
        import jax
        import jax.numpy as jnp

        from mayamatchmovesolver_tpu.scene.flatscene import (
            evaluate_jit,
            set_marker_screen_positions,
        )
        fi = jnp.asarray(frames)
        ev = evaluate_jit(scene, attrs, fi)
        pts = jax.jit(j_scenelens.apply_scene_lens)(
            lens, scene, attrs, fi, ev.point_xy, scene.mkr_cam_index)
        attrs = set_marker_screen_positions(scene, attrs, fi, pts)
        static = np.array(attrs.static_values)
        anim = np.array(attrs.anim_values)
    anim[cam.attr("tx").code // 2] += 0.1
    anim[cam.attr("ry").code // 2] -= 0.8
    static[cam.attr("focal_length_mm").code // 2] += 1.5
    static[cam.attr("lens_distortion").code // 2] -= 0.03
    if pkg == "torch":
        import torch

        attrs = dataclasses.replace(
            attrs, static_values=torch.as_tensor(static),
            anim_values=torch.as_tensor(anim))
    else:
        import jax.numpy as jnp

        attrs = attrs._replace(static_values=jnp.asarray(static),
                               anim_values=jnp.asarray(anim))
    solve_attrs = [cam.attr(ch) for ch in ("tx", "ty", "tz", "rx", "ry", "rz")]
    solve_attrs += [cam.attr("focal_length_mm"), cam.attr("lens_distortion")]
    truth = dict(focal=35.0, distortion=0.08,
                 focal_index=cam.attr("focal_length_mm").code // 2,
                 distortion_index=cam.attr("lens_distortion").code // 2)
    return scene, attrs, lens, solve_attrs, truth


def jax_fields(obj):
    """A JAX FlatScene / AttrBlock / SceneLens as a dict of numpy arrays,
    without its static fields (doubling_steps, model_types)."""
    if hasattr(obj, "_fields"):
        names = obj._fields
    else:
        names = [f.name for f in dataclasses.fields(obj)]
    static = ("doubling_steps", "model_types")
    return {n: np.asarray(getattr(obj, n)) for n in names if n not in static}


def to_numpy(x):
    """A torch tensor or JAX array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_sampler(frame, num_hypotheses, sample_size, weights):
    """The RANSAC draws of the JAX package's camera_solve, by its very
    calls (sfm/twoview.py: robust_relative_pose under PRNGKey(42) for
    the anchor pair, robust_resection_pose under PRNGKey(frame) with the
    weights as probabilities), as the `sampler` of the port's."""
    import jax
    import jax.numpy as jnp

    n = len(weights)
    if frame is None:
        return np.array(jax_relative_pose_draws(
            jax.random.PRNGKey(42), n, num_hypotheses, sample_size))
    return np.array(jax_resection_draws(
        jax.random.PRNGKey(int(frame)), jnp.asarray(weights, jnp.float64),
        num_hypotheses, sample_size))


def jax_relative_pose_draws(key, n, num_hypotheses, sample_size):
    """twoview.py:233-237."""
    import jax

    return jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(sample_size,),
                                    replace=False)
    )(jax.random.split(key, num_hypotheses))


def jax_resection_draws(key, weights, num_hypotheses, sample_size):
    """twoview.py:371-376."""
    import jax
    import jax.numpy as jnp

    n = weights.shape[0]
    probs = weights / jnp.maximum(jnp.sum(weights), 1e-12)
    return jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(sample_size,),
                                    replace=False, p=probs)
    )(jax.random.split(key, num_hypotheses))


CAMERA_SHOT = dict(frames=16, points=24, render=(1500, 1000))


def camera_shot_tracks(focal=40.0, seed=3):
    """A moving-camera shot as tests/test_solver/test_camera_solver.py
    makes it (16 frames, 24 points, 1500x1000): (tracks (M, F, 2) in
    screen space, (fit_x, fit_y) marker fit scales), by the JAX
    package's evaluate."""
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu.scene import flatscene

    n, m = CAMERA_SHOT["frames"], CAMERA_SHOT["points"]
    rng = np.random.RandomState(seed)
    sg = j_scene.SceneGraph(frame_range=(1, n))
    t = np.linspace(0.0, 1.0, n)
    cam = sg.create_camera(
        "cam", tx=6.0 * t, ty=0.5 + 0.4 * np.sin(3.0 * t), tz=9.0 - 2.0 * t,
        rx=2.0 * np.sin(2.0 * t), ry=-18.0 * t, rz=np.zeros(n),
        focal_length_mm=focal, sensor_width_mm=36.0, sensor_height_mm=24.0,
        film_fit=FilmFit.HORIZONTAL, render_width=CAMERA_SHOT["render"][0],
        render_height=CAMERA_SHOT["render"][1],
    )
    pts = np.stack([rng.uniform(-4, 10, m), rng.uniform(-2, 4, m),
                    rng.uniform(-6, 2, m)], axis=-1)
    for i, p in enumerate(pts):
        b = sg.create_bundle("b%d" % i, tx=p[0], ty=p[1], tz=p[2])
        sg.create_marker("m%d" % i, camera=cam, bundle=b)
    scene, attrs = sg.bake()
    ev = j_scene.evaluate(scene, attrs, jnp.arange(n))
    fsx, fsy = flatscene.marker_fit_scale(scene, attrs, jnp.arange(n))
    return np.asarray(ev.point_xy), (np.asarray(fsx), np.asarray(fsy))


def unsolved_camera_scene(pkg, tracks, fit, focal_guess=35.0,
                          rotate_order=RotateOrder.XYZ, static_rz=False):
    """A fresh scene graph in either package: an animated camera parked
    at zeros with a focal guess, bundles at the origin, markers carrying
    the tracks.  Returns (sg, cam, markers)."""
    scene_mod, _ = PACKAGES[pkg]
    fsx, fsy = fit
    n = tracks.shape[1]
    sg = scene_mod.SceneGraph(frame_range=(1, n))
    zeros = np.zeros(n)
    cam = sg.create_camera(
        "cam", rotate_order=rotate_order, tx=zeros, ty=zeros, tz=zeros,
        rx=zeros, ry=zeros, rz=0.0 if static_rz else zeros,
        focal_length_mm=focal_guess, sensor_width_mm=36.0,
        sensor_height_mm=24.0, film_fit=FilmFit.HORIZONTAL,
        render_width=CAMERA_SHOT["render"][0],
        render_height=CAMERA_SHOT["render"][1],
    )
    markers = []
    for i in range(tracks.shape[0]):
        b = sg.create_bundle("b%d" % i, tx=0.0, ty=0.0, tz=0.0)
        markers.append(sg.create_marker(
            "m%d" % i, camera=cam, bundle=b,
            tx=tracks[i, :, 0] / fsx[i], ty=tracks[i, :, 1] / fsy[i]))
    return sg, cam, markers
