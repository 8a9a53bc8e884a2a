"""Agreement of the torch port's BA bridge and of solve() on the Schur BA
path with the JAX package.

The same scenes are built in both packages from numpy seeds.  The bridge
must give the same BAProblem arrays (to 1e-12: they are gathered, not
computed, but the marker tracks come from each package's own projection)
and every fallback reason word for word; apply_result must write the
same attributes.  solve() with SOLVER_TYPE_BA_SCHUR must give
the JAX package's result strings: the same iterations, stop reason and
counted evaluations, and deviations and solved parameters within 1e-8
(float64; the Cholesky Schur step agrees to ~1e-12 on this shot).  The
port's BA lands where its own dense backend does, within 1e-6.
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.solver.ba_bridge as t_bridge
import mayamatchmovesolver_tpu.solver.ba_bridge as j_bridge
from _torch_port_cases import PACKAGES, to_numpy
from mayamatchmovesolver_torch.solver import registry as t_registry
from mayamatchmovesolver_tpu.core.constants import FilmFit
from mayamatchmovesolver_tpu.solver.loss import RobustLossType

t_solve = importlib.import_module("mayamatchmovesolver_torch.solver.solve")
j_solve = importlib.import_module("mayamatchmovesolver_tpu.solver.solve")
SOLVE = {"jax": j_solve, "torch": t_solve}
BRIDGE = {"jax": j_bridge, "torch": t_bridge}

TOL = 1e-8
FRAMES, BUNDLES = 6, 5
POSE = ("tx", "ty", "tz", "rx", "ry", "rz")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shot(pkg, variant="ok", perturb=False):
    """A tracked shot in `pkg`: one camera through a 3DE classic lens (or,
    for the 'rig' variants, two cameras without one), 6 frames, 5 static
    bundles, markers at the exact projections.  `variant` bends it out of
    the BA shape in one way.  Returns (scene, attrs, lens, solve_attrs,
    extra solve() keywords, handles)."""
    scene_mod, lens_mod = PACKAGES[pkg]
    rng = np.random.RandomState(11)
    n = FRAMES
    sg = scene_mod.SceneGraph(frame_range=(1, n))
    rig = variant.startswith("rig")
    root = sg.create_transform("root", tx=0.5)
    cams = []
    for ci in range(2 if rig else 1):
        kw = dict(
            film_fit=FilmFit.HORIZONTAL, render_width=1920,
            render_height=1080,
            tx=np.linspace(-3, 3, n) + 1.5 * ci,
            ty=1.0 + 0.5 * np.sin(np.linspace(0, 3, n)),
            tz=4.0 + np.linspace(0, 2, n) + 0.5 * ci,
            rx=np.linspace(-5, 5, n), ry=np.linspace(-20, 20, n) - 4.0 * ci,
            rz=np.zeros(n),
            focal_length_mm=35.0 + ci,
        )
        if variant == "camera_parented":
            kw["parent"] = root
        if variant == "camera_scale":
            kw["sx"] = 1.1
        if variant == "static_pose":
            kw["rz"] = 0.5
        if variant == "animated_focal":
            kw["focal_length_mm"] = np.linspace(34.0, 36.0, n)
        if ci == 1 and variant == "rig_film_fit":
            kw["film_fit"] = FilmFit.VERTICAL
        if ci == 1 and variant == "rig_render_size":
            kw["render_width"] = 1000
        cams.append(sg.create_camera("cam%d" % ci, **kw))
    cam = cams[0]
    if not rig or variant == "rig_lens":
        lens_kw = dict(distortion=0.05)
        if variant == "animated_lens":
            lens_kw["distortion"] = np.linspace(0.04, 0.06, n)
        if variant == "animated_pixel_aspect":
            lens_kw["pixel_aspect"] = np.linspace(1.0, 1.1, n)
        lens_mod.attach_lens(sg, cam, lens_mod.LENS_MODEL_CLASSIC, **lens_kw)
        if variant == "two_layers":
            lens_mod.attach_lens(sg, cam, lens_mod.LENS_MODEL_RADIAL_DEG4,
                                 degree2_distortion=0.01)
    bundles = []
    for i in range(BUNDLES):
        kw = dict(tx=rng.uniform(-3, 3), ty=rng.uniform(-2, 2),
                  tz=rng.uniform(-6, 0))
        if i == 0 and variant == "bundle_parented":
            kw["parent"] = root
        if i == 0 and variant == "animated_bundle":
            kw["tx"] = np.linspace(-1, 1, n)
        bundles.append(sg.create_bundle("b%d" % i, **kw))
    markers = []
    for c in cams:
        for i, bnd in enumerate(bundles):
            markers.append(sg.create_marker(
                "m%s_%d" % (c.name, i), camera=c, bundle=bnd,
                tx=np.zeros(n), ty=np.zeros(n)))
    scene, attrs, lens = _tracked(pkg, sg)

    solve_attrs = [c.attr(ch) for c in cams for ch in POSE]
    solve_attrs += [b.attr(ch) for b in bundles for ch in ("tx", "ty", "tz")]
    solve_attrs += [c.attr("focal_length_mm") for c in cams]
    if not rig:
        solve_attrs.append(cam.attr("lens_distortion"))
    extra = {}
    if variant == "stiffness":
        code = cam.attr("tx").code
        extra["stiffness"] = dict(codes=[code], frames=[0], weight=[1.0],
                                  variance=[1.0])
    if variant == "lines":
        sg.create_line("line", markers[:3])
        extra["lines"] = sg.line_spec()
    if variant == "box":
        bundles[0].attr("tx").set_min_max(-10.0, 10.0)
    if variant == "outside":
        solve_attrs.append(cam.attr("sensor_width_mm"))
    if variant == "rig_focal_partial":
        solve_attrs.remove(cams[1].attr("focal_length_mm"))
    if variant == "pose_partial":
        solve_attrs.remove(cam.attr("rz"))
    if variant == "bundles_partial":
        solve_attrs.remove(bundles[-1].attr("tz"))
    if perturb:
        attrs = _perturb(pkg, attrs, cam, bundles)
    handles = dict(cams=cams, bundles=bundles)
    return scene, attrs, lens, solve_attrs, extra, handles


def _tracked(pkg, sg):
    """(scene, attributes, lens), baked, with every marker at its
    bundle's projection (through the lens where the camera has one)."""
    scene_mod, lens_mod = PACKAGES[pkg]
    fi = np.arange(FRAMES)
    if pkg == "torch":
        from mayamatchmovesolver_torch.scene.flatscene import (
            set_marker_screen_positions,
        )
        scene, attrs = sg.bake(device="cpu")
        lens = lens_mod.bake_scene_lens(sg, device="cpu")
        fi = torch.as_tensor(fi)
        pts = scene_mod.evaluate(scene, attrs, fi).point_xy
        if lens.has_any():
            pts = lens_mod.apply_scene_lens(lens, scene, attrs, fi, pts,
                                            scene.mkr_cam_index)
        return scene, set_marker_screen_positions(scene, attrs, fi, pts), lens
    from mayamatchmovesolver_tpu.scene.flatscene import (
        evaluate_jit,
        set_marker_screen_positions,
    )
    scene, attrs = sg.bake()
    lens = lens_mod.bake_scene_lens(sg)
    fi = jnp.asarray(fi)
    pts = evaluate_jit(scene, attrs, fi).point_xy
    if lens.has_any():
        pts = jax.jit(lens_mod.apply_scene_lens)(
            lens, scene, attrs, fi, pts, scene.mkr_cam_index)
    return scene, set_marker_screen_positions(scene, attrs, fi, pts), lens


def _perturb(pkg, attrs, cam, bundles):
    """The camera's tx / ry, its focal length and distortion and the
    bundle positions moved off the truth."""
    rng = np.random.RandomState(4)
    static = np.array(to_numpy(attrs.static_values))
    anim = np.array(to_numpy(attrs.anim_values))
    anim[cam.attr("tx").code // 2] += 0.05
    anim[cam.attr("ry").code // 2] -= 0.5
    static[cam.attr("focal_length_mm").code // 2] += 1.0
    static[cam.attr("lens_distortion").code // 2] -= 0.02
    for b in bundles:
        for ch in ("tx", "ty", "tz"):
            static[b.attr(ch).code // 2] += rng.normal(0.0, 0.03)
    if pkg == "torch":
        return dataclasses.replace(attrs,
                                   static_values=torch.as_tensor(static),
                                   anim_values=torch.as_tensor(anim))
    return attrs._replace(static_values=jnp.asarray(static),
                          anim_values=jnp.asarray(anim))


def _bridges(variant, loss_type=RobustLossType.TRIVIAL, masked=False):
    out = {}
    for pkg in ("jax", "torch"):
        scene, attrs, lens, solve_attrs, extra, _ = _shot(pkg, variant)
        options = SOLVE[pkg].SolverOptions(image_width=1920.0,
                                           robust_loss_type=loss_type,
                                           robust_loss_scale=2.0)
        if masked:
            mask = np.ones((scene.num_markers, FRAMES), bool)
            mask[1, 2:4] = False
            extra["marker_frame_mask"] = mask
        out[pkg] = BRIDGE[pkg].build_ba_bridge(
            scene, attrs, np.arange(FRAMES), solve_attrs, options,
            lens=lens, **extra)
    return out["jax"], out["torch"]


PROBLEM_FIELDS = ("marker_uv", "weight", "mkr_bnd_index", "mkr_cam_block",
                  "cam_params", "bnd_params", "shared_params", "intrinsics",
                  "lens_params", "lens_pixel_aspect")


@pytest.mark.parametrize("variant,loss_type,masked", [
    ("ok", RobustLossType.TRIVIAL, False),
    ("ok", RobustLossType.SOFT_L1, True),
    ("rig", RobustLossType.CAUCHY, True),
])
def test_bridge_problem_matches(variant, loss_type, masked):
    (j_br, j_reason), (t_br, t_reason) = _bridges(variant, loss_type, masked)
    assert j_br is not None and t_br is not None, (j_reason, t_reason)
    assert j_reason == t_reason == ""
    j_prob, t_prob = j_br.problem, t_br.problem
    for name in PROBLEM_FIELDS:
        got, want = getattr(t_prob, name), getattr(j_prob, name)
        assert got.device.type == "cpu", name
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    from mayamatchmovesolver_torch.solver import ba as t_ba
    from mayamatchmovesolver_tpu.solver import ba as j_ba
    assert t_ba._static_cfg(t_prob) == j_ba._static_cfg(j_prob)

    # apply_result writes the same attributes.
    rng = np.random.RandomState(1)
    values = {name: rng.normal(size=np.asarray(getattr(j_prob, name)).shape)
              for name in ("cam_params", "bnd_params", "shared_params")}
    _, t_attrs, _, _, _, _ = _shot("torch", variant)
    _, j_attrs, _, _, _, _ = _shot("jax", variant)
    got = t_br.apply_result(t_attrs, types.SimpleNamespace(
        **{k: torch.as_tensor(v) for k, v in values.items()}))
    want = j_br.apply_result(j_attrs, types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in values.items()}))
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-12, atol=1e-14, err_msg=field)


@pytest.mark.parametrize("variant,reason", [
    ("stiffness", "stiffness/smoothness constraints"),
    ("lines", "line constraints"),
    ("camera_parented", "camera is not a root transform"),
    ("bundle_parented", "parented bundles"),
    ("rig_film_fit", "cameras differ in film fit / rotate order"),
    ("rig_render_size", "cameras differ in render size"),
    ("camera_scale", "camera has non-unit scale"),
    ("rig_lens", "lens distortion on a multi-camera rig"),
    ("two_layers", "multi-layer or multi-camera lens stack"),
    ("animated_lens", "animated lens parameters"),
    ("animated_pixel_aspect", "animated lens pixel aspect"),
    ("box", "box constraints on 'tx'"),
    ("static_pose", "static camera pose attr rz"),
    ("animated_focal", "animated focal length"),
    ("animated_bundle", "animated bundle attr"),
    ("outside", "attribute cam0.sensor_width_mm outside the BA shape"),
    ("rig_focal_partial", "focal solved on 1 of 2 cameras"),
    ("pose_partial", "camera pose not fully solved (5/6 channels)"),
    ("bundles_partial", "bundles not fully solved (4/5 with tx/ty/tz)"),
])
def test_bridge_fallback_reason_matches(variant, reason):
    (j_br, j_reason), (t_br, t_reason) = _bridges(variant)
    assert j_br is None and t_br is None
    assert t_reason == j_reason == reason


def _solve(pkg, variant="ok", **options):
    scene, attrs, lens, solve_attrs, extra, h = _shot(pkg, variant,
                                                      perturb=True)
    mod = SOLVE[pkg]
    attrs_out, result = mod.solve(
        scene, attrs, np.arange(FRAMES), solve_attrs,
        mod.SolverOptions(image_width=1920.0, **options), lens=lens, **extra)
    return attrs_out, result, h


@pytest.mark.parametrize("assembly", ["ad", "analytic"])
def test_solve_ba_schur_matches_jax(assembly):
    ba = t_registry.SOLVER_TYPE_BA_SCHUR
    j_attrs, j_res, _ = _solve("jax", solver_type=ba)
    t_attrs, t_res, h = _solve("torch", solver_type=ba, ba_assembly=assembly)
    assert t_res.solver_type_name == j_res.solver_type_name == "ba_schur"
    _assert_ba_solves_match(t_attrs, t_res, j_attrs, j_res, h)


def _assert_ba_solves_match(t_attrs, t_res, j_attrs, j_res, h):
    """A port BA solve() against a JAX one of the shot: equal result
    strings (numbers within TOL or the six digits %g prints, the timers
    aside), parameters and attributes within TOL, the focal recovered."""
    assert j_res.success and t_res.success
    assert t_res.reason_string == j_res.reason_string
    assert "fallback" not in t_res.reason_string
    for name in ("iterations", "stop_reason", "function_evals",
                 "jacobian_evals"):
        assert getattr(t_res, name) == getattr(j_res, name), name
    for name in ("error_initial", "error_final", "error_avg", "error_min",
                 "error_max"):
        assert abs(getattr(t_res, name) - getattr(j_res, name)) < TOL, name
    np.testing.assert_allclose(t_res.solved_parameters,
                               np.asarray(j_res.solved_parameters), atol=TOL)
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(t_attrs, field)),
                                   np.asarray(getattr(j_attrs, field)),
                                   atol=TOL, err_msg=field)
    np.testing.assert_allclose(t_res.per_frame_error.errors,
                               j_res.per_frame_error.errors, atol=TOL)
    t_lines = t_res.as_key_value_strings()
    j_lines = j_res.as_key_value_strings()
    assert len(t_lines) == len(j_lines)
    for t_line, j_line in zip(t_lines, j_lines):
        key, got = t_line.split("=", 1)
        assert j_line.split("=", 1)[0] == key
        if key.startswith("timer_"):
            continue
        want = j_line.split("=", 1)[1]
        try:
            np.testing.assert_allclose(
                np.array(got.replace(",", " ").split(), float),
                np.array(want.replace(",", " ").split(), float),
                rtol=1e-5, atol=TOL, err_msg=key)
        except ValueError:
            assert got == want, key
    cam = h["cams"][0]
    focal = float(t_attrs.static_values[cam.attr("focal_length_mm").code // 2])
    assert abs(focal - 35.0) < 1e-6


def test_solve_ba_schur_matches_the_ports_dense_backend():
    d_attrs, d_res, h = _solve("torch")
    b_attrs, b_res, _ = _solve(
        "torch", solver_type=t_registry.SOLVER_TYPE_BA_SCHUR,
        ba_linear_solver="cg", ba_cg_iterations=60)
    assert d_res.success and b_res.success
    assert (d_res.solver_type_name, b_res.solver_type_name) == (
        "lm_jax", "ba_schur")
    assert b_res.error_final < 1e-6 and d_res.error_final < 1e-6
    cam = h["cams"][0]
    for name, truth in (("focal_length_mm", 35.0), ("lens_distortion", 0.05)):
        row = cam.attr(name).code // 2
        got = [float(a.static_values[row]) for a in (d_attrs, b_attrs)]
        np.testing.assert_allclose(got, [truth, truth], atol=1e-6,
                                   err_msg=name)


def test_solve_ba_fallback_note_matches():
    ba = t_registry.SOLVER_TYPE_BA_SCHUR
    _, j_res, _ = _solve("jax", "pose_partial", solver_type=ba)
    _, t_res, _ = _solve("torch", "pose_partial", solver_type=ba)
    assert t_res.solver_type_name == j_res.solver_type_name == "lm_jax"
    assert t_res.reason_string == j_res.reason_string
    assert t_res.reason_string.endswith(
        " (ba fallback to dense: camera pose not fully solved (5/6 "
        "channels))")
    assert t_res.iterations == j_res.iterations


@pytest.mark.parametrize("option,value", [
    ("iteration_callback", lambda it, cost: None),
    ("interrupt_check", lambda: False),
    ("max_seconds", 3600.0),
])
def test_solve_ba_with_a_host_hook_stays_on_the_ba(option, value):
    """Each hook alone sends the BA through its block-resumable solve loop:
    still ba_schur, no fallback, and the unhooked solve's result."""
    ba = t_registry.SOLVER_TYPE_BA_SCHUR
    want_attrs, want, _ = _solve("torch", solver_type=ba)
    got_attrs, got, _ = _solve("torch", solver_type=ba, **{option: value})
    assert got.solver_type_name == "ba_schur"
    assert "fallback" not in got.reason_string and not got.user_interrupted
    assert got.iterations == want.iterations
    assert got.reason_string == want.reason_string
    np.testing.assert_array_equal(got.solved_parameters,
                                  want.solved_parameters)
    assert torch.equal(got_attrs.static_values, want_attrs.static_values)


@pytest.mark.parametrize("option,value,match", [
    ("solver_type", t_registry.SOLVER_TYPE_BA_SHARDED, "item 14"),
], ids=["solver_type-3-item 14"])
def test_solve_ba_refuses_unported_options(option, value, match):
    """ba_schur_sharded, once refused (ROADMAP item 14), gives the JAX
    package's result: its 6 frames divide neither the JAX tests' 8
    devices nor need a split at the port's world size 1, so both take the
    single-device Schur BA under the sharded type's name."""
    j_attrs, j_res, _ = _solve("jax", **{option: value})
    t_attrs, t_res, h = _solve("torch", **{option: value})
    assert t_res.solver_type_name == j_res.solver_type_name == (
        "ba_schur_sharded")
    _assert_ba_solves_match(t_attrs, t_res, j_attrs, j_res, h)
