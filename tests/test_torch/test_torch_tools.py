"""Agreement of the port's scene tools with the JAX package's, in float64
on the CPU: screenspace, centertwodee, reparent, originframe,
scaleadjust, markertools, raycast and deformmarker.

One scene shape serves the whole file (tool_scene: an animated, scaled
group with an animated child, a static group, an animated camera with
an animated horizontal and a static vertical film offset and a classic
lens, six static bundles and an animated one, each with a marker, one
marker disabled and one enabled on some frames), so
the JAX side compiles its evaluate once for all frames and once for a
single frame.  Each test builds the scene afresh in both packages, runs
the tool in both (the port with device="cpu") and compares what it
returns and the SceneGraph builder's values after it, baked, at 1e-10.
The refusals (a reparent cycle, a static attribute that would animate,
a parented bundle under ray-cast or origin frame, a bad deform
direction) must raise the same error in both.  The reference's own
cases of these tools (tests/test_tools/test_tools.py and the deform
case of test_tail_tools.py) run on the port too; they do not run again
on the JAX side here.
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.tools as t_tools
import mayamatchmovesolver_tpu.tools as j_tools
from _torch_port_cases import PACKAGES, _bake, _bake_lens, to_numpy
from _torch_reference_cases import BAKING_TOOLS, port_cases
from mayamatchmovesolver_tpu.core.constants import FilmFit, RotateOrder

TOL = 1e-10
F = 5
TOOLS = {"jax": j_tools, "torch": t_tools}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tool_scene(pkg):
    """The file's scene in either package; returns (sg, nodes dict)."""
    scene_mod, lens_mod = PACKAGES[pkg]
    rng = np.random.RandomState(11)
    ramp = np.linspace(0.0, 1.0, F)
    sg = scene_mod.SceneGraph(frame_range=(1, F))
    grp = sg.create_transform("grp", tx=3.0 * ramp, ry=40.0 * ramp,
                              sx=2.0, sy=2.0, sz=2.0)
    child = sg.create_transform(
        "child", parent=grp, rotate_order=RotateOrder.ZXY,
        tx=1.0 + ramp, ty=np.ones(F), tz=np.zeros(F), rx=10.0 * ramp,
        ry=np.zeros(F), rz=-5.0 * ramp, sx=np.ones(F), sy=np.ones(F),
        sz=np.ones(F))
    newp = sg.create_transform("newp", tx=-1.0, ry=25.0)
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=1920,
        render_height=1080, tx=-2.0 + 4.0 * ramp, ty=0.5,
        tz=10.0 + ramp, rx=rng.uniform(-3, 3, F), ry=-5.0 + 10.0 * ramp,
        rz=rng.uniform(-2, 2, F), focal_length_mm=35.0,
        sensor_width_mm=36.0, sensor_height_mm=24.0,
        lens_offset_x_mm=np.full(F, 0.3), lens_offset_y_mm=0.1)
    lens_mod.attach_lens(sg, cam, lens_mod.LENS_MODEL_CLASSIC,
                         distortion=0.1)
    bundles = [sg.create_bundle(
        "b%d" % i, rotate_order=int(rng.randint(0, 6)),
        tx=rng.uniform(-3, 3), ty=rng.uniform(-2, 2), tz=rng.uniform(-8, -4))
        for i in range(6)]
    bundles.append(sg.create_bundle(
        "b_anim", tx=rng.uniform(-1, 1, F), ty=rng.uniform(-1, 1, F),
        tz=rng.uniform(-7, -5, F)))
    markers = [sg.create_marker(
        "m%d" % i, camera=cam, bundle=b, tx=rng.uniform(-0.3, 0.3, F),
        ty=rng.uniform(-0.2, 0.2, F)) for i, b in enumerate(bundles)]
    sg.set_value(markers[1].attr("enable"), 0.0)  # static, off
    markers.append(sg.create_marker(
        "m_part", camera=cam, bundle=bundles[2],
        tx=rng.uniform(-0.3, 0.3, F), ty=rng.uniform(-0.2, 0.2, F),
        enable=np.array([1.0, 0.0, 1.0, 1.0, 0.0])))
    return sg, dict(grp=grp, child=child, newp=newp, cam=cam,
                    bundles=bundles, markers=markers)


def _both():
    return {pkg: tool_scene(pkg) for pkg in ("jax", "torch")}


def _cpu(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


def _eval(pkg, sg, frames=F):
    scene_mod, _ = PACKAGES[pkg]
    scene, attrs = _bake(pkg, sg)
    frames = np.arange(frames)
    if pkg == "torch":
        frames = torch.as_tensor(frames)
    return scene, attrs, scene_mod.evaluate(scene, attrs, frames)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


def _same_builder(scenes):
    """Both SceneGraphs bake to equal attributes and parent pointers."""
    baked = {pkg: _bake(pkg, sg) for pkg, (sg, _) in scenes.items()}
    for field in ("static_values", "anim_values"):
        _close(getattr(baked["torch"][1], field),
               getattr(baked["jax"][1], field))
    _close(baked["torch"][0].tfm_parent, baked["jax"][0].tfm_parent, 0)


@pytest.mark.parametrize("case", port_cases(
    "tests/test_tools/test_tools.py",
    ("test_world_to_screen_matches_engine",
     "test_screen_to_world_round_trip", "test_rig_bake_unbake_round_trip",
     "test_center_two_dee_centers_target", "test_center_remap_ranges",
     "test_reparent_preserves_world", "test_reparent_rejects_cycle",
     "test_scene_scale_preserves_reprojection", "test_scale_factors",
     "test_smart_bake_reconstruction", "test_smart_bake_tolerance_curve",
     "test_smooth_keyframes_blend", "test_average_and_duplicate_and_rename",
     "test_marker_from_transform_matches_engine",
     "test_reproject_bundle_snaps_to_marker_ray",
     "test_set_camera_origin_frame", "test_raycast_markers_onto_plane"),
) + port_cases("tests/test_tools/test_tail_tools.py",
               ("test_deform_markers_roundtrip",)))
def test_reference_tool_case_on_the_port(case):
    case()


def test_world_to_screen_and_back_match():
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        screenspace = TOOLS[pkg].screenspace
        _, _, ev = _eval(pkg, sg)
        cam_pos = to_numpy(ev.cam_world[0, :, :3, 3])
        cam_x = to_numpy(ev.cam_world[0, :, :3, 0])
        points = to_numpy(ev.bnd_world_point)  # (B, F, 3)
        # A point in the camera's own plane: clip w 0, clamped to +1e-12.
        in_plane = cam_pos + cam_x
        xy, depth = screenspace.world_to_screen(ev, points)
        static_xy, _ = screenspace.world_to_screen(ev, points[0, 0])
        plane_xy, plane_depth = screenspace.world_to_screen(ev, in_plane)
        back = screenspace.screen_to_world(ev, xy, depth)
        out[pkg] = [to_numpy(v) for v in (xy, depth, static_xy, back,
                                          plane_xy, plane_depth)]
    for got, want in zip(out["torch"][:4], out["jax"][:4]):
        _close(got, want)
    # The in-plane point's x is its camera-space x over the clamped w;
    # its y is round-off over 1e-12, in either package.
    np.testing.assert_allclose(out["torch"][4][:, 0], out["jax"][4][:, 0],
                               rtol=1e-10)
    assert np.abs(out["jax"][4][:, 0]).min() > 1e9  # the clamp was reached
    _close(out["torch"][5], out["jax"][5])


def test_motion_trail_and_rig_bake_match():
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        screenspace = TOOLS[pkg].screenspace
        scene, attrs = _bake(pkg, sg)
        frames = np.arange(F)
        trail = screenspace.motion_trail(scene, attrs, frames,
                                         nodes["child"].index)
        rig = screenspace.screen_space_rig_bake(
            scene, attrs, frames, nodes["bundles"][6].index)
        world = screenspace.screen_space_rig_unbake(
            scene, attrs, frames, rig["screen_x"], rig["screen_y"],
            rig["depth"])
        out[pkg] = list(trail) + [rig["screen_x"], rig["screen_y"],
                                  rig["depth"], world]
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)


def test_center_offsets_and_apply_center_match():
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        center = TOOLS[pkg].centertwodee
        scene, attrs, ev = _eval(pkg, sg)
        target = to_numpy(ev.bnd_world_point[2])  # (F, 3)
        per_frame = center.center_offsets(scene, attrs, np.arange(F),
                                          target)
        static = center.center_offsets(scene, attrs, np.arange(F),
                                       target[0])
        written = center.apply_center(sg, nodes["cam"], np.arange(F),
                                      target, **_cpu(pkg))
        out[pkg] = list(per_frame) + list(static) + list(written) + [
            center.zoom_focal(35.0, np.array([0.001, 0.5, 2.0]))]
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)
    _same_builder(scenes)


@pytest.mark.parametrize("node,parent", [
    ("child", "newp"), ("child", None), ("b0", "newp"), ("newp", "b0"),
])
def test_reparent_matches(node, parent):
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        named = dict(nodes, b0=nodes["bundles"][0])
        trs = TOOLS[pkg].reparent.reparent(
            sg, named[node], None if parent is None else named[parent],
            **_cpu(pkg))
        assert named[node].parent is (None if parent is None
                                      else named[parent])
        out[pkg] = trs
    assert list(out["torch"]) == list(out["jax"])
    for name in out["jax"]:
        _close(out["torch"][name], out["jax"][name])
    _same_builder(scenes)


def test_reparent_refusals_match():
    scenes = _both()
    errors = {}
    for pkg, (sg, nodes) in scenes.items():
        reparent = TOOLS[pkg].reparent.reparent
        messages = []
        for node, parent in ((nodes["grp"], nodes["child"]),
                             (nodes["bundles"][0], nodes["grp"])):
            with pytest.raises(ValueError) as info:
                reparent(sg, node, parent, **_cpu(pkg))
            messages.append(str(info.value))
        errors[pkg] = messages
    assert errors["torch"] == errors["jax"]
    assert "descendant" in errors["jax"][0]
    assert "would animate static attr b0." in errors["jax"][1]


def test_bake_world_trs_and_local_trs_match():
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        reparent = TOOLS[pkg].reparent
        scene, attrs, ev = _eval(pkg, sg)
        world = reparent.bake_world_trs(scene, attrs, np.arange(F),
                                        nodes["child"].index,
                                        rotate_order=RotateOrder.YXZ)
        local = reparent.local_trs_under_parent(
            ev.tfm_world[nodes["cam"].index],
            ev.tfm_world[nodes["grp"].index], RotateOrder.ZYX)
        out[pkg] = [world[k] for k in sorted(world)] + [
            local[k] for k in sorted(local)]
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)


@pytest.mark.parametrize("frame,scale", [(2, 2.0), (0, 0.5)])
def test_set_camera_origin_frame_matches(frame, scale):
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        out[pkg] = TOOLS[pkg].originframe.set_camera_origin_frame(
            sg, nodes["cam"], origin_frame_index=frame, scene_scale=scale,
            **_cpu(pkg))
    _close(out["torch"], out["jax"])
    _same_builder(scenes)


def test_set_camera_origin_frame_refuses_a_parented_bundle():
    scenes = _both()
    errors = {}
    for pkg, (sg, nodes) in scenes.items():
        nodes["bundles"][3].parent = nodes["newp"]
        with pytest.raises(ValueError) as info:
            TOOLS[pkg].originframe.set_camera_origin_frame(
                sg, nodes["cam"], **_cpu(pkg))
        errors[pkg] = str(info.value)
    assert errors["torch"] == errors["jax"]
    # What was written before the refusal is the same too.
    _same_builder(scenes)


@pytest.mark.parametrize("pivot,frames", [(None, None),
                                          ((1.0, -2.0, 0.5), [1, 3, 4])])
def test_apply_scene_scale_matches(pivot, frames):
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        out[pkg] = TOOLS[pkg].scaleadjust.apply_scene_scale(
            sg, 1.7, pivot=pivot, frame_indices=frames, **_cpu(pkg))
    _close(out["torch"], out["jax"])
    _same_builder(scenes)


def test_marker_tools_match():
    scenes = _both()
    out = {}
    rng = np.random.RandomState(2)
    xy = rng.normal(0.0, 0.2, (3, F, 2))
    enable = (rng.uniform(size=(3, F)) > 0.4).astype(float)
    enable[:, 0] = 0.0
    for pkg, (sg, nodes) in scenes.items():
        mt = TOOLS[pkg].markertools
        markers = nodes["markers"]
        scene, attrs = _bake(pkg, sg)
        fi = np.arange(F)
        values = list(mt.average_marker(xy)) + list(
            mt.average_marker(xy, enable))
        values += list(mt.marker_from_transform(scene, attrs, fi,
                                                nodes["child"].index))
        values.append(mt.reproject_bundle(scene, attrs, fi, 6,
                                          frame_for_depth=3))
        mt.create_average_marker(sg, markers[:4] + markers[7:],
                                 "avg", **_cpu(pkg))
        mt.create_average_marker(sg, markers[4:6], "avg2",
                                 bundle=nodes["bundles"][0], **_cpu(pkg))
        dup = mt.duplicate_marker(sg, markers[2], **_cpu(pkg))
        assert dup.bundle is markers[2].bundle and dup.name == "m2_copy"
        values.append(mt.rename_markers_and_bundles(markers[4:6], "trk"))
        out[pkg] = values
    for got, want in zip(out["torch"][:-1], out["jax"][:-1]):
        _close(got, want)
    assert out["torch"][-1] == out["jax"][-1]
    _same_builder(scenes)


def _plane(z, half=60.0, quads=4):
    """A square grid of quads on the plane at depth z, facing +z."""
    side = np.linspace(-half, half, quads + 1)
    xs, ys = np.meshgrid(side, side)
    vertices = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, z)], -1)
    tris = []
    n = quads + 1
    for r in range(quads):
        for c in range(quads):
            a = r * n + c
            tris += [[a, a + 1, a + n + 1], [a, a + n + 1, a + n]]
    return vertices, np.asarray(tris, np.int32)


def test_raycast_matches():
    scenes = _both()
    vertices, triangles = _plane(-6.0)
    behind = vertices + [0.0, 0.0, 30.0]  # behind the camera: no hits
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        rc = TOOLS[pkg].raycast
        scene, attrs = _bake(pkg, sg)
        origins, directions = rc.marker_rays(scene, attrs, np.arange(F))
        sub = rc.marker_rays(scene, attrs, np.arange(F), [5, 1])
        pos, hit = rc.raycast_markers_to_mesh(scene, attrs, 3, vertices,
                                              triangles)
        _, miss = rc.raycast_markers_to_mesh(scene, attrs, 3, behind,
                                             triangles)
        _, short = rc.raycast_markers_to_mesh(scene, attrs, 3, vertices,
                                              triangles, max_distance=5.0)
        applied = rc.apply_raycast_bundles(sg, 2, vertices, triangles,
                                           **_cpu(pkg))
        out[pkg] = [origins, directions, sub[0], sub[1], pos, hit, miss,
                    short, applied]
    assert np.asarray(out["jax"][5]).all()
    assert not np.asarray(out["jax"][6]).any()
    assert not np.asarray(out["jax"][7]).any()
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)
    _same_builder(scenes)


def test_raycast_refuses_a_parented_bundle():
    scenes = _both()
    vertices, triangles = _plane(-6.0)
    errors = {}
    for pkg, (sg, nodes) in scenes.items():
        nodes["bundles"][4].parent = nodes["newp"]
        with pytest.raises(ValueError) as info:
            TOOLS[pkg].raycast.apply_raycast_bundles(
                sg, 0, vertices, triangles, **_cpu(pkg))
        errors[pkg] = str(info.value)
    assert errors["torch"] == errors["jax"]
    assert "must be a root node" in errors["jax"]


def test_deform_markers_match():
    scenes = _both()
    out = {}
    for pkg, (sg, nodes) in scenes.items():
        dm = TOOLS[pkg].deformmarker
        scene, attrs = _bake(pkg, sg)
        lens = _bake_lens(pkg, sg)
        fi = np.arange(F)
        deformed = dm.deform_markers(scene, attrs, lens, fi)
        undistorted = dm.deform_markers(scene, attrs, lens, fi,
                                        direction="undistort")
        restored = dm.remove_marker_deform(scene, deformed, lens, fi)
        with pytest.raises(ValueError, match="distort|undistort"):
            dm.deform_markers(scene, attrs, lens, fi, direction="sideways")
        out[pkg] = [b.anim_values for b in (deformed, undistorted,
                                            restored)] + [
            deformed.static_values]
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)
    # The lens moved the tracks.
    assert np.abs(np.asarray(out["jax"][0])
                  - np.asarray(out["jax"][2])).max() > 1e-4


@pytest.mark.parametrize("name", BAKING_TOOLS)
def test_baking_tool_defaults_to_cuda(name):
    """A tool that bakes a SceneGraph takes device="cuda" by default:
    without a CUDA device it raises and writes nothing."""
    import inspect

    module, fn_name = name.split(".")
    fn = getattr(getattr(t_tools, module), fn_name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert (inspect.signature(fn).parameters["device"].kind
            is inspect.Parameter.KEYWORD_ONLY)
    if torch.cuda.is_available():
        return
    sg, nodes = tool_scene("torch")
    before = sg._attr_builder.bake(device="cpu")
    vertices, triangles = _plane(-6.0)
    args = {
        "centertwodee.apply_center": (sg, nodes["cam"], [0], [0, 0, -5.0]),
        "markertools.create_average_marker": (sg, nodes["markers"][:2]),
        "markertools.duplicate_marker": (sg, nodes["markers"][0]),
        "originframe.set_camera_origin_frame": (sg, nodes["cam"]),
        "raycast.apply_raycast_bundles": (sg, 0, vertices, triangles),
        "reparent.reparent": (sg, nodes["child"], nodes["newp"]),
        "scaleadjust.apply_scene_scale": (sg, 2.0),
    }[name]
    with pytest.raises((RuntimeError, AssertionError)):
        fn(*args)
    after = sg._attr_builder.bake(device="cpu")
    _close(after.static_values, to_numpy(before.static_values), 0)
    _close(after.anim_values, to_numpy(before.anim_values), 0)
