"""Agreement of the port's host-side tools, camera file and module
surface with the JAX package's.

The numpy tools (curves, surfacecluster, subdivideline, imageplane,
deviation, attributebake, copypastemarker) and io/camerafile.py are
copies of the reference's host code on the port's SceneGraph, io and
utils.  Here, on seeded inputs in both packages:

  * every returned array equal at 1e-10, and the SceneGraph builder's
    values after a tool, baked, equal at 1e-10;
  * uvtrack text and files of copy_markers_* and .mmcamera files byte
    for byte equal; deviation JSON and CSV equal at 1e-10;
  * the reference's own cases of these tools
    (tests/test_tools/test_tail_tools.py but its deform case,
    test_imageplane_deviation.py, tests/test_io/test_camerafile.py) run
    on the port;
  * every public name of the reference's tools/, core/line.py and
    io/camerafile.py exists in the port, and the port's tools package
    imports the fifteen modules the reference's does.
"""

import csv
import importlib
import inspect
import json

import numpy as np
import pytest

import mayamatchmovesolver_torch.io.camerafile as t_camerafile
import mayamatchmovesolver_torch.solver.results as t_results
import mayamatchmovesolver_torch.tools as t_tools
import mayamatchmovesolver_tpu.io.camerafile as j_camerafile
import mayamatchmovesolver_tpu.solver.results as j_results
import mayamatchmovesolver_tpu.tools as j_tools
from _torch_port_cases import PACKAGES, _bake, to_numpy
from _torch_reference_cases import port_cases, public_names
from mayamatchmovesolver_tpu.core.constants import FilmFit

TOL = 1e-10
F = 6
TOOLS = {"jax": j_tools, "torch": t_tools}
CAMERAFILE = {"jax": j_camerafile, "torch": t_camerafile}
RESULTS = {"jax": j_results, "torch": t_results}
TOOL_MODULES = ("attributebake", "centertwodee", "copypastemarker",
                "curves", "deformmarker", "deviation", "imageplane",
                "markertools", "originframe", "raycast", "reparent",
                "scaleadjust", "screenspace", "subdivideline",
                "surfacecluster")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


def line_scene(pkg):
    """Four markers on a line under an animated camera, tracks seeded;
    returns (sg, cam, markers, line)."""
    scene_mod, _ = PACKAGES[pkg]
    rng = np.random.RandomState(8)
    sg = scene_mod.SceneGraph(frame_range=(1, F))
    cam = sg.create_camera("cam", tx=np.linspace(-1, 1, F), tz=10.0,
                           ry=np.linspace(-4, 4, F), render_width=1920,
                           render_height=1080, focal_length_mm=40.0)
    markers = []
    for i in range(4):
        bnd = sg.create_bundle("b%d" % i, tx=rng.uniform(-2, 2),
                               ty=rng.uniform(-1, 1), tz=rng.uniform(-7, -4))
        markers.append(sg.create_marker(
            "m%d" % i, camera=cam, bundle=bnd,
            tx=rng.uniform(-0.4, 0.4, F), ty=rng.uniform(-0.2, 0.2, F),
            weight=rng.uniform(0.5, 1.0, F),
            enable=(rng.uniform(size=F) > 0.2).astype(float)))
    line = sg.create_line("line0", markers)
    return sg, cam, markers, line


def _same_builder(sgs):
    baked = {pkg: _bake(pkg, sg) for pkg, sg in sgs.items()}
    for field in ("static_values", "anim_values"):
        _close(getattr(baked["torch"][1], field),
               getattr(baked["jax"][1], field))
    assert sorted(sgs["torch"]._names) == sorted(sgs["jax"]._names)


@pytest.mark.parametrize("case", port_cases(
    "tests/test_tools/test_tail_tools.py",
    ("test_curve_point_interpolates_endpoints",
     "test_closest_point_on_curve_straight_line",
     "test_attach_bundle_to_curve_moves_bundle",
     "test_subdivide_line_inserts_midpoints",
     "test_copy_paste_marker_roundtrip", "test_uvtrack_writer_versions",
     "test_closest_point_on_triangles_inside_and_edge",
     "test_rivet_follows_animated_mesh", "test_two_edge_rivet",
     "test_surface_cluster_deform_follows_surface",
     "test_link_and_unlink_marker_bundle", "test_toggle_locks",
     "test_aim_at_target_points_camera"),
) + port_cases(
    "tests/test_tools/test_imageplane_deviation.py",
    ("test_image_plane_size_similar_triangles",
     "test_image_plane_corners_project_to_screen_corners",
     "test_create_image_plane_in_scene_graph", "test_image_sequence_paths",
     "test_fit_to_render_resolution", "test_deviation_stats_and_exports"),
    # The port's AttrBlock is a dataclass and its projection_matrix
    # takes tensors throughout.
    replace=(("attrs._replace(static_values=",
              "dataclasses.replace(attrs, static_values="),
             ("1500.0, 1000.0,  # render aspect == film aspect (36/24)\n"
              "        int(FilmFit.HORIZONTAL),",
              "jnp.asarray(1500.0), jnp.asarray(1000.0),\n"
              "        jnp.asarray(int(FilmFit.HORIZONTAL)),")),
) + port_cases(
    "tests/test_io/test_camerafile.py",
    ("test_write_read_roundtrip", "test_create_camera_from_file"),
))
def test_reference_case_on_the_port(case, tmp_path):
    if "tmp_path" in inspect.signature(case).parameters:
        case(tmp_path=tmp_path)
    else:
        case()


def test_curves_match():
    rng = np.random.RandomState(1)
    ctrl = rng.normal(0.0, 2.0, (6, 3))
    out = {}
    sgs = {}
    for pkg in ("jax", "torch"):
        curves = TOOLS[pkg].curves
        sg, _, markers, _ = line_scene(pkg)
        values = [curves.curve_point(ctrl, 0.37),
                  curves.curve_point(ctrl, np.linspace(0, 1, 11), degree=2)]
        values += list(curves.closest_point_on_curve(
            ctrl, np.array([0.5, -0.3, 1.0]), degree=3))
        values += list(curves.attach_bundle_to_curve(
            sg, markers[0].bundle, ctrl, degree=3))
        values.append(curves.move_bundle_along_curve(
            sg, markers[1].bundle, ctrl, 1.4, degree=2))
        out[pkg], sgs[pkg] = values, sg
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)
    _same_builder(sgs)


def test_surfacecluster_matches():
    rng = np.random.RandomState(2)
    xs, ys = np.meshgrid(np.linspace(0, 3, 4), np.linspace(0, 2, 3))
    vertices = np.stack([xs.ravel(), ys.ravel(),
                         rng.normal(0.0, 0.1, xs.size)], -1)
    triangles = np.array([[r * 4 + c, r * 4 + c + 1, r * 4 + c + 5]
                          for r in range(2) for c in range(3)]
                         + [[r * 4 + c, r * 4 + c + 5, r * 4 + c + 4]
                            for r in range(2) for c in range(3)])
    anim = np.stack([vertices + [0.1 * k, 0.0, 0.2 * k] for k in range(3)])
    out = {}
    for pkg in ("jax", "torch"):
        sc = TOOLS[pkg].surfacecluster
        point, ti, bary = sc.closest_point_on_triangles(
            vertices, triangles, np.array([1.3, 0.7, 0.4]))
        rivet = sc.rivet_frames(anim, triangles, ti, bary)
        two = sc.two_edge_rivet(vertices, (0, 1), (4, 5))
        cluster = sc.create_surface_cluster(vertices, triangles, 5, 1.5)
        moved = sc.apply_surface_cluster(cluster, anim, triangles,
                                         np.array([0.2, 0.5, -0.1]))
        out[pkg] = ([point, ti, bary] + [rivet[k] for k in sorted(rivet)]
                    + [two[k] for k in sorted(two)]
                    + [cluster["weights"], moved,
                       sc.surface_cluster_weights(vertices, 3, 2.0)])
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)


def test_subdivide_line_matches():
    out, sgs = {}, {}
    for pkg in ("jax", "torch"):
        sg, _, markers, line = line_scene(pkg)
        new_line, members, created = TOOLS[pkg].subdivideline.subdivide_line(
            sg, line, name_prefix="mid")
        out[pkg] = ([m.name for m in members], [m.name for m in created],
                    new_line.name)
        sgs[pkg] = sg
    assert out["torch"] == out["jax"]
    _same_builder(sgs)


def test_imageplane_matches(tmp_path):
    out, sgs = {}, {}
    for pkg in ("jax", "torch"):
        ip = TOOLS[pkg].imageplane
        sg, cam, _, _ = line_scene(pkg)
        size = ip.image_plane_size(35.0, 36.0, 24.0, 7.5, 0.4, -0.2)
        corners, uvs = ip.image_plane_corners(50.0, 24.0, 18.0, 3.0, 0.1, 0.3)
        node, info = ip.create_image_plane(sg, cam, depth=6.0,
                                           name="plate_%s" % pkg[0])
        fits = [ip.fit_to_render_resolution(size, 2048, 858, fit)
                for fit in FilmFit]
        paths = ip.image_sequence_paths(str(tmp_path / "p.####.exr"),
                                        [1, 9, 1001])
        out[pkg] = (size, corners, uvs, info, fits, paths)
        sg._names.discard(node.name)  # names differ by package only
        sgs[pkg] = sg
    got, want = out["torch"], out["jax"]
    assert got[0] == want[0] and got[3] == want[3] and got[4] == want[4]
    assert got[5] == want[5]
    _close(got[1], want[1])
    _close(got[2], want[2])
    baked = {pkg: _bake(pkg, sg) for pkg, sg in sgs.items()}
    _close(baked["torch"][1].static_values, baked["jax"][1].static_values)


def test_attributebake_matches():
    rng = np.random.RandomState(6)
    frames = np.arange(40, dtype=np.float64)
    values = np.cumsum(rng.normal(0.0, 0.3, 40))
    out = {}
    for pkg in ("jax", "torch"):
        ab = TOOLS[pkg].attributebake
        curve = importlib.import_module(
            "mayamatchmovesolver_%s.utils.animcurve" % pkg.replace(
                "jax", "tpu")).AnimCurve([1, 8, 20], [0.0, 2.0, -1.0])
        out[pkg] = [
            ab.bake_frame_range("custom", (1, 50), (5, 9)),
            ab.bake_frame_range("timeline", (1, 50)),
            ab.bake_curve(curve, (1, 25)),
            *ab.smart_bake_keys(frames, values, 0.05),
            ab.smooth_keyframes(values, "average", 3.0),
            ab.smooth_keyframes(values, "fourier", 4.0,
                                blend=np.linspace(0, 1, 40)),
        ]
    assert out["torch"][:2] == out["jax"][:2]
    for got, want in zip(out["torch"][2:], out["jax"][2:]):
        _close(got, want)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_copy_markers_text_and_files_byte_equal(tmp_path, version):
    text, blobs = {}, {}
    for pkg in ("jax", "torch"):
        cpm = TOOLS[pkg].copypastemarker
        sg, _, markers, _ = line_scene(pkg)
        text[pkg] = cpm.copy_markers_to_string(sg, markers, version=version)
        path = cpm.copy_markers_to_file(sg, markers[1:3],
                                        str(tmp_path / (pkg + ".uv")),
                                        version=version)
        with open(path, "rb") as f:
            blobs[pkg] = f.read()
    assert text["torch"] == text["jax"]
    assert blobs["torch"] == blobs["jax"]


def test_marker_data_and_paste_match():
    out, sgs = {}, {}
    for pkg in ("jax", "torch"):
        cpm = TOOLS[pkg].copypastemarker
        sg, cam, markers, _ = line_scene(pkg)
        md = cpm.marker_to_marker_data(sg, markers[2],
                                       uv_from_marker_space=False)
        text = cpm.copy_markers_to_string(sg, markers[:3])
        created = cpm.paste_markers(sg, cam, text)
        created += cpm.paste_markers(sg, cam, text)  # renamed on repeat
        out[pkg] = ([(m.name, b.name) for m, b in created],
                    {f: md.x.get_value(f) for f in md.x.get_times()},
                    md.bundle_z)
        sgs[pkg] = sg
    assert out["torch"] == out["jax"]
    _same_builder(sgs)


def test_camera_file_bytes_and_paste_match(tmp_path):
    blobs, read, sgs = {}, {}, {}
    image = {"file_path": "/plates/sh020.####.exr", "width": 1920,
             "height": 1080, "pixel_aspect_ratio": 1.0}
    for pkg in ("jax", "torch"):
        cf = CAMERAFILE[pkg]
        sg, cam, _, _ = line_scene(pkg)
        _, attrs = _bake(pkg, sg)
        path = str(tmp_path / (pkg + cf.EXT))
        cf.write_camera(path, cam, attrs, sg.frame_range, image=image)
        with open(path, "rb") as f:
            blobs[pkg] = f.read()
        data = cf.read_camera(path)
        read[pkg] = (data.name, data.frame_range, data.image,
                     {k: v.tolist() for k, v in data.channels.items()})
        scene_mod, _ = PACKAGES[pkg]
        sg2 = scene_mod.SceneGraph(frame_range=(1, F))
        cam2 = cf.create_camera_from_file(sg2, path, near_clip_cm=0.5)
        bnd = sg2.create_bundle("b", tz=-5.0)
        sg2.create_marker("m", camera=cam2, bundle=bnd)
        sgs[pkg] = sg2
    assert blobs["torch"] == blobs["jax"]
    assert read["torch"] == read["jax"]
    _same_builder(sgs)


def _result(pkg, seed):
    """A SolverResult of either package from seeded per-frame and
    per-marker deviations (one marker with no frames)."""
    rng = np.random.RandomState(seed)
    res = RESULTS[pkg]
    frames = list(range(1001, 1009))
    per_marker = {
        "mk%d" % i: res.FrameErrorList(
            frames=frames[i:], errors=list(rng.uniform(0, 3, 8 - i)))
        for i in range(4)}
    per_marker["empty"] = res.FrameErrorList()
    return res.SolverResult(
        error_final=float(rng.uniform(0, 1)),
        per_frame_error=res.FrameErrorList(
            frames=frames, errors=list(rng.uniform(0, 2, 8))),
        per_marker_error=per_marker)


def test_deviation_matches(tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        dev = TOOLS[pkg].deviation
        result = _result(pkg, 9)
        stats = dev.deviation_stats(result)
        worst = dev.worst_markers(result, count=3)
        written = dev.write_deviation_json(str(tmp_path / (pkg + ".json")),
                                           result)
        with open(str(tmp_path / (pkg + ".json"))) as f:
            loaded = json.load(f)
        frames, names = dev.write_deviation_csv(
            str(tmp_path / (pkg + ".csv")), result)
        with open(str(tmp_path / (pkg + ".csv"))) as f:
            rows = list(csv.reader(f))
        out[pkg] = (stats, worst, written, loaded, frames, names, rows)
    got, want = out["torch"], out["jax"]
    assert got[1] == want[1] and got[4:6] == want[4:6]
    assert got[6][0] == want[6][0] and len(got[6]) == len(want[6])
    for g_row, w_row in zip(got[6][1:], want[6][1:]):
        _close([float(v or "nan") for v in g_row],
               [float(v or "nan") for v in w_row])
    for g, w in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        _close_tree(g, w)


def _close_tree(got, want):
    """Nested dicts and lists equal, floats at 1e-10 (NaN == NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    else:
        assert got == want


@pytest.mark.parametrize("name", ["tools." + m for m in TOOL_MODULES]
                         + ["core.line", "io.camerafile"])
def test_module_keeps_every_public_name(name):
    j_mod = importlib.import_module("mayamatchmovesolver_tpu." + name)
    t_mod = importlib.import_module("mayamatchmovesolver_torch." + name)
    missing = public_names(j_mod) - set(vars(t_mod))
    assert not missing, missing
    for attr in public_names(j_mod):
        j_value, t_value = getattr(j_mod, attr), getattr(t_mod, attr)
        if inspect.isfunction(j_value):
            j_params = list(inspect.signature(j_value).parameters)
            t_params = list(inspect.signature(t_value).parameters)
            # Same arguments in the same order; a tool that bakes a
            # SceneGraph adds its keyword-only device.
            assert t_params[:len(j_params)] == j_params, attr
            assert t_params[len(j_params):] in ([], ["device"]), attr


def test_tools_package_imports_the_fifteen_modules():
    for pkg, tools in TOOLS.items():
        assert {name for name in TOOL_MODULES
                if inspect.ismodule(getattr(tools, name, None))} == set(
                    TOOL_MODULES), pkg
    assert t_tools.__doc__.split("Module map")[1] == (
        j_tools.__doc__.split("Module map")[1])
