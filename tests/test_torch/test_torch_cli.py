"""The port's command line against the JAX package's.

Deterministic verbs: the same argv (plus --device cpu on the port's
side) goes to both CLIs on the reference's fixture
(tests/test_cli/test_cli.py::_write_uvtrack, 6 x 6): the same exit
codes, the same stdout (timer lines aside; numbers at 1e-8), JSON files
at 1e-8 and EXR pixels at 2e-5.

The RANSAC verbs (camera-solve, relative-pose, pose-from-points) and
homography run on the port only: the port draws its RANSAC samples from
seeded torch generators, not jax.random, and the homography's DLT
eigenvector has a free sign.  Each verb's JSON must equal what the
port's own function (held against the reference elsewhere) gives on the
same input, and recover the fixture's truth as the reference's tests
demand.  The fixture's other sizes are written by a copy of
_write_uvtrack on the port's engine, held against the reference's at
6 x 6.

Error paths give the same message from both CLIs; the sharded solver
types, which the port lacks, stop with its NotImplementedError message;
and --device cuda without a card stops before any work.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.ops.stmap as t_stmap
from mayamatchmovesolver_torch import cli as t_cli
from mayamatchmovesolver_torch.utils.profiler import counters
from mayamatchmovesolver_tpu import cli as j_cli
from mayamatchmovesolver_tpu.core.constants import FilmFit
from mayamatchmovesolver_tpu.io import exr as j_exr
from tests.test_cli.test_cli import _write_uvtrack as _write_uvtrack_jax

CLIS = {"jax": j_cli, "torch": t_cli}
JSON_TOL = 1e-8
EXR_TOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_uvtrack(path, n_frames=6, n_markers=6, with_3d=True,
                   planar=False):
    """tests/test_cli/test_cli.py::_write_uvtrack on the port's scene
    engine; with planar=True the bundles and camera path of
    tests/test_cli/test_cli_sfm.py::test_homography_verb_planar_scene.
    Returns the bundle positions."""
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import marker_fit_scale

    rng = np.random.RandomState(11 if planar else 3)
    bundles = rng.uniform(-1.5, 1.5, (n_markers, 3))
    t = np.linspace(0.0, 1.0, n_frames)
    if planar:
        bundles[:, 2] = 0.0
        path_trs = dict(tx=1.5 * t, ty=0.2 * t, tz=10.0 - t,
                        rx=np.zeros(n_frames), ry=8.0 * t,
                        rz=np.zeros(n_frames))
    else:
        bundles[:, 2] *= 0.5
        path_trs = dict(tx=0.4 * t, ty=0.1 * t, tz=10.0 + 0.5 * t,
                        rx=np.zeros(n_frames), ry=2.0 * t,
                        rz=np.zeros(n_frames))
    sg = SceneGraph(frame_range=(1, n_frames))
    cam = sg.create_camera(
        "cam", **path_trs,
        focal_length_mm=35.0, sensor_width_mm=36.0,
        sensor_height_mm=24.0, film_fit=FilmFit.HORIZONTAL,
        render_width=1920, render_height=1080,
    )
    for i, b in enumerate(bundles):
        bnd = sg.create_bundle("b%d" % i, tx=b[0], ty=b[1], tz=b[2])
        sg.create_marker("m%d" % i, camera=cam, bundle=bnd)
    scene, attrs = sg.bake(device="cpu")
    frames = torch.arange(n_frames)
    point_xy = evaluate(scene, attrs, frames).point_xy.numpy()
    fsx, fsy = (s.numpy() for s in marker_fit_scale(scene, attrs, frames))
    marker_xy = np.stack([point_xy[..., 0] / fsx, point_xy[..., 1] / fsy],
                         axis=-1) + 0.5  # (M, F, 2) in [0, 1]
    points = []
    for i in range(n_markers):
        per_frame = [
            {"frame": int(f + 1),
             "pos": [float(marker_xy[i, f, 0]), float(marker_xy[i, f, 1])],
             "pos_dist": [float(marker_xy[i, f, 0]),
                          float(marker_xy[i, f, 1])],
             "weight": 1.0}
            for f in range(n_frames)
        ]
        entry = {"name": "m%d" % i, "id": i, "set_name": "set",
                 "per_frame": per_frame}
        if with_3d:
            entry["3d"] = {
                "x": float(bundles[i, 0]), "y": float(bundles[i, 1]),
                "z": float(bundles[i, 2]),
                "x_lock": True, "y_lock": True, "z_lock": True,
            }
        points.append(entry)
    with open(path, "w") as f:
        json.dump({"version": 4, "points": points}, f)
    return bundles


@pytest.fixture(scope="module")
def shot(tmp_path_factory):
    """The fixture files: the reference's 6 x 6 shot with 3D blocks, the
    port writer's 2 x 2 (unsolvable per frame), 10 x 12 and 6 x 10 (no
    3D), 4 x 5 (too few for RANSAC) and the planar 4 x 9 shot; an
    initial camera, a solved camera and points, an EXR plate."""
    d = tmp_path_factory.mktemp("cli")
    _write_uvtrack_jax(str(d / "m6.uv"))
    _write_uvtrack(str(d / "m2.uv"), 2, 2, with_3d=False)
    bundles = {
        "m10": _write_uvtrack(str(d / "m10.uv"), 10, 12, with_3d=False),
        "m6x10": _write_uvtrack(str(d / "m6x10.uv"), 6, 10, with_3d=False),
    }
    _write_uvtrack(str(d / "m4.uv"), 4, 5, with_3d=False)
    _write_uvtrack(str(d / "planar.uv"), 4, 9, with_3d=False, planar=True)
    with open(d / "init.json", "w") as f:
        json.dump({"camera": {"tz": 9.5}}, f)
    with open(d / "cam.json", "w") as f:
        json.dump({"frames": [1, 2, 3], "camera": {
            "tx": [0.0, 0.1, 0.2], "ty": [0.0, 0.0, 0.0],
            "tz": [10.0, 10.0, 10.0], "rx": [0.0, 0.0, 0.0],
            "ry": [0.0, 1.0, 2.0], "rz": [0.0, 0.0, 0.0]}}, f)
    with open(d / "pts.json", "w") as f:
        json.dump({"points": {"positions": [[0.0, 0.0, 0.0],
                                            [1.0, -0.5, 0.3]]}}, f)
    img = np.random.RandomState(0).rand(36, 48, 3).astype(np.float32)
    j_exr.write_pixels(str(d / "plate.exr"), img)
    j_exr.write_pixels(str(d / "rgba.exr"),
                       np.random.RandomState(1).rand(20, 31, 4)
                       .astype(np.float32))
    return str(d), bundles


def test_port_fixture_writer_matches_the_reference(shot, tmp_path):
    d, _ = shot
    _write_uvtrack(str(tmp_path / "port.uv"))
    with open(os.path.join(d, "m6.uv")) as f:
        want = json.load(f)
    with open(tmp_path / "port.uv") as f:
        got = json.load(f)
    _assert_json_close(got, want, 1e-12)


def _assert_json_close(got, want, tol, path="$"):
    """Same structure and key order; numbers within tol; the rest
    equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_json_close(got[k], want[k], tol, path + "." + k)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, tol, "%s[%d]" % (path, i))
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, (path, got, want)
    else:
        assert not isinstance(got, (bool, str)), path
        assert abs(got - want) <= tol, (path, got, want)


def _run(cli, argv, capsys):
    """(exit code, or the SystemExit message; stdout lines)."""
    try:
        rc = cli.main(argv)
    except SystemExit as exc:
        rc = "SystemExit: %s" % exc
    return rc, capsys.readouterr().out.splitlines()


def _assert_lines_close(got, want):
    """stdout: the same lines, timers aside; a line of JSON or a
    key=value line with numbers compares them at JSON_TOL."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if w.startswith(("{", "[")):
            _assert_json_close(json.loads(g), json.loads(w), JSON_TOL)
        elif "=" in w and not w.startswith("wrote"):
            key, value = w.split("=", 1)
            g_key, g_value = g.split("=", 1)
            assert g_key == key
            if key.startswith("timer_"):
                continue
            for gv, wv in zip(g_value.split(","), value.split(",")):
                try:
                    assert abs(float(gv) - float(wv)) <= JSON_TOL, (g, w)
                except ValueError:
                    assert gv == wv, (g, w)
        else:
            assert g == w


# name: (argv with {d} the fixture folder and {out} a per-package file
# prefix, whether the verb takes --device, the files it writes).
DETERMINISTIC = {
    "formats": (["formats"], False, []),
    "solver-types": (["solver-types"], False, []),
    "validate": (["validate", "--markers", "{d}/m6.uv", "--output",
                  "{out}v.json"], True, ["v.json"]),
    "validate-unsolvable-per-frame": (
        ["validate", "--markers", "{d}/m2.uv", "--output", "{out}v.json"],
        True, ["v.json"]),
    "affects": (["affects", "--markers", "{d}/m6.uv", "--start-frame", "2",
                 "--end-frame", "5", "--output", "{out}a.json"], False,
                ["a.json"]),
    "camera-matrix": (["camera-matrix", "--trs", "1", "2", "10", "0", "15",
                       "0", "--focal-length", "50", "--output",
                       "{out}m.json"], True, ["m.json"]),
    "reproject-marker": (["reproject", "--camera", "{d}/cam.json",
                          "--points", "{d}/pts.json", "--output",
                          "{out}r.json"], True, ["r.json"]),
    "reproject-normalized": (["reproject", "--camera", "{d}/cam.json",
                              "--points", "{d}/pts.json", "--space",
                              "normalized", "--output", "{out}r.json"],
                             True, ["r.json"]),
    "reproject-pixels": (["reproject", "--camera", "{d}/cam.json",
                          "--points", "{d}/pts.json", "--space", "pixels",
                          "--image-width", "2048", "--image-height",
                          "1556", "--output", "{out}r.json"], True,
                         ["r.json"]),
    "calibrate-two-vp": (["calibrate", "--origin-point", "0.0", "0.0",
                          "--principal-point", "0.01", "-0.02",
                          "--vanishing-point-a", "0.55", "0.3",
                          "--vanishing-point-b", "-0.6", "0.25",
                          "--focal-length", "50.0", "--output",
                          "{out}c.json"], True, ["c.json"]),
    "calibrate-one-vp": (["calibrate", "--origin-point", "0.05", "-0.1",
                          "--vanishing-point-a", "0.55", "0.3",
                          "--horizon", "-0.5", "0.2", "0.5", "0.25",
                          "--scene-scale-mode", "1",
                          "--scene-scale-distance", "150", "--output",
                          "{out}c.json"], True, ["c.json"]),
    "lensdistort-classic-undistort": (
        ["lensdistort", "--distortion", "0.08", "--width", "64",
         "--height", "36", "--direction", "undistort", "--output",
         "{out}st.exr"], True, ["st.exr"]),
    "lensdistort-classic-distort": (
        ["lensdistort", "--distortion", "0.1", "--curvature-x", "0.02",
         "--quartic-distortion", "0.03", "--anamorphic-squeeze", "1.05",
         "--width", "48", "--height", "36", "--output", "{out}st.exr"],
        True, ["st.exr"]),
    "lensdistort-radial": (
        ["lensdistort", "--model", "tde_radial_std_deg4", "--distortion",
         "0.05", "--quartic-distortion", "0.01", "--width", "40",
         "--height", "30", "--output", "{out}st.exr"], True, ["st.exr"]),
    "image-info": (["image-info", "{d}/rgba.exr", "--pixel", "5", "7"],
                   False, []),
    "image-convert": (["image-convert", "{d}/rgba.exr", "{out}c.exr",
                       "--scale", "1.5"], False, ["c.exr"]),
    "image-warp-stmap": (["image-warp", "{d}/plate.exr", "--stmap",
                          "{d}/st.exr", "--output", "{out}w.exr"], True,
                         ["w.exr"]),
    "image-warp-lens": (["image-warp", "{d}/plate.exr", "--distortion",
                         "0.1", "--direction", "undistort", "--output",
                         "{out}w.exr"], True, ["w.exr"]),
    "solve-per-frame": (["solve", "--markers", "{d}/m6.uv", "--output",
                         "{out}s.json", "--iterations", "40", "--camera",
                         "{d}/init.json"], True, ["s.json"]),
    "solve-ba-schur": (["solve", "--markers", "{d}/m6.uv", "--output",
                        "{out}s.json", "--iterations", "40", "--camera",
                        "{d}/init.json", "--solver-type", "ba_schur"], True,
                       ["s.json"]),
}


@pytest.mark.parametrize("case", list(DETERMINISTIC))
def test_deterministic_verb_matches_the_reference(shot, tmp_path, capsys,
                                                  case):
    d, _ = shot
    argv, takes_device, files = DETERMINISTIC[case]
    if case == "image-warp-stmap":
        j_cli.main(["lensdistort", "--distortion", "0.1", "--width", "48",
                    "--height", "36", "--output", os.path.join(d, "st.exr")])
        capsys.readouterr()
    _assert_verb_matches(d, tmp_path, capsys, argv, takes_device, files)


def _assert_verb_matches(d, tmp_path, capsys, argv, takes_device, files):
    """The verb through both CLIs: the same exit code and output lines,
    numbers within the tolerances, and the same files."""
    runs = {}
    for pkg, cli in CLIS.items():
        out = str(tmp_path / pkg) + "_"
        args = [a.format(d=d, out=out) for a in argv]
        if pkg == "torch" and takes_device:
            args += ["--device", "cpu"]
        rc, lines = _run(cli, args, capsys)
        runs[pkg] = rc, [line.replace(out, "<out>") for line in lines]
    (j_rc, j_lines), (t_rc, t_lines) = runs["jax"], runs["torch"]
    assert t_rc == j_rc
    _assert_lines_close(t_lines, j_lines)
    for name in files:
        want, got = (str(tmp_path / pkg) + "_" + name
                     for pkg in ("jax", "torch"))
        if name.endswith(".json"):
            with open(want) as f, open(got) as g:
                _assert_json_close(json.load(g), json.load(f), JSON_TOL)
        else:
            (w_img, w_head), (g_img, g_head) = (j_exr.read_pixels(p)
                                                for p in (want, got))
            assert g_head["compression"] == w_head["compression"]
            assert g_img.shape == w_img.shape
            np.testing.assert_allclose(g_img, w_img, rtol=0, atol=EXR_TOL)


def _port_json(argv, tmp_path, capsys):
    out = str(tmp_path / "port.json")
    assert t_cli.main(argv + ["--output", out, "--device", "cpu"]) == 0
    capsys.readouterr()
    with open(out) as f:
        return json.load(f)


def _bearings(path, frames, focal=35.0):
    """The fixture's CV bearings at `frames` (1-based), as the CLI makes
    them (raw marker space with the film-back aspect)."""
    from mayamatchmovesolver_torch.io import read
    from mayamatchmovesolver_torch.sfm import camerasolve

    _, mkr_data = read(path, image_width=1920, image_height=1080)
    uv = np.array([[[md.x.get_value(f) - 0.5, md.y.get_value(f) - 0.5]
                    for f in frames] for md in mkr_data])
    return camerasolve.markers_to_bearings(torch.as_tensor(uv), focal,
                                           36.0, 36.0 / 24.0)


def test_camera_solve_verb_equals_the_ports_camera_solve(shot, tmp_path,
                                                         capsys):
    from mayamatchmovesolver_torch.sfm import camerasolve

    d, _ = shot
    got = _port_json(["camera-solve", "--markers", d + "/m10.uv"], tmp_path,
                     capsys)
    # What the reference's test demands: every frame and name present,
    # and here every frame solved and every point valid (exact tracks).
    assert got["frames"] == list(range(1, 11))
    assert all(got["camera"]["frame_solved"])
    assert all(got["points"]["valid"])
    assert got["points"]["names"] == ["m%d" % i for i in range(12)]
    from mayamatchmovesolver_torch.io import read

    _, mkr_data = read(d + "/m10.uv", image_width=1920, image_height=1080)
    uv, enable, _ = t_cli._marker_arrays(mkr_data, 1, 10)
    want = camerasolve.set_origin_frame(camerasolve.camera_solve(
        uv, enable, device="cpu"))
    for key, value in (("positions", want.positions),
                       ("rotations", want.rotations)):
        np.testing.assert_allclose(got["camera"][key], value.numpy(),
                                   rtol=0, atol=JSON_TOL)
    np.testing.assert_allclose(got["points"]["positions"],
                               want.points3d.numpy(), rtol=0, atol=JSON_TOL)


def test_relative_pose_verb_equals_the_ports_robust_pose(shot, tmp_path,
                                                         capsys):
    from mayamatchmovesolver_torch.sfm import twoview

    d, _ = shot
    got = _port_json(["relative-pose", "--markers", d + "/m10.uv",
                      "--frame-a", "1", "--frame-b", "10"], tmp_path, capsys)
    bearings = _bearings(d + "/m10.uv", (1, 10))
    want = twoview.robust_relative_pose(bearings[:, 0], bearings[:, 1])
    for key in ("rotation", "translation", "essential"):
        np.testing.assert_allclose(got[key], getattr(want, key).numpy(),
                                   rtol=0, atol=JSON_TOL)
    # The reference test's demands: exact projections, so every shared
    # marker an inlier, and a proper rigid transform.
    assert got["num_inliers"] == 12 and len(got["inlier_markers"]) == 12
    r = np.asarray(got["rotation"])
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got["translation"]), 1.0,
                               atol=1e-6)


def test_homography_verb_equals_the_ports_dlt(shot, tmp_path, capsys):
    from mayamatchmovesolver_torch.sfm import twoview

    d, _ = shot
    got = _port_json(["homography", "--markers", d + "/planar.uv",
                      "--frame-a", "1", "--frame-b", "4"], tmp_path, capsys)
    bearings = _bearings(d + "/planar.uv", (1, 4))
    want = twoview.estimate_homography(bearings[:, 0], bearings[:, 1])
    np.testing.assert_allclose(got["homography"], want.numpy(), rtol=0,
                               atol=JSON_TOL)
    assert got["markers"] == ["m%d" % i for i in range(9)]
    assert got["rms_transfer_error"] < 1e-5


@pytest.mark.parametrize("convention", ["cv", "maya-with-culled"])
def test_pose_from_points_verb_recovers_the_pose(shot, tmp_path, capsys,
                                                 convention):
    """The reference's two pose-from-points cases: CV points, and
    camera-solve-style Maya points with two culled (valid=false)."""
    from mayamatchmovesolver_torch.sfm import twoview

    d, bundles = shot
    bundles = bundles["m6x10"]
    cv_pts = bundles * np.array([1.0, -1.0, -1.0])
    valid = [True] * 10
    points = cv_pts.copy()
    if convention != "cv":
        points = bundles.copy()
        points[3] = [99.0, -99.0, 99.0]
        points[7] = [0.0, 0.0, 0.0]
        valid[3] = valid[7] = False
    pts_path = str(tmp_path / "points.json")
    with open(pts_path, "w") as f:
        json.dump({"points": {"positions": points.tolist(), "valid": valid,
                              "names": ["m%d" % i for i in range(10)]}}, f)
    argv = ["pose-from-points", "--markers", d + "/m6x10.uv", "--points",
            pts_path, "--frame", "3"]
    if convention == "cv":
        argv += ["--points-convention", "cv"]
    got = _port_json(argv, tmp_path, capsys)
    good = np.asarray(valid)
    assert got["convention"] == "cv"
    assert got["markers"] == ["m%d" % i for i in range(10) if valid[i]]
    bearings = _bearings(d + "/m6x10.uv", (3,))[:, 0].numpy()
    want = twoview.robust_resection_pose(
        torch.as_tensor(cv_pts[good]), torch.as_tensor(bearings[good]),
        num_hypotheses=256)
    r, t = np.asarray(got["rotation"]), np.asarray(got["translation"])
    np.testing.assert_allclose(r, want.rotation.numpy(), rtol=0,
                               atol=JSON_TOL)
    np.testing.assert_allclose(t, want.translation.numpy(), rtol=0,
                               atol=JSON_TOL)
    assert got["num_inliers"] == int(want.num_inliers) == int(good.sum())
    # Reprojecting the good points through the pose gives the bearings.
    pc = cv_pts[good] @ r.T + t
    np.testing.assert_allclose(pc[:, :2] / pc[:, 2:], bearings[good],
                               atol=1e-6)
    s = np.diag([1.0, -1.0, -1.0])
    np.testing.assert_allclose(got["camera_position_maya"], s @ (-r.T @ t),
                               atol=1e-12)


# name: (argv, whether the verb takes --device).
ERRORS = {
    "too-few-shared-markers": (["relative-pose", "--markers", "{d}/m4.uv",
                                "--frame-a", "1", "--frame-b", "4"], True),
    "vanishing-point-b-with-horizon": (
        ["calibrate", "--origin-point", "0", "0", "--vanishing-point-a",
         "0.3", "0.1", "--vanishing-point-b", "-0.4", "0.05", "--horizon",
         "-0.5", "0.0", "0.5", "0.0"], True),
    "pixel-out-of-bounds": (["image-info", "{d}/rgba.exr", "--pixel", "40",
                             "9"], False),
    "unsupported-lens-model": (["lensdistort", "--model",
                                "tde_anamorphic_std_deg4", "--output",
                                "{d}/never.exr"], True),
    "frames-outside-the-range": (["homography", "--markers", "{d}/m4.uv",
                                  "--frame-a", "1", "--frame-b", "9"],
                                 True),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_path_matches_the_reference(shot, capsys, case):
    d, _ = shot
    argv, takes_device = ERRORS[case]
    argv = [a.format(d=d) for a in argv]
    j_rc, _ = _run(j_cli, argv, capsys)
    t_rc, _ = _run(t_cli, argv + ["--device", "cpu"] * takes_device, capsys)
    assert str(j_rc).startswith("SystemExit: ")
    assert t_rc == j_rc


@pytest.mark.parametrize("solver_type", ["lm_sharded", "ba_schur_sharded"])
def test_sharded_solver_types_stop_with_the_refusal(shot, tmp_path, capsys,
                                                    solver_type):
    """The sharded solver types, once refused (ROADMAP item 14), run as in
    the JAX CLI: lm_sharded without --solve-bundles is the per-frame
    solve, which takes no solver type; ba_schur_sharded solves camera and
    bundles jointly, on the single-device Schur BA in both packages (the
    shot's 6 frames do not divide the JAX tests' 8 devices, and the port
    runs at world size 1)."""
    d, _ = shot
    argv = ["solve", "--markers", "{d}/m6.uv", "--output", "{out}s.json",
            "--iterations", "40", "--camera", "{d}/init.json",
            "--solver-type", solver_type]
    _assert_verb_matches(d, tmp_path, capsys, argv, True, ["s.json"])


@pytest.mark.parametrize("verb", ["lensdistort", "solve", "reproject",
                                  "image-warp", "camera-solve"])
def test_device_cuda_without_a_card_stops(shot, tmp_path, capsys, verb):
    """The default device is cuda: without a card the verb stops with a
    message, writes nothing and launches nothing, on no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, _ = shot
    out = str(tmp_path / "out")
    argv = {
        "lensdistort": ["lensdistort", "--output", out],
        "solve": ["solve", "--markers", d + "/m6.uv", "--output", out],
        "reproject": ["reproject", "--camera", d + "/cam.json", "--points",
                      d + "/pts.json", "--output", out],
        "image-warp": ["image-warp", d + "/plate.exr", "--output", out],
        "camera-solve": ["camera-solve", "--markers", d + "/m10.uv",
                         "--output", out],
    }[verb]
    launches = counters["stmap.launches"]
    for extra in ([], ["--device", "cuda"]):
        rc, lines = _run(t_cli, argv + extra, capsys)
        assert rc == ("SystemExit: --device cuda: no CUDA device is "
                      "available; pass --device cpu to run on the CPU")
        assert not lines and not os.path.exists(out)
    assert counters["stmap.launches"] == launches


def test_module_entry_point_runs_and_refuses_a_missing_card(tmp_path):
    """python -m mayamatchmovesolver_torch.cli: exit 0 on the CPU when
    asked, non-zero for the default device without a card."""
    out = str(tmp_path / "st.exr")
    argv = [sys.executable, "-m", "mayamatchmovesolver_torch.cli",
            "lensdistort", "--distortion", "0.08", "--width", "32",
            "--height", "18", "--output", out]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(argv + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "wrote %s (32x18 distort ST map)\n" % out
    img, _ = j_exr.read_pixels(out)
    assert img.shape == (18, 32, 4)
    os.remove(out)
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.path.exists(out)
