"""SolverCamera of the port against the JAX package's, through
api.execute: a Collection with nothing but markers recovers the camera
path, the bundles and the focal length.

The shot is that of tests/test_solver/test_camera_solver.py (16 frames x
24 points, focal 40 mm guessed as 35).  The port gets the JAX package's
RANSAC draws (`jax_sampler`).  The BA frees every camera and bundle, so
the solved attributes agree up to scale once the origin frame is fixed:
focal length at 1e-6 relative, rotations at 1e-6 degrees, positions over
the camera path's length at 1e-6; the result's counters and reason
string are equal.  The two refusals (too few markers, a camera channel
without animation) are served each package's solve from the full run.
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.api as t_api
import mayamatchmovesolver_torch.sfm.camerasolve as t_cs
import mayamatchmovesolver_tpu.api as j_api
import mayamatchmovesolver_tpu.sfm.camerasolve as j_cs
from _torch_port_cases import (
    camera_shot_tracks,
    jax_sampler,
    to_numpy,
    unsolved_camera_scene,
)
from mayamatchmovesolver_tpu.core.constants import RotateOrder

FRAMES = 16
SOLVER = dict(frame_indices=range(FRAMES), solve_focal=True, refine_rounds=1,
              ba_iterations=20)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tracks_and_fit():
    return camera_shot_tracks(focal=40.0)


def _execute(pkg, tracks, fit, markers=slice(None), **scene_kw):
    api = j_api if pkg == "jax" else t_api
    sg, cam, mkrs = unsolved_camera_scene(pkg, tracks, fit, **scene_kw)
    col = api.Collection(sg)
    col.add_marker(*mkrs[markers])
    if pkg == "jax":
        col.set_solver(api.SolverCamera(**SOLVER))
        attrs, results = api.execute(col)
    else:
        col.set_solver(api.SolverCamera(sampler=jax_sampler, **SOLVER))
        ok, messages = api.validate(col)
        assert ok, messages
        attrs, results = api.execute(col, device="cpu")
    return sg, cam, attrs, results, col


@pytest.fixture(scope="module")
def full_runs(tracks_and_fit):
    """The whole solve in both packages, with what each camera_solve_full
    returned, for the refusal tests to serve again."""
    tracks, fit = tracks_and_fit
    runs = {}
    for pkg, mod in (("jax", j_cs), ("torch", t_cs)):
        real, kept = mod.camera_solve_full, []

        def recording(*a, _real=real, _kept=kept, **k):
            _kept.append(_real(*a, **k))
            return _kept[-1]

        mod.camera_solve_full = recording
        try:
            runs[pkg] = _execute(pkg, tracks, fit,
                                 rotate_order=RotateOrder.ZXY) + (kept[0],)
        finally:
            mod.camera_solve_full = real
    return runs


def _camera_channels(cam, attrs):
    return {ch: to_numpy(attrs.anim_values)[cam.attr(ch).code // 2]
            for ch in ("tx", "ty", "tz", "rx", "ry", "rz")}


def test_solver_camera_full_run_matches(full_runs):
    j_sg, j_cam, j_attrs, j_results, j_col, _ = full_runs["jax"]
    t_sg, t_cam, t_attrs, t_results, t_col, _ = full_runs["torch"]
    assert len(t_results) == len(j_results) == 1
    got, want = t_results[0], j_results[0]
    assert t_col.last_results is t_results
    assert got.success and want.success
    assert got.reason_string == want.reason_string
    assert "16/16 frames" in got.reason_string
    assert got.iterations == want.iterations
    assert got.stop_reason == want.stop_reason
    # The second BA starts from the first one's solution: round-off.
    np.testing.assert_allclose(got.error_initial, want.error_initial,
                               rtol=1e-6, atol=1e-12)
    for field in ("error_final", "error_avg", "error_min", "error_max"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   atol=1e-6, err_msg=field)
    assert got.error_avg < 1e-3  # pixels
    assert t_attrs.static_values.device.type == "cpu"

    fcode = t_cam.attr("focal_length_mm").code
    t_focal = float(t_attrs.static_values[fcode // 2])
    j_focal = float(np.asarray(j_attrs.static_values)[fcode // 2])
    assert abs(t_focal - j_focal) <= 1e-6 * j_focal
    assert abs(t_focal - 40.0) < 1e-3

    # Camera channels, written in the camera's rotate order (ZXY): the
    # rotations as they are, the positions over the path's length.
    t_ch, j_ch = _camera_channels(t_cam, t_attrs), _camera_channels(j_cam,
                                                                    j_attrs)
    for ch in ("rx", "ry", "rz"):
        np.testing.assert_allclose(t_ch[ch], j_ch[ch], atol=1e-6, err_msg=ch)
    assert np.abs(t_ch["ry"]).max() > 5.0
    paths = [np.stack([c["tx"], c["ty"], c["tz"]], -1) for c in (t_ch, j_ch)]
    np.testing.assert_allclose(paths[0][0], 0.0, atol=1e-12)
    lengths = [np.linalg.norm(p[-1]) for p in paths]
    np.testing.assert_allclose(paths[0] / lengths[0], paths[1] / lengths[1],
                               atol=1e-6)
    # Bundles over the same length.
    t_static = to_numpy(t_attrs.static_values) / lengths[0]
    j_static = np.asarray(j_attrs.static_values) / lengths[1]
    moved = 0
    for node in t_sg._bundles:
        codes = [node.attr(ch).code // 2 for ch in ("tx", "ty", "tz")]
        np.testing.assert_allclose(t_static[codes], j_static[codes],
                                   atol=1e-6, err_msg=node.name)
        moved += bool(np.any(t_static[codes] != 0.0))
    assert moved >= 20


def test_solver_camera_needs_eight_markers(tracks_and_fit):
    tracks, fit = tracks_and_fit
    out = [_execute(pkg, tracks, fit, markers=slice(0, 7))
           for pkg in ("jax", "torch")]
    (_, _, j_attrs, j_results, _), (_, _, t_attrs, t_results, _) = out
    assert not t_results[0].success
    assert t_results[0].reason_string == j_results[0].reason_string
    assert "got 7" in t_results[0].reason_string
    # The attributes come back as they were baked.
    np.testing.assert_array_equal(to_numpy(t_attrs.anim_values),
                                  np.asarray(j_attrs.anim_values))


def test_solver_camera_refuses_a_static_camera_channel(tracks_and_fit,
                                                       full_runs,
                                                       monkeypatch):
    """The write-back needs tx..rz animated; each package's solve is
    served from the full run, the refusal comes after it."""
    tracks, fit = tracks_and_fit
    monkeypatch.setattr(j_cs, "camera_solve_full",
                        lambda *a, **k: full_runs["jax"][-1])
    monkeypatch.setattr(t_cs, "camera_solve_full",
                        lambda *a, **k: full_runs["torch"][-1])
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="requires animated camera"):
            _execute(pkg, tracks, fit, static_rz=True)
