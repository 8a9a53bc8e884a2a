"""The port's CUDA kernels (the ST map from the pixel index and its
layer variant from a map), its Schur BA, its per-frame solve, its lens
stacks, its checkpoints, its robust relative pose, its from-scratch
camera solve, its Collection API, its command line (lensdistort,
reproject) and its tools (ray-mesh intersection, screen-space rig bake,
reparent) on the card, and the no-fallback rule.

This file imports nothing of jax, so it runs on a machine with a GPU and
no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch/test_torch_cuda.py

Without a CUDA device the card tests skip themselves and the dispatch
test checks that a CUDA request raises.  Kernel tolerance 2e-5: both
sides float32, in another operation order (the kernels divide nowhere).  BA
tolerance: parameters within 1e-5 of each tensor's largest entry, the
cost within 1e-3 relative (float32 on either side; on the CPU float32
and float64 part by 3e-7 and 1e-4 on this problem: the final cost is a
small difference of large terms).  Per-frame solve: camera channels
within 1e-4 of the CPU's (float32 on both; a 6-parameter pose from 8
exact points).
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.ops.stmap as t_stmap
from _torch_stmap_models import MODELS, torch_model, weaker
from mayamatchmovesolver_torch.solver import ba as t_ba
from mayamatchmovesolver_torch.solver import checkpoint as t_checkpoint
from mayamatchmovesolver_torch.solver import lm as t_lm

ATOL = 2e-5


def test_stmap_on_cuda_launches_the_kernel_or_raises():
    """No fallback: a CUDA device means the kernel or an exception,
    never a CPU result."""
    model, fb = torch_model("classic")
    launches = t_stmap.stmap_cuda.launches
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            t_stmap.stmap(model, fb, 64, 32, device="cuda")
        assert t_stmap.stmap_cuda.launches == launches
        return
    out = t_stmap.stmap(model, fb, 64, 32, device="cuda")
    assert out.is_cuda
    assert t_stmap.stmap_cuda.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", list(MODELS))
def test_stmap_cuda_kernel_matches_plain_version(name, direction):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model(name, device="cuda")
    for width, height in ((200, 100), (1001, 333), (1920, 1080)):
        got = t_stmap.stmap_cuda(model, fb, width, height, direction,
                                 device="cuda")
        want = t_stmap.stmap_torch(model, fb, width, height, direction,
                                   device="cuda")
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), atol=ATOL,
            err_msg="%s/%s %dx%d" % (name, direction, width, height))


def _ba_problem(device, frames=12, bundles=10):
    """A float32 one-camera BA problem with classic distortion and focal
    in the border, observations made by the port's residual at the truth,
    started off it."""
    rng = np.random.RandomState(2)
    cam = np.zeros((frames, 6))
    cam[:, 0] = np.linspace(-3, 3, frames)
    cam[:, 1] = 1.0 + 0.5 * np.sin(np.linspace(0, 3, frames))
    cam[:, 2] = 4.0 + np.linspace(0, 2, frames)
    cam[:, 3] = np.linspace(-5, 5, frames)
    cam[:, 4] = np.linspace(-20, 20, frames)
    bnd = np.stack([rng.uniform(-3, 3, bundles), rng.uniform(-2, 2, bundles),
                    rng.uniform(-6, 0, bundles)], -1)
    kw = dict(weight=np.ones((bundles, frames)),
              mkr_bnd_index=np.arange(bundles), solve_focal=True,
              lens_model_type="tde_classic", lens_solve_names=["distortion"],
              device=device)
    truth = t_ba.make_ba_problem(
        marker_uv=np.zeros((bundles, frames, 2), np.float32), cam_params=cam,
        bnd_params=bnd, lens_params=dict(distortion=0.1), **kw)
    uv = -t_ba.ba_residuals(truth, truth.cam_params,
                            truth.bnd_params) / truth.image_width
    return t_ba.make_ba_problem(
        marker_uv=uv, cam_params=cam + rng.normal(0, 0.05, cam.shape),
        bnd_params=bnd + rng.normal(0, 0.05, bnd.shape),
        focal_length_mm=36.0, lens_params=dict(distortion=0.07), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
@pytest.mark.parametrize("assembly", ["ad", "analytic"])
def test_solve_ba_on_cuda_matches_cpu(assembly, linear_solver):
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    kw = dict(max_iterations=4, tau=0.1, eps1=0.0, eps2=0.0, eps3=0.0,
              linear_solver=linear_solver, cg_iterations=40,
              assembly=assembly)
    want = t_ba.solve_ba(_ba_problem("cpu"), **kw)
    got = t_ba.solve_ba(_ba_problem("cuda"), **kw)
    assert got.cam_params.is_cuda and got.cam_params.dtype == torch.float32
    assert int(got.iterations) == int(want.iterations) == 4
    for name in ("cam_params", "bnd_params", "shared_params"):
        a, b = getattr(got, name).cpu().numpy(), getattr(want, name).numpy()
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)


def _launches():
    return (t_stmap.stmap_cuda.launches, t_stmap.stmap_layer_cuda.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_stmap_stack_on_cuda_launches_the_kernel_once(direction):
    """A stack runs no eager PyTorch layer on the card: its first layer is
    one stmap_cuda launch, every further 3DE layer one stmap_layer_cuda
    launch, a Passthrough layer none; and the map equals the all-plain
    stack on the card."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.models import tde

    classic, fb = torch_model("classic", device="cuda")
    radial, _ = torch_model("radial_deg4", device="cuda")
    radial = type(radial)(**{k: v * 0.2 for k, v in vars(radial).items()})
    stack = [classic, radial]
    before = _launches()
    got = t_stmap.stmap(stack, fb, 640, 360, direction, device="cuda")
    assert _launches() == (before[0] + 1, before[1] + 1)
    got2 = t_stmap.stmap_stack(
        [tde.Passthrough(), classic, tde.Passthrough(), radial], fb, 640,
        360, direction, device="cuda")
    assert _launches() == (before[0] + 2, before[1] + 2)
    only = t_stmap.stmap_stack([tde.Passthrough()], fb, 640, 360, direction,
                               device="cuda")
    assert _launches() == (before[0] + 2, before[1] + 2)
    want = t_stmap.stmap_stack_torch(stack, fb, 640, 360, direction,
                                     device="cuda")
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (360, 640, 4)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)
    assert torch.equal(got, got2)
    assert torch.equal(only, t_stmap.stmap_torch(
        tde.Passthrough(), fb, 640, 360, direction, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", list(MODELS))
def test_stmap_layer_cuda_kernel_matches_plain_version(name, direction):
    """The layer variant, in place on an irregular map (a weaker lens's
    first layer, with values of its own in channels 2 and 3), against
    stmap_layer_torch."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model(name, device="cuda")
    names = list(MODELS)
    other, _ = torch_model(names[(names.index(name) + 1) % len(names)],
                           device="cuda")
    other = weaker(other, 0.3)
    for width, height in ((200, 100), (1001, 333), (1920, 1080)):
        source = t_stmap.stmap_cuda(other, fb, width, height, direction,
                                    device="cuda")
        source[..., 2:] = torch.as_tensor(
            np.random.RandomState(4).uniform(-1, 1, (height, width, 2)),
            dtype=torch.float32, device="cuda")
        work = source.clone()
        launches = t_stmap.stmap_layer_cuda.launches
        got = t_stmap.stmap_layer_cuda(work, model, fb, direction)
        assert got is work
        assert t_stmap.stmap_layer_cuda.launches == launches + 1
        want = t_stmap.stmap_layer_torch(source, model, fb, direction)
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), atol=ATOL,
            err_msg="%s/%s %dx%d" % (name, direction, width, height))
        assert torch.equal(got[..., 2:], source[..., 2:])


@pytest.mark.cuda
def test_stmap_layer_cuda_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model("classic", device="cuda")
    good = t_stmap.stmap_cuda(model, fb, 64, 32, device="cuda")
    launches = t_stmap.stmap_layer_cuda.launches
    for bad, message in (
            (good.cpu(), "on a CUDA device"),
            (good.double(), "float32"),
            (good.transpose(0, 1), "contiguous"),
            (good[:, ::2], "contiguous"),
            (good[..., :3].contiguous(), r"\(H, W, 4\)"),
            (good.reshape(-1, 4), r"\(H, W, 4\)"),
            (good[:0], r"\(H, W, 4\)")):
        with pytest.raises(ValueError, match=message):
            t_stmap.stmap_layer_cuda(bad, model, fb)
    with pytest.raises(ValueError, match="direction"):
        t_stmap.stmap_layer_cuda(good, model, fb, "sideways")
    assert t_stmap.stmap_layer_cuda.launches == launches
    kept = good.clone()
    t_stmap.stmap_layer_cuda(good, model, fb)
    torch.cuda.synchronize()
    assert t_stmap.stmap_layer_cuda.launches == launches + 1
    assert not torch.equal(good, kept)


def _pose_shot(device, frames=6, bundles=8):
    """A float32 shot with exact tracks, its camera moved off the truth in
    every frame: (scene, attrs, solve_attrs, truth rows)."""
    import dataclasses

    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import (
        set_marker_screen_positions,
    )

    rng = np.random.RandomState(8)
    sg = SceneGraph(frame_range=(1, frames), dtype=np.float32)
    cam = sg.create_camera(
        "cam", tx=np.linspace(-2, 2, frames), ty=np.full(frames, 1.0),
        tz=np.full(frames, 12.0), rx=np.zeros(frames),
        ry=np.linspace(-6, 6, frames), rz=np.zeros(frames),
        focal_length_mm=35.0)
    for i in range(bundles):
        bnd = sg.create_bundle("b%d" % i, tx=rng.uniform(-4, 4),
                               ty=rng.uniform(-2, 3), tz=rng.uniform(-12, -5))
        sg.create_marker("m%d" % i, camera=cam, bundle=bnd,
                         tx=np.zeros(frames), ty=np.zeros(frames))
    scene, attrs = sg.bake(device=device)
    fi = torch.arange(frames, device=device)
    attrs = set_marker_screen_positions(
        scene, attrs, fi, evaluate(scene, attrs, fi).point_xy)
    channels = ("tx", "ty", "tz", "rx", "ry", "rz")
    rows = [cam.attr(ch).code // 2 for ch in channels]
    truth = attrs.anim_values[rows].cpu().numpy()
    anim = attrs.anim_values.clone()
    anim[rows] += torch.as_tensor(
        rng.normal(0.0, 0.05, (6, frames)), dtype=anim.dtype, device=device)
    attrs = dataclasses.replace(attrs, anim_values=anim)
    return scene, attrs, [cam.attr(ch) for ch in channels], rows, truth


@pytest.mark.cuda
@pytest.mark.parametrize("sequential", [False, True])
def test_solve_per_frame_on_cuda_matches_cpu(sequential):
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.solver import (
        SolverOptions, solve_per_frame)

    out = {}
    for device in ("cpu", "cuda"):
        scene, attrs, solve_attrs, rows, truth = _pose_shot(device)
        attrs_out, result = solve_per_frame(
            scene, attrs, np.arange(6), solve_attrs,
            SolverOptions(image_width=1920.0), sequential=sequential)
        assert attrs_out.anim_values.device.type == device
        assert attrs_out.anim_values.dtype == torch.float32
        assert result.success and not any(result.per_frame_reverted)
        out[device] = (attrs_out.anim_values[rows].cpu().numpy(), result)
        np.testing.assert_allclose(out[device][0], truth, atol=1e-3)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    assert out["cuda"][1].error_final < 1e-3 > out["cpu"][1].error_final


@pytest.mark.cuda
def test_checkpoint_saved_on_cuda_resumes_on_cpu(tmp_path):
    """An LM state of a batched solve saved from the card loads on the CPU
    and runs on to the end the card reaches."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    t = torch.linspace(0.0, 4.0, 15)
    rng = np.random.RandomState(1)
    truth = rng.uniform([1.0, 0.3, -1.0], [3.0, 1.5, 1.0], (5, 3))
    data = torch.as_tensor(
        truth[:, :1] * np.exp(-truth[:, 1:2] * t.numpy()) + truth[:, 2:],
        dtype=torch.float32)
    x0 = torch.as_tensor(truth * rng.uniform(0.7, 1.3, (5, 3)),
                         dtype=torch.float32)

    def residual(device):
        tt, dd = t.to(device), data.to(device)
        return lambda x: (x[..., 0:1] * torch.exp(-x[..., 1:2] * tt)
                          + x[..., 2:3]) - dd

    config = t_lm.LMConfig(max_iterations=25)
    fn = residual("cuda")
    init = t_lm.lm_init(fn, x0.cuda(), config)
    end = t_lm.lm_run_block(fn, init, config)
    path = tmp_path / "lm.npz"
    t_checkpoint.save_lm_state(path, t_lm.lm_run_block(fn, init, config, 2),
                               metadata={"from": "cuda"})
    state, meta = t_checkpoint.load_lm_state(path, device="cpu")
    assert meta == {"from": "cuda"} and state.x.device.type == "cpu"
    assert state.it.tolist() == [2] * 5 and state.it.dtype == torch.int32
    resumed = t_lm.lm_run_block(residual("cpu"), state, config)
    assert resumed.x.device.type == "cpu"
    np.testing.assert_allclose(resumed.x.numpy(), end.x.cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(resumed.x.numpy(), truth, atol=1e-3)
    back, _ = t_checkpoint.load_lm_state(path, device="cuda")
    assert back.x.is_cuda and back.jtj.shape == (5, 3, 3)


def _shot_module():
    """chip_smoke, whose shot builders these tests share (it lies at the
    repository's root, beside tests/)."""
    import importlib
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.cuda
def test_robust_relative_pose_on_cuda_matches_cpu():
    """The same minimal samples on both devices, float64: equal inliers,
    the pose within 1e-8 (the card's eigenvectors differ in sign and in
    the basis of the essential matrix's double singular value; what
    leaves the estimator does not depend on them)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.sfm import twoview

    rng = np.random.RandomState(3)
    n = 48
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], -1)
    angle = np.radians(-8.0)
    r = np.array([[np.cos(angle), 0.0, np.sin(angle)], [0.0, 1.0, 0.0],
                  [-np.sin(angle), 0.0, np.cos(angle)]])
    t = np.array([0.95, 0.1, 0.2])
    x2 = x @ r.T + t / np.linalg.norm(t)
    pts1, pts2 = x[:, :2] / x[:, 2:], x2[:, :2] / x2[:, 2:]
    pts2[:8] = rng.uniform(-0.5, 0.5, (8, 2))
    draws = twoview.draw_samples(n, 96, 8, torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", "cuda"):
        out[device] = twoview.robust_relative_pose(
            torch.as_tensor(pts1, device=device),
            torch.as_tensor(pts2, device=device), sample_indices=draws,
            num_hypotheses=96, inlier_threshold=1e-6)
    got, want = out["cuda"], out["cpu"]
    assert got.rotation.is_cuda and got.rotation.dtype == torch.float64
    assert torch.equal(got.inliers.cpu(), want.inliers)
    assert int(got.num_inliers) == 40
    np.testing.assert_allclose(got.rotation.cpu().numpy(),
                               want.rotation.numpy(), atol=1e-8)
    np.testing.assert_allclose(got.translation.cpu().numpy(),
                               want.translation.numpy(), atol=1e-8)
    np.testing.assert_allclose(got.rotation.cpu().numpy(), r, atol=1e-6)


@pytest.mark.cuda
def test_camera_solve_full_on_cuda_matches_cpu():
    """A 16 x 24 shot from its tracks alone, float64 with the default
    seeded draws on both devices: the same frames and points, the focal
    length within 1e-6 relative, and (the BA frees every camera and
    bundle, so up to scale) rotations and positions over the path's
    length at 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.sfm import camerasolve

    smoke = _shot_module()
    frames, bundles = 16, 24
    _, _, _, _, raw = smoke.shot_graph("cpu", frames, bundles, lens=False,
                                       dtype=np.float64)
    enable = np.ones((bundles, frames), bool)
    enable[0, 9:] = False
    enable[1, :6] = False
    out = {}
    for device in ("cpu", "cuda"):
        out[device] = camerasolve.camera_solve_full(
            raw, enable, focal_length_mm=34.0, image_width=1920.0,
            solve_focal=True, ba_iterations=30, device=device)
    (got, got_ba, got_focal), (want, _, want_focal) = out["cuda"], out["cpu"]
    assert got.rotations.is_cuda and got_ba.cam_params.is_cuda
    assert got.frame_solved.all() and got.point_valid.sum() >= bundles - 2
    np.testing.assert_array_equal(got.frame_solved, want.frame_solved)
    np.testing.assert_array_equal(got.point_valid, want.point_valid)
    assert abs(got_focal - want_focal) <= 1e-6 * want_focal
    assert abs(got_focal - smoke.FOCAL) < 1e-4
    np.testing.assert_allclose(got.rotations.cpu().numpy(),
                               want.rotations.numpy(), atol=1e-6)
    paths = [r.positions.cpu().numpy() for r in (got, want)]
    np.testing.assert_allclose(paths[0] / np.linalg.norm(paths[0][-1]),
                               paths[1] / np.linalg.norm(paths[1][-1]),
                               atol=1e-6)


@pytest.mark.cuda
def test_execute_of_solver_standard_on_cuda_matches_cpu():
    """One Collection (12 frames x 10 bundles of the smoke's lensed shot,
    float64) executed on both devices: SolverStandard's root pass,
    per-frame pass and global pass give the same number of results and
    the same attributes within 1e-6, and the lens is recovered."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    import mayamatchmovesolver_torch.api as mmapi

    smoke = _shot_module()
    col, cam, _ = smoke.shot_collection(
        "cpu", "standard", 12, 10, root_frame_indices=None,
        global_solve=True, root_frame_span=4)
    out = {device: mmapi.execute(col, device=device, dtype=np.float64)
           for device in ("cpu", "cuda")}
    (got, got_results), (want, want_results) = out["cuda"], out["cpu"]
    assert got.static_values.is_cuda
    assert got.static_values.dtype == torch.float64
    assert len(got_results) == len(want_results) == 3
    assert all(r.success for r in got_results)
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(getattr(got, field).cpu().numpy(),
                                   getattr(want, field).numpy(), atol=1e-6,
                                   err_msg=field)
    focal = float(got.static_values[cam.attr("focal_length_mm").code // 2])
    # The tracks were made in float32.
    assert abs(focal - smoke.FOCAL) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_cli_lensdistort_on_cuda_writes_the_kernels_map(tmp_path, direction):
    """cli lensdistort --device cuda: one kernel launch, and the EXR it
    writes equals the plain version of the same lens within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch import cli, models
    from mayamatchmovesolver_torch.io import exr

    out = str(tmp_path / "st.exr")
    launches = t_stmap.stmap_cuda.launches
    assert cli.main(["lensdistort", "--distortion", "0.08", "--width", "640",
                     "--height", "360", "--direction", direction,
                     "--output", out, "--device", "cuda"]) == 0
    assert t_stmap.stmap_cuda.launches == launches + 1
    f32 = dict(device="cuda", dtype=torch.float32)
    want = t_stmap.stmap_torch(
        models.TdeClassic.create(distortion=0.08, **f32),
        models.FilmBack.create(width_cm=3.6, height_cm=2.4, **f32),
        640, 360, direction, device="cuda").cpu().numpy()
    got, _ = exr.read_pixels(out)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.cuda
def test_cli_reproject_on_cuda_matches_cpu(tmp_path):
    """cli reproject --device cuda equals the CPU run at 1e-10 (float64
    on both)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    import json

    from mayamatchmovesolver_torch import cli

    rng = np.random.RandomState(4)
    cam = {"frames": list(range(1, 9)), "camera": {
        c: rng.uniform(-10, 10, 8).tolist() if c[0] == "r"
        else (rng.uniform(-1, 1, 8) + (10.0 if c == "tz" else 0.0)).tolist()
        for c in ("tx", "ty", "tz", "rx", "ry", "rz")}}
    with open(tmp_path / "cam.json", "w") as f:
        json.dump(cam, f)
    with open(tmp_path / "pts.json", "w") as f:
        json.dump(rng.uniform(-2, 2, (16, 3)).tolist(), f)
    results = {}
    for device in ("cpu", "cuda"):
        out = str(tmp_path / ("%s.json" % device))
        assert cli.main(["reproject", "--camera", str(tmp_path / "cam.json"),
                         "--points", str(tmp_path / "pts.json"), "--space",
                         "pixels", "--output", out, "--device", device]) == 0
        with open(out) as f:
            results[device] = np.asarray(json.load(f)["points"])
    assert results["cuda"].shape == (16, 8, 2)
    np.testing.assert_allclose(results["cuda"], results["cpu"], rtol=0,
                               atol=1e-10)


def _tools_scene(device_frames=6):
    """A float64 port scene for the tools: an animated camera, an
    animated group, a static group and seeded bundles with markers."""
    from mayamatchmovesolver_torch.scene import SceneGraph

    rng = np.random.RandomState(7)
    n = device_frames
    ramp = np.linspace(0.0, 1.0, n)
    sg = SceneGraph(frame_range=(1, n))
    nodes = {"grp": sg.create_transform("grp", tx=2.0 * ramp,
                                        ry=30.0 * ramp),
             "newp": sg.create_transform("newp", tx=-1.0, rz=20.0)}
    nodes["cam"] = sg.create_camera(
        "cam", tx=-1.0 + 2.0 * ramp, ty=0.3 * ramp, tz=10.0 + ramp,
        rx=rng.uniform(-2, 2, n), ry=-4.0 + 8.0 * ramp, rz=np.zeros(n),
        render_width=1920, render_height=1080)
    nodes["bundles"] = [sg.create_bundle(
        "b%d" % i, tx=rng.uniform(-3, 3), ty=rng.uniform(-2, 2),
        tz=rng.uniform(-8, -4)) for i in range(5)]
    for i, b in enumerate(nodes["bundles"]):
        sg.create_marker("m%d" % i, camera=nodes["cam"], bundle=b,
                         tx=rng.uniform(-0.3, 0.3, n),
                         ty=rng.uniform(-0.2, 0.2, n))
    return sg, nodes


@pytest.mark.cuda
def test_intersect_rays_mesh_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.utils import raytrace

    rng = np.random.RandomState(3)
    vertices = rng.uniform(-2, 2, (60, 3)) * [1, 1, 0.1] - [0, 0, 4]
    triangles = rng.randint(0, 60, (80, 3))
    origins = rng.uniform(-1, 1, (64, 3)) * [1, 1, 0] + [0, 0, 3]
    directions = rng.normal(0, 0.2, (64, 3)) - [0, 0, 1]
    results = {}
    for device in ("cpu", "cuda"):
        for both in (False, True):
            out = raytrace.intersect_rays_mesh(
                torch.as_tensor(origins, device=device),
                torch.as_tensor(directions, device=device), vertices,
                triangles, test_both_directions=both)
            assert out[0].device.type == device
            results[device, both] = [t.cpu().numpy() for t in out]
    for both in (False, True):
        want, got = results["cpu", both], results["cuda", both]
        np.testing.assert_array_equal(got[3], want[3])
        assert want[3].any()
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g[want[3]], w[want[3]], rtol=0,
                                       atol=1e-10)


@pytest.mark.cuda
def test_screen_space_rig_bake_on_cuda_round_trips():
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.scene import evaluate
    from mayamatchmovesolver_torch.tools import screenspace

    sg, nodes = _tools_scene()
    scene, attrs = sg.bake(device="cuda")
    frames = torch.arange(sg.num_frames, device="cuda")
    for b in nodes["bundles"]:
        rig = screenspace.screen_space_rig_bake(scene, attrs, frames,
                                                b.index)
        assert rig["depth"].is_cuda and bool((rig["depth"] > 0).all())
        world = screenspace.screen_space_rig_unbake(
            scene, attrs, frames, rig["screen_x"], rig["screen_y"],
            rig["depth"])
        want = evaluate(scene, attrs, frames).tfm_world[b.index, :, :3, 3]
        np.testing.assert_allclose(world.cpu().numpy(),
                                   want.cpu().numpy(), rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_reparent_on_cuda_writes_the_cpu_values():
    """reparent(device="cuda") writes the builder values of the CPU run
    at 1e-10 (float64 on both)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.tools import reparent

    baked = {}
    for device in ("cpu", "cuda"):
        sg, nodes = _tools_scene()
        reparent.reparent(sg, nodes["cam"], nodes["grp"], device=device)
        for b in nodes["bundles"]:
            reparent.reparent(sg, b, nodes["newp"], device=device)
        reparent.reparent(sg, nodes["cam"], None, device=device)
        attrs = sg._attr_builder.bake(device="cpu")
        baked[device] = (attrs.static_values.numpy(),
                         attrs.anim_values.numpy())
    for got, want in zip(baked["cuda"], baked["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
