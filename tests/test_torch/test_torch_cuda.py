"""The port's CUDA kernel and its Schur BA on the card, and the
no-fallback rule.

This file imports nothing of jax, so it runs on a machine with a GPU and
no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch/test_torch_cuda.py

Without a CUDA device the card tests skip themselves and the dispatch
test checks that a CUDA request raises.  Kernel tolerance 2e-5: both
sides float32 with IEEE division, in another operation order.  BA
tolerance: parameters within 1e-5 of each tensor's largest entry, the
cost within 1e-3 relative (float32 on either side; on the CPU float32
and float64 part by 3e-7 and 1e-4 on this problem: the final cost is a
small difference of large terms).
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.ops.stmap as t_stmap
from _torch_stmap_models import MODELS, torch_model
from mayamatchmovesolver_torch.solver import ba as t_ba

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
