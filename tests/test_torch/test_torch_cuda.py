"""The port's CUDA kernel on the card, and the no-fallback rule.

This file imports nothing of jax, so it runs on a machine with a GPU and
no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch/test_torch_cuda.py

Without a CUDA device the kernel test skips itself and the dispatch
test checks that a CUDA request raises.  Tolerance 2e-5: both sides
float32 with IEEE division, in another operation order.
"""

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.ops.stmap as t_stmap
from _torch_stmap_models import MODELS, torch_model

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
