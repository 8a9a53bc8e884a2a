"""The port's package surface against the JAX package's: every name the
reference's core, io, ops and solver packages re-export is there in the
port's, and the small helpers angle_of_view_radians (core/camera.py) and
make_marker_frame_mask (solver/problem.py) agree with the reference's
(1e-12 in float64; the mask exactly).
"""

import ast
import importlib
import inspect

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.core.camera as t_camera
import mayamatchmovesolver_torch.solver.problem as t_problem
import mayamatchmovesolver_tpu.core.camera as j_camera
import mayamatchmovesolver_tpu.solver.problem as j_problem


def _reexports(package):
    """The names a package's __init__ imports."""
    tree = ast.parse(inspect.getsource(importlib.import_module(package)))
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


@pytest.mark.parametrize("sub", ["core", "io", "ops", "solver"])
def test_port_reexports_what_the_reference_does(sub):
    names = _reexports("mayamatchmovesolver_tpu." + sub)
    assert names
    port = importlib.import_module("mayamatchmovesolver_torch." + sub)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing
    for name in names:
        value = getattr(port, name)
        assert (getattr(value, "__module__", None) or value.__name__
                ).startswith("mayamatchmovesolver_torch"), name


def test_angle_of_view_radians_matches():
    sizes = np.array([36.0, 24.0, 12.7, 70.0])
    focals = np.array([35.0, 50.0, 8.0, 300.0])
    want = np.asarray(j_camera.angle_of_view_radians(sizes, focals))
    got = t_camera.angle_of_view_radians(torch.as_tensor(sizes),
                                         torch.as_tensor(focals))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # The reference's value (ref: math/camera.rs:70-76).
    np.testing.assert_allclose(np.degrees(float(got[0])), 54.432228,
                               atol=1e-5)


@pytest.mark.parametrize("pairs", [None, [], [(0, 0), (2, 3), (1, 1)]])
def test_make_marker_frame_mask_matches(pairs):
    want = j_problem.make_marker_frame_mask(3, 4, pairs)
    got = t_problem.make_marker_frame_mask(3, 4, pairs)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
