"""2D line fitting and intersection math.

Re-implementation of the reference's line math used by the
mmLineBestFit / mmLineIntersect / mmLinePointIntersect nodes
(ref: lib/rust/mmscenegraph/src/math/line.rs:90-272,
line_intersect.rs:42, and the node wrappers
src/mmSolver/node/MMLineBestFitNode.cpp:94).

Port of mayamatchmovesolver_tpu/core/line.py on tensors: every function
computes on its inputs' device and broadcasts over leading axes.
"""

import numpy as np
import torch


def _tensor(x):
    """x as a floating tensor; numbers, lists and integer arrays become
    float64, as under the reference's x64 mode."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x if x.is_floating_point() else x.double()


def fit_line_to_points(x, y):
    """Total-least-squares line fit through 2D points.

    Returns (point_x, point_y, dir_x, dir_y): a point on the line (the
    centroid) and the unit direction.  Uses the orthogonal-regression
    eigen direction of the 2x2 scatter matrix, which matches the
    reference's slope fits (line.rs fit_line_to_points_type1/2) without
    their vertical/horizontal special-casing.
    """
    x = _tensor(x)
    y = _tensor(y)
    mean_x = torch.mean(x, dim=-1)
    mean_y = torch.mean(y, dim=-1)
    dx = x - mean_x[..., None]
    dy = y - mean_y[..., None]
    sxx = torch.sum(dx * dx, dim=-1)
    syy = torch.sum(dy * dy, dim=-1)
    sxy = torch.sum(dx * dy, dim=-1)
    # Principal eigenvector of [[sxx, sxy], [sxy, syy]].
    theta = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    dir_x = torch.cos(theta)
    dir_y = torch.sin(theta)
    return mean_x, mean_y, dir_x, dir_y


def line_point_intersection(point, line_a, line_b):
    """Closest point on segment-line (line_a, line_b) to `point`.

    (ref: line_intersect.rs:42 line_point_intersection.)
    All args (..., 2); returns (..., 2).
    """
    point = _tensor(point)
    line_a = _tensor(line_a)
    line_b = _tensor(line_b)
    d = line_b - line_a
    denom = torch.sum(d * d, dim=-1, keepdim=True)
    t = torch.sum((point - line_a) * d, dim=-1, keepdim=True) / torch.clamp(
        denom, min=1e-30
    )
    return line_a + t * d


def line_line_intersection(p1, d1, p2, d2):
    """Intersection of two infinite 2D lines (point+direction form).

    Returns (intersection (..., 2), parallel mask).
    (ref capability: MMLineIntersect node.)
    """
    p1, d1 = _tensor(p1), _tensor(d1)
    p2, d2 = _tensor(p2), _tensor(d2)
    cross = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    parallel = torch.abs(cross) < 1e-12
    diff = p2 - p1
    t = (
        diff[..., 0] * d2[..., 1] - diff[..., 1] * d2[..., 0]
    ) / torch.where(parallel, torch.ones_like(cross), cross)
    return p1 + t[..., None] * d1, parallel
