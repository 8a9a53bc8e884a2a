"""Attach-bundle-to-curve data capability.

The reference tool snaps a bundle onto a NURBS curve and drives it by a
single normalized parameter attribute, using Maya's
nearestPointOnCurve / pointOnCurveInfo nodes
(ref: python/mmSolver/tools/attachbundletocurve/lib.py:55-118
get_closest_point_on_nurbs_curve — param normalized to [0, 1] — and
connect_transform_to_nurbs_curve).  Here the curve itself is data: a
clamped uniform B-spline over control points, evaluated batched, with
the closest-point search done by dense sampling + iterative local
refinement (fully vectorized over query positions).

Port of mayamatchmovesolver_tpu/tools/curves.py: a copy of the
reference's host code.
"""

import numpy as np


def _clamped_knots(num_ctrl, degree):
    """Clamped uniform knot vector for a B-spline."""
    inner = num_ctrl - degree - 1
    return np.concatenate([
        np.zeros(degree + 1),
        (np.arange(1, inner + 1)) / (inner + 1.0),
        np.ones(degree + 1),
    ])


def _basis(knots, degree, t):
    """Cox-de Boor basis values for every control point, batched over
    t.  Returns (len(t), num_ctrl)."""
    t = np.atleast_1d(np.asarray(t, float))
    n_knots = len(knots)
    num_ctrl = n_knots - degree - 1
    # Degree-0 basis.
    b = np.zeros((len(t), n_knots - 1))
    for i in range(n_knots - 1):
        if knots[i + 1] > knots[i]:
            b[:, i] = (t >= knots[i]) & (t < knots[i + 1])
    # Make the curve inclusive at t == 1.
    last = np.nonzero(knots < 1.0)[0]
    if last.size:
        b[t >= 1.0, last[-1]] = 1.0
    for d in range(1, degree + 1):
        nb = np.zeros((len(t), n_knots - d - 1))
        for i in range(n_knots - d - 1):
            den1 = knots[i + d] - knots[i]
            den2 = knots[i + d + 1] - knots[i + 1]
            term = 0.0
            if den1 > 0:
                term = (t - knots[i]) / den1 * b[:, i]
            if den2 > 0:
                term = term + (knots[i + d + 1] - t) / den2 * b[:, i + 1]
            nb[:, i] = term
        b = nb
    return b[:, :num_ctrl]


def curve_point(control_points, t, degree=3):
    """Evaluate the clamped B-spline at parameter(s) t in [0, 1].

    control_points: (C, 3).  t: scalar or (N,).  Returns (N, 3) (or
    (3,) for scalar t) — the pointOnCurveInfo capability."""
    control_points = np.asarray(control_points, float)
    degree = min(int(degree), len(control_points) - 1)
    knots = _clamped_knots(len(control_points), degree)
    scalar = np.isscalar(t) or np.ndim(t) == 0
    basis = _basis(knots, degree, t)
    pts = basis @ control_points
    return pts[0] if scalar else pts


def closest_point_on_curve(control_points, pos, degree=3, samples=256,
                           refine_iters=24):
    """Closest point on the curve to pos (or batch of positions).

    Returns (point (..., 3), param01 (...,), distance (...,)) — the
    nearestPointOnCurve capability with the reference's normalized
    parameter semantics (ref: attachbundletocurve/lib.py:85-89).
    Dense sampling brackets the minimum; ternary-section refinement
    polishes it (robust for any curve shape, no derivative needed)."""
    control_points = np.asarray(control_points, float)
    pos = np.asarray(pos, float)
    single = pos.ndim == 1
    qp = pos[None] if single else pos  # (N, 3)

    ts = np.linspace(0.0, 1.0, samples)
    cpts = curve_point(control_points, ts, degree)  # (S, 3)
    d2 = np.sum((qp[:, None, :] - cpts[None, :, :]) ** 2, axis=-1)
    best = np.argmin(d2, axis=-1)  # (N,)
    step = 1.0 / (samples - 1)
    lo = np.clip(ts[best] - step, 0.0, 1.0)
    hi = np.clip(ts[best] + step, 0.0, 1.0)

    def dist2(t):
        return np.sum(
            (curve_point(control_points, t, degree) - qp) ** 2, axis=-1
        )

    for _ in range(refine_iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        take_lo = dist2(m1) < dist2(m2)
        hi = np.where(take_lo, m2, hi)
        lo = np.where(take_lo, m1, lo)
    t_best = 0.5 * (lo + hi)
    point = curve_point(control_points, t_best, degree)
    dist = np.sqrt(dist2(t_best))
    if single:
        return point[0], float(t_best[0]), float(dist[0])
    return point, t_best, dist


def attach_bundle_to_curve(scene_graph, bundle, control_points,
                           degree=3):
    """Snap a bundle onto the curve and return its normalized
    parameter (the reference writes the param as an animatable attr on
    the bundle and constrains the position; here the binding is the
    (curve, param) pair, and the bundle is moved to the curve).

    Returns (param01, position)."""
    pos = np.array([
        float(scene_graph.get_value(bundle.attr(c)))
        for c in ("tx", "ty", "tz")
    ])
    point, t, _ = closest_point_on_curve(control_points, pos, degree)
    for c, v in zip(("tx", "ty", "tz"), point):
        scene_graph.set_value(bundle.attr(c), float(v))
    return t, point


def move_bundle_along_curve(scene_graph, bundle, control_points, param,
                            degree=3):
    """Drive the attached bundle by its curve parameter (the
    pointOnCurveInfo connection the reference builds)."""
    point = curve_point(control_points, float(np.clip(param, 0, 1)),
                        degree)
    for c, v in zip(("tx", "ty", "tz"), point):
        scene_graph.set_value(bundle.attr(c), float(v))
    return point
