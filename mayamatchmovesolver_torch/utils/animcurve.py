"""Animation-curve utilities.

Counterpart of the reference's animcurve helpers
(ref: python/mmSolver/utils/animcurve.py): where the reference creates
Maya animCurve nodes, this framework's animated attributes are dense
per-frame arrays (scene/attrblock.py), so an AnimCurve here is sparse
keyframes (times, values) plus sampling to a dense channel, and the
euler filter operates on plain arrays.

Port of mayamatchmovesolver_tpu/utils/animcurve.py: a copy of the
reference's host code.
"""

import numpy as np

__all__ = [
    "AnimCurve",
    "create_anim_curve",
    "euler_filter_value",
    "euler_filter_array",
]


class AnimCurve:
    """Sparse keyframed curve: sorted key times + values with linear
    interpolation and constant extrapolation (the reference delegates
    to Maya MFnAnimCurve, animcurve.py:41-130; sampling to the dense
    frame range replaces node creation here)."""

    def __init__(self, times, values):
        times = np.asarray(times, dtype=np.float64)
        values = np.asarray(values, dtype=np.float64)
        if times.shape != values.shape or times.ndim != 1:
            raise ValueError("times/values must be 1D and equal length")
        order = np.argsort(times)
        self.times = times[order]
        self.values = values[order]

    def sample(self, frames):
        """Evaluate at the given frames; (F,) float array."""
        frames = np.asarray(frames, dtype=np.float64)
        return np.interp(frames, self.times, self.values)

    def to_dense(self, frame_range):
        """Dense per-frame values over inclusive (start, end) — the
        shape AttrBlock animated channels expect."""
        start, end = frame_range
        return self.sample(np.arange(start, end + 1))


def create_anim_curve(times, values):
    """(ref: animcurve.py:41 create_anim_curve_node_apione.)"""
    return AnimCurve(times, values)


def euler_filter_value(prev_value, value):
    """Adjust an euler angle (degrees) by +-360 steps to be continuous
    with the previous one (ref: utils/animcurve.py:191-214)."""
    while True:
        if value - prev_value > 180.0:
            value -= 360.0
        elif prev_value - value > 180.0:
            value += 360.0
        else:
            return value


def euler_filter_array(values):
    """Filter a whole rotation channel for continuity
    (ref: euler_filter_plug, utils/animcurve.py:153 — applied
    key-by-key there).  Vectorized: cumulative unwrap in degrees."""
    values = np.asarray(values, dtype=np.float64)
    if values.size <= 1:
        return values.copy()
    return np.degrees(np.unwrap(np.radians(values)))
