"""Scalar gaussian Kalman filter.

Port of mayamatchmovesolver_tpu/utils/kalmanfilter.py (ref:
python/mmSolver/utils/kalmanfilter.py:30-80 — used by the execute layer
to predict attribute values between per-frame solves,
python/mmSolver/_api/_execute/main.py:483-497).  The fields are tensors
of any one shape, or plain floats; the arithmetic is elementwise.
"""

import collections

State = collections.namedtuple("State", ("value", "mean", "variance"))


def update(state_a, state_b):
    """Fuse two gaussian estimates (ref: kalmanfilter.py:41-58)."""
    new_mean = (
        state_b.variance * state_a.mean + state_a.variance * state_b.mean
    ) / (state_b.variance + state_a.variance)
    new_variance = 1.0 / (
        1.0 / state_b.variance + 1.0 / state_a.variance
    )
    return State(mean=new_mean, variance=new_variance,
                 value=state_b.value)


def predict(state_a, state_b):
    """Propagate: means add, variances add
    (ref: kalmanfilter.py:61-80)."""
    return State(
        mean=state_a.mean + state_b.mean,
        variance=state_a.variance + state_b.variance,
        value=state_a.value,
    )
