"""Robust loss functions applied to residual vectors.

Port of mayamatchmovesolver_tpu/solver/loss.py: the reference's
trivial / soft-L1 / Cauchy losses and the residual rescaling it derives
from rho0/rho1/rho2 (ref: src/mmSolver/adjust/adjust_base.cpp:132-187).
"""

import enum

import numpy as np
import torch


class RobustLossType(enum.IntEnum):
    # Values match the reference constants
    # (ref: src/mmSolver/adjust/adjust_data.h ROBUST_LOSS_TYPE_*).
    TRIVIAL = 0
    SOFT_L1 = 1
    CAUCHY = 2


def _loss_rho(z, loss_type):
    """rho0, rho1, rho2 for each loss; loss_type is a static int."""
    if loss_type == RobustLossType.TRIVIAL:
        return z, torch.ones_like(z), torch.zeros_like(z)
    if loss_type == RobustLossType.SOFT_L1:
        t = 1.0 + z
        # (ref: adjust_base.cpp:141-148).
        rho0 = 2.0 * (t ** (0.5 - 1.0))
        rho1 = t ** -0.5
        rho2 = -0.5 * t ** -1.5
        return rho0, rho1, rho2
    if loss_type == RobustLossType.CAUCHY:
        t = 1.0 + z
        return torch.log1p(z), 1.0 / t, -1.0 / (t * t)
    raise ValueError("invalid robust loss type: %r" % (loss_type,))


def apply_loss_to_residuals(residuals, loss_type, loss_scale):
    """Scale residuals so that least-squares on the result approximates the
    robustified objective (ref: adjust_base.cpp:158-187).

    loss_type is a python int, like the reference's solver flag.
    """
    loss_type = int(loss_type)
    if loss_type == RobustLossType.TRIVIAL:
        return residuals
    z = (residuals / loss_scale) ** 2
    _, rho1, rho2 = _loss_rho(z, loss_type)
    rho2 = rho2 / (loss_scale * loss_scale)
    j_scale = rho1 + 2.0 * rho2 * residuals * residuals
    j_scale = torch.clamp(j_scale, min=float(np.finfo(np.float64).eps))
    return residuals * rho1 / torch.sqrt(j_scale)
