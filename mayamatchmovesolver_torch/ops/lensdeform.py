"""Deform geometry through a lens model.

Port of mayamatchmovesolver_tpu/ops/lensdeform.py (ref:
src/mmSolver/node/MMLensDeformerNode.cpp:130-227 — applies
applyModelUndistort to each geometry point's (x, y), keeps z, guards
non-finite output, and lerps by the deformer envelope) and the
mmLensEvaluate node (batch lens evaluation of points).  Plain tensor
code on the points' device.
"""

import torch

from mayamatchmovesolver_torch.models import base as lens_base
from mayamatchmovesolver_torch.models import tde

__all__ = ["deform_points", "evaluate_lens"]


def deform_points(model, film_back: lens_base.FilmBack, points,
                  envelope=1.0, direction="undistort"):
    """Apply lens distortion to (N, 3) points in screen space.

    x/y move through the lens model, z is untouched; non-finite lens
    output falls back to the input; `envelope` blends input->output
    (ref: MMLensDeformerNode.cpp:205-224).
    """
    xy = points[..., :2]
    out_xy = evaluate_lens(model, film_back, xy, direction)
    out_xy = torch.where(torch.isfinite(out_xy), out_xy, xy)
    out_xy = xy + envelope * (out_xy - xy)
    return torch.cat([out_xy, points[..., 2:]], dim=-1)


def evaluate_lens(model, film_back: lens_base.FilmBack, xy,
                  direction="undistort"):
    """Batch lens evaluation of (N, 2) screen-space points
    (ref: src/mmSolver/node/MMLensEvaluateNode.cpp)."""
    if direction == "undistort":
        return tde.undistort(model, film_back, xy)
    return tde.distort(model, film_back, xy)
