"""Box-constraint reparameterization (sine transform).

Port of mayamatchmovesolver_tpu/solver/bounds.py: the reference's
parameter bound conversion
(ref: src/mmSolver/adjust/adjust_base.cpp:194-258, implementing
MINPACK-style transformations): solver-internal parameters
are unbounded; external attribute values respect [min, max].

    both bounds:  external = min + (max-min)/2 * (sin(internal) + 1)
    lower only:   external = min - 1 + sqrt(internal^2 + 1)
    upper only:   external = max + 1 - sqrt(internal^2 + 1)
    unbounded:    external = internal

Deviation from the reference, on purpose: (a) the reference's lower-only
branch has a sign slip (`xmin - (1 + sqrt(...))` at adjust_base.cpp:205)
that would always clamp to xmin — we use the standard formula; (b)
offset/scale are applied as exact inverses (internal = external*scale +
offset) where the reference's two directions are asymmetric
(adjust_base.cpp:218-219 vs 240-242).  Defaults offset=0/scale=1 match
the reference bit-for-bit.
"""

import torch

from mayamatchmovesolver_torch.core.constants import FLOAT_MAX


def _bound_kinds(xmin, xmax):
    has_lower = xmin > -FLOAT_MAX
    has_upper = xmax < FLOAT_MAX
    return has_lower, has_upper


def external_to_internal(value, xmin, xmax, offset=0.0, scale=1.0):
    """Attribute value -> unbounded solver parameter (all tensor args)."""
    value = torch.clamp(value, xmin, xmax)
    v = value * scale + offset
    lo = xmin * scale + offset
    hi = xmax * scale + offset
    has_lower, has_upper = _bound_kinds(xmin, xmax)

    both = torch.asin(
        torch.clamp(2.0 * (v - lo) / torch.clamp(hi - lo, min=1e-300) - 1.0, -1.0, 1.0)
    )
    lower_only = torch.sqrt(torch.clamp((v - lo + 1.0) ** 2 - 1.0, min=0.0))
    upper_only = torch.sqrt(torch.clamp((hi - v + 1.0) ** 2 - 1.0, min=0.0))

    return torch.where(
        has_lower & has_upper,
        both,
        torch.where(
            has_lower, lower_only, torch.where(has_upper, upper_only, v)
        ),
    )


def internal_to_external(value, xmin, xmax, offset=0.0, scale=1.0):
    """Unbounded solver parameter -> attribute value (all tensor args)."""
    has_lower, has_upper = _bound_kinds(xmin, xmax)
    lo = xmin * scale + offset
    hi = xmax * scale + offset

    both = lo + (hi - lo) / 2.0 * (torch.sin(value) + 1.0)
    lower_only = lo - 1.0 + torch.sqrt(value * value + 1.0)
    upper_only = hi + 1.0 - torch.sqrt(value * value + 1.0)

    v = torch.where(
        has_lower & has_upper,
        both,
        torch.where(
            has_lower, lower_only, torch.where(has_upper, upper_only, value)
        ),
    )
    v = (v - offset) / scale
    return torch.clamp(v, xmin, xmax)
