"""3DEqualizer-compatible lens distortion models.

Port of mayamatchmovesolver_tpu/models/tde.py (ref:
lib/cppbind/mmlens/src/distortion_structs.h and the ldpk 2.8 headers):

  * TdeClassic                 — "3DE Classic LD Model"
  * TdeRadialStdDeg4           — "3DE4 Radial, Standard - Degree 4"
  * TdeAnamorphicStdDeg4       — "3DE4 Anamorphic, Standard - Degree 4"
  * TdeAnamorphicStdDeg4Rescaled — + rescale parameter
  * Passthrough                — identity

Each model is a frozen dataclass of broadcastable parameter tensors;
the dataclass field defaults are the models' neutral parameter values.
`undistort_dn` is the analytic polynomial; `distort_dn` is the
fixed-point inverse.
"""

import dataclasses
import math

import torch

from mayamatchmovesolver_torch.models.base import (
    FilmBack,
    apply_in_marker_space,
    diag2,
    fixed_point_inverse,
    inverse2,
    mat2_apply,
    rotation_matrix_2d,
)

DEG2RAD = math.pi / 180.0


class _Model:
    @classmethod
    def create(cls, *, device, dtype=None, **values):
        """Scalar parameter tensors on `device` (dtype defaults to
        torch's default float type); unset parameters take the field
        defaults."""
        fields = dataclasses.fields(cls)
        unknown = set(values) - {f.name for f in fields}
        if unknown:
            raise TypeError(
                "unknown %s parameters: %r" % (cls.__name__, sorted(unknown))
            )
        return cls(**{
            f.name: torch.as_tensor(
                values.get(f.name, f.default), dtype=dtype, device=device
            )
            for f in fields
        })


@dataclasses.dataclass(frozen=True)
class Passthrough(_Model):
    """Identity lens (ref: mmlens lens_model_passthrough.cpp)."""


@dataclasses.dataclass(frozen=True)
class TdeClassic(_Model):
    """(ref: ldpk classic_3de_mixed_distortion; parameter order matches
    mmlens Parameters3deClassic.)"""

    distortion: torch.Tensor = 0.0
    anamorphic_squeeze: torch.Tensor = 1.0
    curvature_x: torch.Tensor = 0.0
    curvature_y: torch.Tensor = 0.0
    quartic_distortion: torch.Tensor = 0.0


def _classic_undistort_dn(p: TdeClassic, xy):
    ld, sq, cx, cy, qu = (
        p.distortion, p.anamorphic_squeeze, p.curvature_x,
        p.curvature_y, p.quartic_distortion,
    )
    # Derived coefficients of the mixed model.
    cxx = ld / sq
    cxy = (ld + cx) / sq
    cyx = ld + cy
    cyy = ld
    cxxx = qu / sq
    cxxy = 2.0 * qu / sq
    cxyy = qu / sq
    cyxx = qu
    cyyx = 2.0 * qu
    cyyy = qu

    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    x4, y4 = x2 * x2, y2 * y2
    xy2 = x2 * y2
    qx = x * (1.0 + cxx * x2 + cxy * y2 + cxxx * x4 + cxxy * xy2 + cxyy * y4)
    qy = y * (1.0 + cyx * x2 + cyy * y2 + cyxx * x4 + cyyx * xy2 + cyyy * y4)
    return torch.stack([qx, qy], dim=-1)


@dataclasses.dataclass(frozen=True)
class TdeRadialStdDeg4(_Model):
    """(ref: ldpk radial_decentered_distortion + cylindric_extender_2;
    mmlens Parameters3deRadialStdDeg4 ordering.)"""

    degree2_distortion: torch.Tensor = 0.0
    degree2_u: torch.Tensor = 0.0
    degree2_v: torch.Tensor = 0.0
    degree4_distortion: torch.Tensor = 0.0
    degree4_u: torch.Tensor = 0.0
    degree4_v: torch.Tensor = 0.0
    cylindric_direction: torch.Tensor = 0.0  # degrees
    cylindric_bending: torch.Tensor = 0.0


def _cylindric_matrix(phi_deg, b):
    """(ref: ldpk cylindric_extender_2 matrix.)"""
    q = torch.sqrt(1.0 + b)
    c = torch.cos(phi_deg * DEG2RAD)
    s = torch.sin(phi_deg * DEG2RAD)
    m00 = c * c * q + s * s / q
    m01 = (q - 1.0 / q) * c * s
    m11 = c * c / q + s * s * q
    return torch.stack(
        [torch.stack([m00, m01], dim=-1), torch.stack([m01, m11], dim=-1)],
        dim=-2,
    )


def _radial_deg4_core(p: TdeRadialStdDeg4, xy):
    c2, u2, v2 = p.degree2_distortion, p.degree2_u, p.degree2_v
    c4, u4, v4 = p.degree4_distortion, p.degree4_u, p.degree4_v
    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    xy_ = x * y
    r2 = x2 + y2
    r4 = r2 * r2
    radial = 1.0 + c2 * r2 + c4 * r4
    qx = (
        x * radial
        + (r2 + 2.0 * x2) * (u2 + u4 * r2)
        + 2.0 * xy_ * (v2 + v4 * r2)
    )
    qy = (
        y * radial
        + (r2 + 2.0 * y2) * (v2 + v4 * r2)
        + 2.0 * xy_ * (u2 + u4 * r2)
    )
    return torch.stack([qx, qy], dim=-1)


def _radial_deg4_undistort_dn(p: TdeRadialStdDeg4, xy):
    # undistort: cylindric.eval(radial.eval(p)).
    m = _cylindric_matrix(p.cylindric_direction, p.cylindric_bending)
    return mat2_apply(m, _radial_deg4_core(p, xy))


def _radial_deg4_distort_dn(p: TdeRadialStdDeg4, xy):
    # distort: radial.map_inverse(cylindric.eval_inv(p)).
    m = _cylindric_matrix(p.cylindric_direction, p.cylindric_bending)
    target = mat2_apply(inverse2(m), xy)
    return fixed_point_inverse(lambda q: _radial_deg4_core(p, q), target)


@dataclasses.dataclass(frozen=True)
class TdeAnamorphicStdDeg4(_Model):
    """(ref: ldpk generic_anamorphic_distortion<4> + rotation/squeeze
    extenders; mmlens Parameters3deAnamorphicStdDeg4 ordering.)"""

    degree2_cx02: torch.Tensor = 0.0
    degree2_cy02: torch.Tensor = 0.0
    degree2_cx22: torch.Tensor = 0.0
    degree2_cy22: torch.Tensor = 0.0
    degree4_cx04: torch.Tensor = 0.0
    degree4_cy04: torch.Tensor = 0.0
    degree4_cx24: torch.Tensor = 0.0
    degree4_cy24: torch.Tensor = 0.0
    degree4_cx44: torch.Tensor = 0.0
    degree4_cy44: torch.Tensor = 0.0
    lens_rotation: torch.Tensor = 0.0  # degrees
    squeeze_x: torch.Tensor = 1.0
    squeeze_y: torch.Tensor = 1.0


@dataclasses.dataclass(frozen=True)
class TdeAnamorphicStdDeg4Rescaled(TdeAnamorphicStdDeg4):
    """(ref: mmlens Parameters3deAnamorphicStdDeg4Rescaled — the deg-4
    anamorphic with an extra rescale factor.)"""

    rescale: torch.Tensor = 1.0


def _anamorphic_core(p, xy):
    """Polynomial in polar form: factor_x/y = sum over even (i_phi<=i_r)
    of c[i_phi][i_r] * cos(i_phi*phi) * r^i_r, with c00 = 1.

    cos(2phi) and cos(4phi) come from Cartesian ratios so the function
    stays smooth near the origin (no atan2).
    """
    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    r4 = r2 * r2
    safe_r2 = torch.clamp(r2, min=1e-30)
    cos2 = (x2 - y2) / safe_r2
    cos4 = 2.0 * cos2 * cos2 - 1.0

    fx = (
        1.0
        + p.degree2_cx02 * r2
        + p.degree4_cx04 * r4
        + cos2 * (p.degree2_cx22 * r2 + p.degree4_cx24 * r4)
        + cos4 * p.degree4_cx44 * r4
    )
    fy = (
        1.0
        + p.degree2_cy02 * r2
        + p.degree4_cy04 * r4
        + cos2 * (p.degree2_cy22 * r2 + p.degree4_cy24 * r4)
        + cos4 * p.degree4_cy44 * r4
    )
    return torch.stack([x * fx, y * fy], dim=-1)


def _anamorphic_matrices(p, pixel_aspect, rescale=None):
    """The two concatenated extender matrices of the mmlens wiring
    (ref: distortion_structs.h Distortion3deAnamorphicStdDeg4):
      A = R(rot) @ Sx(sq_x) @ Sy(sq_y) [@ Rescale] @ Pa(pixel_aspect)
      B = Pa [@ Rescale] @ R(rot)
    """
    pixel_aspect = torch.as_tensor(
        pixel_aspect, dtype=p.squeeze_x.dtype, device=p.squeeze_x.device
    )
    rot = rotation_matrix_2d(p.lens_rotation * DEG2RAD)
    sx = diag2(p.squeeze_x, torch.ones_like(p.squeeze_x))
    sy = diag2(torch.ones_like(p.squeeze_y), p.squeeze_y)
    pa = diag2(pixel_aspect, torch.ones_like(pixel_aspect))
    if rescale is None:
        a = rot @ sx @ sy @ pa
        b = pa @ rot
    else:
        # The reference's rescale extender scales x only (it reuses
        # squeeze_x_extender; ref: distortion_structs.h:289-299).
        rs = diag2(rescale, torch.ones_like(rescale))
        a = rot @ sx @ sy @ rs @ pa
        b = pa @ rs @ rot
    return a, b


def _anamorphic_undistort_dn(p, xy, pixel_aspect, rescale=None):
    a, b = _anamorphic_matrices(p, pixel_aspect, rescale)
    inner = mat2_apply(inverse2(b), xy)
    return mat2_apply(a, _anamorphic_core(p, inner))


def _anamorphic_distort_dn(p, xy, pixel_aspect, rescale=None):
    a, b = _anamorphic_matrices(p, pixel_aspect, rescale)
    target = mat2_apply(inverse2(a), xy)
    inv = fixed_point_inverse(lambda q: _anamorphic_core(p, q), target)
    return mat2_apply(b, inv)


def _pixel_aspect_and_rescale(model, film_back):
    pa = film_back.pixel_aspect if film_back is not None else 1.0
    rescale = (
        model.rescale if isinstance(model, TdeAnamorphicStdDeg4Rescaled)
        else None
    )
    return pa, rescale


# ---------------------------------------------------------------------------
# Uniform dispatch.

def undistort_dn(model, xy_dn, film_back: FilmBack = None):
    """Remove distortion in diagonally-normalized space."""
    if isinstance(model, Passthrough):
        return xy_dn
    if isinstance(model, TdeClassic):
        return _classic_undistort_dn(model, xy_dn)
    if isinstance(model, TdeRadialStdDeg4):
        return _radial_deg4_undistort_dn(model, xy_dn)
    if isinstance(model, TdeAnamorphicStdDeg4):
        pa, rescale = _pixel_aspect_and_rescale(model, film_back)
        return _anamorphic_undistort_dn(model, xy_dn, pa, rescale)
    raise TypeError("unknown lens model: %r" % (type(model),))


def distort_dn(model, xy_dn, film_back: FilmBack = None):
    """Apply distortion (iterative inverse of undistort)."""
    if isinstance(model, Passthrough):
        return xy_dn
    if isinstance(model, TdeClassic):
        return fixed_point_inverse(
            lambda q: _classic_undistort_dn(model, q), xy_dn
        )
    if isinstance(model, TdeRadialStdDeg4):
        return _radial_deg4_distort_dn(model, xy_dn)
    if isinstance(model, TdeAnamorphicStdDeg4):
        pa, rescale = _pixel_aspect_and_rescale(model, film_back)
        return _anamorphic_distort_dn(model, xy_dn, pa, rescale)
    raise TypeError("unknown lens model: %r" % (type(model),))


def undistort(model, film_back: FilmBack, xy_marker):
    """Remove distortion in the solver's [-0.5, 0.5] screen space
    (ref: LensModel::applyModelUndistort, lens_model_3de_classic.cpp:37)."""
    return apply_in_marker_space(
        lambda dn: undistort_dn(model, dn, film_back), film_back, xy_marker
    )


def distort(model, film_back: FilmBack, xy_marker):
    """Apply distortion in the solver's [-0.5, 0.5] screen space
    (ref: LensModel::applyModelDistort, lens_model_3de_classic.cpp:75)."""
    return apply_in_marker_space(
        lambda dn: distort_dn(model, dn, film_back), film_back, xy_marker
    )
