"""Lens distortion framework: coordinate spaces and direction protocol.

Port of mayamatchmovesolver_tpu/models/base.py (ref:
lib/cppbind/mmlens/include/mmlens/lib.h:36-77 and lens_model.h:36-120):
models operate in *diagonally normalized* (dn) coordinates — film-back
cm divided by half the film-back diagonal, with the lens center offset
removed.  Public entry points take "marker" coordinates in [-0.5, 0.5]
(the solver's screen space) and convert.

Direction naming, matching the reference:
  undistort  = remove distortion  (analytic polynomial 'eval')
  distort    = apply distortion   (iterative inverse, 'map_inverse')
"""

import dataclasses

import torch

# Fixed-point inversion iterations.  ldpk iterates until 1e-6 with max
# 20 + 2 post-iterations (ref: ldpk generic_distortion_base); the port
# runs the reference package's fixed count.
DISTORT_INVERSE_ITERATIONS = 20


@dataclasses.dataclass(frozen=True)
class FilmBack:
    """Camera parameters the lens models need
    (ref: mmlens CameraParameters, src/_cxxbridge.cpp:446-453)."""

    film_back_width_cm: torch.Tensor
    film_back_height_cm: torch.Tensor
    lens_center_offset_x_cm: torch.Tensor
    lens_center_offset_y_cm: torch.Tensor
    pixel_aspect: torch.Tensor

    @staticmethod
    def create(width_cm=3.6, height_cm=2.4, offset_x_cm=0.0,
               offset_y_cm=0.0, pixel_aspect=1.0, *, device, dtype=None):
        """Scalar tensors on `device`; dtype defaults to torch's default
        float type."""
        def as_t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        return FilmBack(
            as_t(width_cm), as_t(height_cm), as_t(offset_x_cm),
            as_t(offset_y_cm), as_t(pixel_aspect),
        )


def as_tensors(obj, *, device, dtype):
    """A model or film back with every field that is a Python number
    made a scalar tensor of `dtype` on `device` (io/lensfile.py's
    models_at and film_back hand out such fields); tensor fields stay as
    they are."""
    numbers = {
        f.name: torch.as_tensor(getattr(obj, f.name), dtype=dtype,
                                device=device)
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), torch.Tensor)
    }
    return dataclasses.replace(obj, **numbers) if numbers else obj


def film_back_radius_cm(fb: FilmBack):
    """Half film-back diagonal (ref: lib.h:36-43)."""
    return torch.sqrt(
        fb.film_back_width_cm**2 + fb.film_back_height_cm**2
    ) / 2.0


def unit_to_dn(fb: FilmBack, xy_unit):
    """[0,1] unit film coords -> diagonally normalized (ref: lib.h:45-58)."""
    radius = film_back_radius_cm(fb)
    x = (
        (xy_unit[..., 0] - 0.5) * fb.film_back_width_cm
        - fb.lens_center_offset_x_cm
    ) / radius
    y = (
        (xy_unit[..., 1] - 0.5) * fb.film_back_height_cm
        - fb.lens_center_offset_y_cm
    ) / radius
    return torch.stack([x, y], dim=-1)


def dn_to_unit(fb: FilmBack, xy_dn):
    """(ref: lib.h:60-77)."""
    radius = film_back_radius_cm(fb)
    x_cm = xy_dn[..., 0] * radius + fb.film_back_width_cm / 2.0 \
        + fb.lens_center_offset_x_cm
    y_cm = xy_dn[..., 1] * radius + fb.film_back_height_cm / 2.0 \
        + fb.lens_center_offset_y_cm
    return torch.stack(
        [x_cm / fb.film_back_width_cm, y_cm / fb.film_back_height_cm],
        dim=-1,
    )


def fixed_point_inverse(eval_fn, q_dn, iterations=DISTORT_INVERSE_ITERATIONS):
    """Solve eval_fn(p) = q for p with the ldpk fixed-point scheme
    p <- p + (q - eval_fn(p)), a fixed iteration count."""
    p = q_dn - (eval_fn(q_dn) - q_dn)
    for _ in range(iterations):
        p = p + (q_dn - eval_fn(p))
    return p


def marker_to_unit(xy_marker):
    """Solver screen space [-0.5, 0.5] -> unit [0, 1]
    (ref: lens_model_3de_classic.cpp:63-71)."""
    return xy_marker + 0.5


def unit_to_marker(xy_unit):
    return xy_unit - 0.5


def apply_in_marker_space(fn_dn, fb: FilmBack, xy_marker):
    """Lift a dn-space mapping to the solver's [-0.5, 0.5] space."""
    unit = marker_to_unit(xy_marker)
    dn = unit_to_dn(fb, unit)
    out_dn = fn_dn(dn)
    out_unit = dn_to_unit(fb, out_dn)
    return unit_to_marker(out_unit)


def rotation_matrix_2d(phi_rad):
    c, s = torch.cos(phi_rad), torch.sin(phi_rad)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def diag2(a, b):
    a, b = torch.broadcast_tensors(a, b)
    zero = torch.zeros_like(a)
    return torch.stack(
        [torch.stack([a, zero], dim=-1), torch.stack([zero, b], dim=-1)],
        dim=-2,
    )


def inverse2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv = torch.stack(
        [
            torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
            torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def mat2_apply(m, xy):
    """(..., 2, 2) @ (..., 2) with broadcasting over the leading dims."""
    return torch.matmul(m, xy[..., None])[..., 0]
