"""Plain 3DEqualizer classic lens ("3DE Classic LD Model", ldpk's
classic_3de_mixed_distortion) in the solver's screen space.

Screen positions p in [-0.5, 0.5] become unit film coordinates p + 0.5
and then diagonally normalised ones: film-back centimetres about the
lens centre over half the film-back diagonal.  Undistortion is the
polynomial; distortion is its inverse, found by Newton's method in the
working precision (converged to its last bits at these distortions).
"""

import torch

NEWTON_STEPS = 8


def _coefficients(distortion, squeeze=1.0, curvature_x=0.0, curvature_y=0.0,
                  quartic=0.0):
    """(x: c_xx, c_xy, c_xxx, c_xxy, c_xyy; y: c_yx, c_yy, c_yxx, c_yyx,
    c_yyy) of the mixed model."""
    return ((distortion / squeeze, (distortion + curvature_x) / squeeze,
             quartic / squeeze, 2.0 * quartic / squeeze, quartic / squeeze),
            (distortion + curvature_y, distortion, quartic, 2.0 * quartic,
             quartic))


def _undistort_and_jacobian(p, distortion, **coefficients):
    (a1, a2, a3, a4, a5), (b1, b2, b3, b4, b5) = _coefficients(
        distortion, **coefficients)
    x, y = p[..., 0], p[..., 1]
    x2, y2 = x * x, y * y
    fx = 1.0 + a1 * x2 + a2 * y2 + a3 * x2 * x2 + a4 * x2 * y2 + a5 * y2 * y2
    fy = 1.0 + b1 * x2 + b2 * y2 + b3 * x2 * x2 + b4 * x2 * y2 + b5 * y2 * y2
    dxx = fx + x2 * (2.0 * a1 + 4.0 * a3 * x2 + 2.0 * a4 * y2)
    dxy = x * y * (2.0 * a2 + 2.0 * a4 * x2 + 4.0 * a5 * y2)
    dyx = x * y * (2.0 * b1 + 4.0 * b3 * x2 + 2.0 * b4 * y2)
    dyy = fy + y2 * (2.0 * b2 + 2.0 * b4 * x2 + 4.0 * b5 * y2)
    return torch.stack([x * fx, y * fy], -1), (dxx, dxy, dyx, dyy)


def undistort_dn(p, distortion, **coefficients):
    return _undistort_and_jacobian(p, distortion, **coefficients)[0]


def distort_dn(q, distortion, **coefficients):
    """The p with undistort_dn(p) = q, by Newton's method from p = q."""
    p = q
    for _ in range(NEWTON_STEPS):
        u, (dxx, dxy, dyx, dyy) = _undistort_and_jacobian(
            p, distortion, **coefficients)
        ex, ey = u[..., 0] - q[..., 0], u[..., 1] - q[..., 1]
        det = dxx * dyy - dxy * dyx
        p = p - torch.stack([(dyy * ex - dxy * ey) / det,
                             (dxx * ey - dyx * ex) / det], -1)
    return p


def _film(film_back_cm):
    width, height = film_back_cm
    radius = (width * width + height * height) ** 0.5 / 2.0
    return width / radius, height / radius


def screen_to_dn(p, film_back_cm):
    sx, sy = _film(film_back_cm)
    return torch.stack([p[..., 0] * sx, p[..., 1] * sy], -1)


def dn_to_screen(q, film_back_cm):
    sx, sy = _film(film_back_cm)
    return torch.stack([q[..., 0] / sx, q[..., 1] / sy], -1)


def distort(p, distortion, film_back_cm, **coefficients):
    """Screen positions through the lens (as a plate records them)."""
    return dn_to_screen(distort_dn(screen_to_dn(p, film_back_cm),
                                   distortion, **coefficients), film_back_cm)


def undistort(p, distortion, film_back_cm, **coefficients):
    return dn_to_screen(undistort_dn(screen_to_dn(p, film_back_cm),
                                     distortion, **coefficients),
                        film_back_cm)
