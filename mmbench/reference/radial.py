"""Plain 3DEqualizer 4 radial lens of degree 4 with its cylindric
extender, and its ST maps.

Plain PyTorch, float64 unless the caller asks for another dtype, written
from the published description.  It imports nothing of the program under
test; the Nuke reader and the Camera are reference/anamorphic.py's.  A
lens is a dict of Nuke knob names to numbers, as the script holds them: a
knob it lacks takes its neutral value, 0.

The lens: "3DE4 Radial - Standard, Degree 4" of 3DEqualizer's lens
distortion plugin kit (ldpk), its radial decentered distortion followed
by its cylindric extender.  Screen positions p in [-0.5, 0.5] become
diagonally normalised ones, as in reference/anamorphic.py: film-back
centimetres about the lens centre (the offset knobs) over half the
film-back diagonal.  There, with r^2 = x^2 + y^2,

    x' = x (1 + c2 r^2 + c4 r^4) + (r^2 + 2 x^2) (u2 + u4 r^2)
         + 2 x y (v2 + v4 r^2)
    y' = y (1 + c2 r^2 + c4 r^4) + (r^2 + 2 y^2) (v2 + v4 r^2)
         + 2 x y (u2 + u4 r^2)

(c2, u2, v2: Distortion_Degree_2, U_Degree_2, V_Degree_2; c4, u4, v4:
Quartic_Distortion_Degree_4, U_Degree_4, V_Degree_4), and the cylindric
extender is the symmetric matrix, with q = sqrt(1 + B), c = cos phi and
s = sin phi (phi = Phi_Cylindric_Direction in degrees, B =
B_Cylindric_Bending),

    C = [[c^2 q + s^2 / q, (q - 1/q) c s],
         [(q - 1/q) c s,   c^2 / q + s^2 q]]

so that

    undistort(p) = C core(p)
    distort(q)   = core^-1(C^-1 q).

A stack of lenses distorts through its layers in order and undistorts
through them in reverse.  ST maps as in reference/anamorphic.py.

Departures from the published description:
  * core^-1 by Newton's method from the target point, NEWTON_STEPS steps
    with the core's Jacobian, where ldpk iterates the fixed point
    p <- p + (q - core(p)): both converge to the same point, Newton's to
    the working precision's last bits at such lenses.
  * The pixel aspect does not enter this lens (only the anamorphic
    lenses take it).
"""

import math

import torch

from mmbench.reference.anamorphic import (  # noqa: F401  (re-exported)
    Camera,
    at_frame,
    camera_of,
    read_nuke,
)

NEWTON_STEPS = 10

# The core's coefficients, in the order (c2, u2, v2, c4, u4, v4).
KNOBS = ("Distortion_Degree_2", "U_Degree_2", "V_Degree_2",
         "Quartic_Distortion_Degree_4", "U_Degree_4", "V_Degree_4")


def _coefficients(lens):
    return tuple(float(lens.get(name, 0.0)) for name in KNOBS)


def core(p, lens):
    """The radial decentered distortion of diagonally normalised points
    (..., 2)."""
    c2, u2, v2, c4, u4, v4 = _coefficients(lens)
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + c2 * r2 + c4 * r2 * r2
    u, v = u2 + u4 * r2, v2 + v4 * r2
    return torch.stack([x * radial + (r2 + 2.0 * x * x) * u + 2.0 * x * y * v,
                        y * radial + (r2 + 2.0 * y * y) * v + 2.0 * x * y * u],
                       -1)


def _jacobian(p, lens):
    """(dx'/dx, dx'/dy, dy'/dx, dy'/dy) of the core.  With R = 1 + c2 r^2
    + c4 r^4, U = u2 + u4 r^2, V = v2 + v4 r^2 and d(r^2) = (2x, 2y):
    dx'/dx = R + 2x^2 R' + 6x U + 2x (r^2 + 2x^2) u4 + 2y V + 4x^2 y v4,
    and so on, R' = c2 + 2 c4 r^2."""
    c2, u2, v2, c4, u4, v4 = _coefficients(lens)
    x, y = p[..., 0], p[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    radial = 1.0 + c2 * r2 + c4 * r2 * r2
    slope = c2 + 2.0 * c4 * r2
    u, v = u2 + u4 * r2, v2 + v4 * r2
    wx, wy = r2 + 2.0 * x2, r2 + 2.0 * y2
    dxx = (radial + 2.0 * x2 * slope + 6.0 * x * u + 2.0 * x * wx * u4
           + 2.0 * y * v + 4.0 * x * xy * v4)
    dxy = (2.0 * xy * slope + 2.0 * y * u + 2.0 * y * wx * u4 + 2.0 * x * v
           + 4.0 * y * xy * v4)
    dyx = (2.0 * xy * slope + 2.0 * x * v + 2.0 * x * wy * v4 + 2.0 * y * u
           + 4.0 * x * xy * u4)
    dyy = (radial + 2.0 * y2 * slope + 6.0 * y * v + 2.0 * y * wy * v4
           + 2.0 * x * u + 4.0 * y * xy * u4)
    return dxx, dxy, dyx, dyy


def core_inverse(q, lens):
    """The p with core(p) = q, by Newton's method from p = q."""
    p = q
    for _ in range(NEWTON_STEPS):
        e = core(p, lens) - q
        dxx, dxy, dyx, dyy = _jacobian(p, lens)
        det = dxx * dyy - dxy * dyx
        p = p - torch.stack([(dyy * e[..., 0] - dxy * e[..., 1]) / det,
                             (dxx * e[..., 1] - dyx * e[..., 0]) / det], -1)
    return p


def cylindric(lens):
    """The cylindric extender's matrix C as a 2x2 tuple of floats."""
    phi = math.radians(float(lens.get("Phi_Cylindric_Direction", 0.0)))
    q = math.sqrt(1.0 + float(lens.get("B_Cylindric_Bending", 0.0)))
    c, s = math.cos(phi), math.sin(phi)
    off = (q - 1.0 / q) * c * s
    return ((c * c * q + s * s / q, off), (off, c * c / q + s * s * q))


def _apply(m, p):
    (a, b), (c, d) = m
    return torch.stack([a * p[..., 0] + b * p[..., 1],
                        c * p[..., 0] + d * p[..., 1]], -1)


def _inverse(m):
    (a, b), (c, d) = m
    det = a * d - b * c
    return ((d / det, -b / det), (-c / det, a / det))


def undistort_dn(p, lens):
    return _apply(cylindric(lens), core(p, lens))


def distort_dn(q, lens):
    return core_inverse(_apply(_inverse(cylindric(lens)), q), lens)


def undistort(p, lenses, camera):
    """Screen positions with a stack's distortion removed."""
    for lens in reversed(lenses):
        p = camera.to_screen(undistort_dn(camera.to_dn(p), lens))
    return p


def distort(p, lenses, camera):
    """Screen positions through a stack (as a plate records them)."""
    for lens in lenses:
        p = camera.to_screen(distort_dn(camera.to_dn(p), lens))
    return p


def stmap(lenses, camera, width, height, direction, *,
          dtype=torch.float64, device="cpu"):
    """(H, W, 4) map in `dtype` of a stack of lenses (a list of dicts of
    knobs), distorting or undistorting."""
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) / height
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    screen = torch.stack([gx - 0.5, gy - 0.5], -1)
    mapped = (distort if direction == "distort" else undistort)(
        screen, lenses, camera)
    uv = mapped + 0.5
    return torch.cat([uv, torch.zeros_like(uv[..., :1]),
                      torch.ones_like(uv[..., :1])], -1)
