"""Plain 3DEqualizer 4 anamorphic lens of degree 4, standard and rescaled,
its ST maps, and a plain reader of a Nuke script's LD_3DE4_* nodes.

Plain PyTorch, float64 unless the caller asks for another dtype, written
from the published description.  It imports nothing of the program under
test.  A lens is a dict of Nuke knob names to numbers, as the script
holds them: a knob it lacks takes its neutral value.

The lens: "3DE4 Anamorphic - Standard, Degree 4" and "3DE4 Anamorphic -
Rescaled, Degree 4" of 3DEqualizer's lens distortion plugin kit (ldpk).
Screen positions p in [-0.5, 0.5] become diagonally normalised ones:
film-back centimetres about the lens centre (the offset knobs) over half
the film-back diagonal.  There, with r = |p| and phi its angle, the
polynomial core is

    x' = x (1 + Cx02 r^2 + Cx04 r^4 + (Cx22 r^2 + Cx24 r^4) cos 2phi
            + Cx44 r^4 cos 4phi)
    y' = y (1 + Cy02 r^2 + Cy04 r^4 + (Cy22 r^2 + Cy24 r^4) cos 2phi
            + Cy44 r^4 cos 4phi)

and around it the extenders, as mmSolver wires them
(lib/cppbind/mmlens/src/distortion_structs.h): with R the rotation by
Lens_Rotation degrees, Sx = diag(Squeeze_X, 1), Sy = diag(1, Squeeze_Y),
S = diag(Rescale, 1) (the identity for the standard lens; it scales x
only, as the squeeze-x extender does) and P = diag(pixel aspect, 1),

    undistort(p) = R Sx Sy S P core((P S R)^-1 p)
    distort(q)   = P S R core^-1((R Sx Sy S P)^-1 q).

A stack of lenses distorts through its layers in order and undistorts
through them in reverse.  An ST map holds, for every pixel (row j,
column i), the point ((i + 0.5) / W, (j + 0.5) / H) mapped through the
lens, in channels S and T, with B = 0 and A = 1.

Departures from the published description:
  * core^-1 by Newton's method from the target point, NEWTON_STEPS steps
    with the core's Jacobian, where ldpk iterates the fixed point
    p <- p + (q - core(p)) to 1e-6: both converge to the same point,
    Newton's to the working precision's last bits at such lenses.
  * The Nuke reader takes the curves of 3DEqualizer's export, every key
    `x<frame> <value>`; a knob at a frame without a key raises KeyError,
    where a program may hold a key.  Knobs that are not numbers are
    skipped.
"""

import math

import torch

NEWTON_STEPS = 10

# Each axis's coefficients, in the order (c02, c22, c04, c24, c44).
X_KNOBS = ("Cx02_Degree_2", "Cx22_Degree_2", "Cx04_Degree_4",
           "Cx24_Degree_4", "Cx44_Degree_4")
Y_KNOBS = ("Cy02_Degree_2", "Cy22_Degree_2", "Cy04_Degree_4",
           "Cy24_Degree_4", "Cy44_Degree_4")
NEUTRAL = {"Lens_Rotation": 0.0, "Squeeze_X": 1.0, "Squeeze_Y": 1.0,
           "Rescale": 1.0}


def _knob(lens, name):
    return float(lens.get(name, NEUTRAL.get(name, 0.0)))


def _factor(r2, cos2, cos4, c02, c22, c04, c24, c44):
    r4 = r2 * r2
    return (1.0 + c02 * r2 + c04 * r4 + (c22 * r2 + c24 * r4) * cos2
            + c44 * r4 * cos4)


def core(p, lens):
    """The polynomial core of diagonally normalised points (..., 2)."""
    x, y = p[..., 0], p[..., 1]
    phi = torch.atan2(y, x)
    r2 = x * x + y * y
    cos2, cos4 = torch.cos(2.0 * phi), torch.cos(4.0 * phi)
    fx = _factor(r2, cos2, cos4, *(_knob(lens, k) for k in X_KNOBS))
    fy = _factor(r2, cos2, cos4, *(_knob(lens, k) for k in Y_KNOBS))
    return torch.stack([x * fx, y * fy], -1)


def _jacobian(p, lens):
    """(dx'/dx, dx'/dy, dy'/dx, dy'/dy) of the core.  With s = r^2 and
    d = x^2 - y^2: r^2 cos 2phi = d, r^4 cos 2phi = s d and
    r^4 cos 4phi = 2 d^2 - s^2, so a factor is a polynomial in s and d."""
    x, y = p[..., 0], p[..., 1]
    s, d = x * x + y * y, x * x - y * y

    def parts(c02, c22, c04, c24, c44):
        f = (1.0 + c02 * s + c04 * s * s + c22 * d + c24 * s * d
             + c44 * (2.0 * d * d - s * s))
        f_s = c02 + 2.0 * c04 * s + c24 * d - 2.0 * c44 * s
        f_d = c22 + c24 * s + 4.0 * c44 * d
        return f, f_s, f_d

    fx, fx_s, fx_d = parts(*(_knob(lens, k) for k in X_KNOBS))
    fy, fy_s, fy_d = parts(*(_knob(lens, k) for k in Y_KNOBS))
    # ds/dx = dd/dx = 2x; ds/dy = 2y, dd/dy = -2y.
    return (fx + 2.0 * x * x * (fx_s + fx_d), 2.0 * x * y * (fx_s - fx_d),
            2.0 * x * y * (fy_s + fy_d), fy + 2.0 * y * y * (fy_s - fy_d))


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


def _apply(m, p):
    (a, b), (c, d) = m
    return torch.stack([a * p[..., 0] + b * p[..., 1],
                        c * p[..., 0] + d * p[..., 1]], -1)


def _inverse(m):
    (a, b), (c, d) = m
    det = a * d - b * c
    return ((d / det, -b / det), (-c / det, a / det))


def extenders(lens, pixel_aspect):
    """(R Sx Sy S P, P S R) as 2x2 tuples of floats."""
    phi = math.radians(_knob(lens, "Lens_Rotation"))
    c, s = math.cos(phi), math.sin(phi)
    x_scale = _knob(lens, "Rescale") * pixel_aspect
    sx, sy = _knob(lens, "Squeeze_X"), _knob(lens, "Squeeze_Y")
    outer = ((c * sx * x_scale, -s * sy), (s * sx * x_scale, c * sy))
    inner = ((x_scale * c, -x_scale * s), (s, c))
    return outer, inner


def undistort_dn(p, lens, pixel_aspect):
    outer, inner = extenders(lens, pixel_aspect)
    return _apply(outer, core(_apply(_inverse(inner), p), lens))


def distort_dn(q, lens, pixel_aspect):
    outer, inner = extenders(lens, pixel_aspect)
    return _apply(inner, core_inverse(_apply(_inverse(outer), q), lens))


class Camera:
    """The film back in centimetres, the lens centre's offset from the
    film back's centre in centimetres, and the pixel aspect."""

    def __init__(self, film_back_cm, pixel_aspect=1.0, offset_cm=(0.0, 0.0)):
        self.width, self.height = (float(v) for v in film_back_cm)
        self.offset_x, self.offset_y = (float(v) for v in offset_cm)
        self.pixel_aspect = float(pixel_aspect)
        self.radius = math.hypot(self.width, self.height) / 2.0

    def to_dn(self, p):
        return torch.stack(
            [(p[..., 0] * self.width - self.offset_x) / self.radius,
             (p[..., 1] * self.height - self.offset_y) / self.radius], -1)

    def to_screen(self, q):
        return torch.stack(
            [(q[..., 0] * self.radius + self.offset_x) / self.width,
             (q[..., 1] * self.radius + self.offset_y) / self.height], -1)


def undistort(p, lenses, camera):
    """Screen positions with a stack's distortion removed."""
    for lens in reversed(lenses):
        p = camera.to_screen(undistort_dn(camera.to_dn(p), lens,
                                          camera.pixel_aspect))
    return p


def distort(p, lenses, camera):
    """Screen positions through a stack (as a plate records them)."""
    for lens in lenses:
        p = camera.to_screen(distort_dn(camera.to_dn(p), lens,
                                        camera.pixel_aspect))
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


def read_nuke(text):
    """[(node class, {knob: value})] of the LD_3DE4_* nodes of a Nuke
    script, in order.  A knob's value is its number, or for a curve
    {frame: number}."""
    nodes, knobs = [], None
    for line in text.splitlines():
        words = line.split()
        if not words:
            continue
        if knobs is None:
            if words[0].startswith("LD_3DE4_") and words[-1] == "{":
                knobs = {}
                nodes.append((words[0], knobs))
            continue
        if words[0] == "}":
            knobs = None
            continue
        value = " ".join(words[1:])
        if value.startswith("{{curve"):
            keys = value[len("{{curve"):].replace("}", " ").split()
            knobs[words[0]] = {int(keys[i][1:]): float(keys[i + 1])
                               for i in range(0, len(keys), 2)}
            continue
        try:
            knobs[words[0]] = float(value)
        except ValueError:
            pass
    return nodes


def at_frame(knobs, frame):
    """Each knob's number at `frame`: a static knob's, or an animated
    knob's key at exactly that frame."""
    return {name: value[frame] if isinstance(value, dict) else value
            for name, value in knobs.items()}


def camera_of(knobs):
    """The Camera of a node's tde4_* knobs at a frame (at_frame)."""
    return Camera((knobs["tde4_filmback_width_cm"],
                   knobs["tde4_filmback_height_cm"]),
                  knobs.get("tde4_pixel_aspect", 1.0),
                  (knobs.get("tde4_lens_center_offset_x_cm", 0.0),
                   knobs.get("tde4_lens_center_offset_y_cm", 0.0)))
