"""Plain stack of 3DEqualizer lenses of different kinds, as a Nuke script
of several LD_3DE* nodes hands one over, and its ST maps.

Plain PyTorch, float64 unless the caller asks for another dtype.  It
imports nothing of the program under test, and turns TF32 off for the
process (it multiplies no matrices; the setting keeps any product on
the card in float32).  A stack is a list of (node class, knobs), in the
file's order, each knobs a dict of Nuke knob names to numbers; a knob a
node lacks takes its neutral value.  Each layer goes by its node class
to a plain lens of its own kind:

  * LD_3DE4_Radial_Standard_Degree_4: reference/radial.py's undistort_dn
    and distort_dn, fed the knobs as they are;
  * LD_3DE_Classic_LD_Model: reference/lens.py's, fed its keyword
    arguments through CLASSIC_KNOBS.

Every layer works in diagonally normalised coordinates of the one
camera the file's nodes share (reference/anamorphic.py's Camera):
film-back centimetres about the lens centre over half the film-back
diagonal.  As mmSolver chains the layers (DistortionLayers,
lib/cppbind/mmlens/src/distortion_layers.rs:255), a stack distorts
through its layers in order and undistorts through them in reverse, each
layer from screen space back to screen space.  ST maps as in
reference/anamorphic.py.

Departures from the published description:
  * Each distort is its lens file's Newton's method from the target
    point (radial.NEWTON_STEPS, lens.NEWTON_STEPS steps with the core's
    Jacobian), where ldpk iterates the fixed point p <- p + (q - core(p)):
    both converge to the same point, Newton's to the working precision's
    last bits at such lenses.
  * Neither lens takes the pixel aspect (only the anamorphic lenses do).
"""

import torch

from mmbench.reference import lens as classic
from mmbench.reference import radial
from mmbench.reference.anamorphic import Camera  # noqa: F401  (re-exported)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RADIAL = "LD_3DE4_Radial_Standard_Degree_4"
CLASSIC = "LD_3DE_Classic_LD_Model"

# The classic lens's Nuke knobs and reference/lens.py's arguments.
CLASSIC_KNOBS = {"Distortion": "distortion",
                 "Anamorphic_Squeeze": "squeeze",
                 "Curvature_X": "curvature_x",
                 "Curvature_Y": "curvature_y",
                 "Quartic_Distortion": "quartic"}
CLASSIC_NEUTRAL = {"Anamorphic_Squeeze": 1.0}


def _classic_arguments(knobs):
    return {arg: float(knobs.get(knob, CLASSIC_NEUTRAL.get(knob, 0.0)))
            for knob, arg in CLASSIC_KNOBS.items()}


def undistort_dn(p, node, knobs):
    """One layer's undistortion of diagonally normalised points."""
    if node == RADIAL:
        return radial.undistort_dn(p, knobs)
    if node == CLASSIC:
        return classic.undistort_dn(p, **_classic_arguments(knobs))
    raise ValueError("no plain lens for node class %r" % (node,))


def distort_dn(q, node, knobs):
    """One layer's distortion of diagonally normalised points."""
    if node == RADIAL:
        return radial.distort_dn(q, knobs)
    if node == CLASSIC:
        return classic.distort_dn(q, **_classic_arguments(knobs))
    raise ValueError("no plain lens for node class %r" % (node,))


def undistort(p, lenses, camera):
    """Screen positions with a stack's distortion removed: its layers'
    undistortions in reverse order."""
    for node, knobs in reversed(lenses):
        p = camera.to_screen(undistort_dn(camera.to_dn(p), node, knobs))
    return p


def distort(p, lenses, camera):
    """Screen positions through a stack (as a plate records them): its
    layers' distortions in order."""
    for node, knobs in lenses:
        p = camera.to_screen(distort_dn(camera.to_dn(p), node, knobs))
    return p


def stmap(lenses, camera, width, height, direction, *,
          dtype=torch.float64, device="cpu"):
    """(H, W, 4) map in `dtype` of a stack of lenses (a list of (node
    class, knobs)), distorting or undistorting."""
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) / height
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    screen = torch.stack([gx - 0.5, gy - 0.5], -1)
    mapped = (distort if direction == "distort" else undistort)(
        screen, lenses, camera)
    uv = mapped + 0.5
    return torch.cat([uv, torch.zeros_like(uv[..., :1]),
                      torch.ones_like(uv[..., :1])], -1)

