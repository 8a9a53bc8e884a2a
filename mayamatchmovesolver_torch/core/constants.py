"""Unit conversions and enums shared across the framework.

Mirrors the semantics of the reference's constants
(ref: lib/rust/mmscenegraph/src/constant.rs and
lib/cppbind/mmcore/include/mmcore/mmdata.h) without copying its layout.
"""

import enum

import numpy as np

# Unit conversion factors. Maya's camera attributes mix units: film back
# is stored in inches, focal length in millimetres, world space in
# centimetres (ref: lib/rust/mmscenegraph/src/math/camera.rs:163-174).
MM_TO_INCH = 1.0 / 25.4
INCH_TO_MM = 25.4
MM_TO_CM = 0.1
CM_TO_MM = 10.0

DEGREES_TO_RADIANS = np.pi / 180.0
RADIANS_TO_DEGREES = 180.0 / np.pi


class FilmFit(enum.IntEnum):
    """How the film gate is fitted to the render resolution gate.

    Numeric values match the reference's FilmFit enum
    (ref: lib/rust/mmscenegraph/src/math/camera.rs:32-37).
    """

    FILL = 0
    HORIZONTAL = 1
    VERTICAL = 2
    OVERSCAN = 3


class RotateOrder(enum.IntEnum):
    """Euler rotation orders; values match Maya / the reference
    (ref: lib/rust/mmscenegraph/src/math/rotate/euler.rs)."""

    XYZ = 0
    YZX = 1
    ZXY = 2
    XZY = 3
    YXZ = 4
    ZYX = 5


# For rotate order o, ROTATE_ORDER_PERMS[o] = (first, second, third) axis
# applied to the point, where axis 0=X, 1=Y, 2=Z.  The combined rotation
# acting on column vectors is R = M[third] @ M[second] @ M[first]
# (ref semantics: lib/rust/mmscenegraph/src/math/transform.rs:433-440).
ROTATE_ORDER_PERMS = np.array(
    [
        [0, 1, 2],  # XYZ
        [1, 2, 0],  # YZX
        [2, 0, 1],  # ZXY
        [0, 2, 1],  # XZY
        [1, 0, 2],  # YXZ
        [2, 1, 0],  # ZYX
    ],
    dtype=np.int32,
)

# The solver treats attribute min/max beyond +-FLOAT_MAX as "unbounded"
# (ref: src/mmSolver/adjust/adjust_base.cpp:196-258).
FLOAT_MAX = float(np.finfo(np.float32).max)
