"""The yardstick's constants: published peaks of one H100, and what an
ST map of a lens needs at the least.

Frozen copies, so that later changes to the program cannot move them:
H100_*, STMAP_FRAME_FLOPS, STMAP_STEP_FLOPS, stmap_flops and stmap_bound
are chip_smoke.py's (H100_FP32_FLOPS, H100_HBM_BYTES_PER_S,
STMAP_FRAME_FLOPS, STMAP_STEP_FLOPS, stmap_flops, stmap_bound) as
kept for the ST-map kernel, with the fixed point's iteration count
(mayamatchmovesolver_torch/models/base.py DISTORT_INVERSE_ITERATIONS,
20) written in.
"""

# NVIDIA's data sheet, H100 SXM, dense: float32 outside the tensor cores
# and HBM3 bandwidth, at the full 700 W power limit.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# Floating-point operations per pixel a map needs, an FMA as two.  The
# frame: pixel to lens coordinates and back are two affine maps (8
# each).  A step of the classic core, x2, y2, r2, r4 and 7 per axis, is
# 18.  Undistort is one step; distort is the fixed point, one step to
# start and one an iteration.
STMAP_FRAME_FLOPS = 16
STMAP_STEP_FLOPS = {"TdeClassic": 18, "TdeRadialStdDeg4": 28,
                    "TdeAnamorphicStdDeg4": 26,
                    "TdeAnamorphicStdDeg4Rescaled": 26}
DISTORT_INVERSE_ITERATIONS = 20


def stmap_flops(model_name, direction):
    """Floating-point operations per pixel the map needs."""
    steps = 1 + (DISTORT_INVERSE_ITERATIONS if direction == "distort" else 0)
    return STMAP_FRAME_FLOPS + steps * STMAP_STEP_FLOPS[model_name]


def stmap_bound(model_name, direction, width, height, from_map=False):
    """(seconds, 'bytes' or 'operations'): the least time one H100 could
    take for this map, the larger of its bytes (a 16-byte texel written
    a pixel; from a map, read first too) over the memory rate and its
    operations over the float32 rate."""
    pixels = width * height
    bytes_s = pixels * (32 if from_map else 16) / H100_HBM_BYTES_PER_S
    flops_s = pixels * stmap_flops(model_name, direction) / H100_FP32_FLOPS
    if bytes_s >= flops_s:
        return bytes_s, "bytes"
    return flops_s, "operations"
