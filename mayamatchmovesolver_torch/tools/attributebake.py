"""Attribute baking: dense resampling + smart-bake key reduction.

Capability of the reference's attributebake tool
(ref: python/mmSolver/tools/attributebake/lib.py:51 bake_attributes —
maya.cmds.bakeResults with smart_bake; lib.py:34 frame-range modes) and
the smoothkeyframes tool (ref: tools/smoothkeyframes — runs
utils.smooth over selected keys; our utils/smooth.py holds the
average/gaussian/fourier kernels).

Port of mayamatchmovesolver_tpu/tools/attributebake.py: a copy of the
reference's host code.
"""

import numpy as np

from mayamatchmovesolver_torch.utils import animcurve, smooth


def bake_frame_range(frame_range_mode, scene_range, custom_range=None):
    """Resolve the bake range (ref: attributebake/lib.py:34
    get_bake_frame_range; modes timeline/custom)."""
    if frame_range_mode == "custom":
        if custom_range is None:
            raise ValueError("custom frame range mode needs a range")
        return int(custom_range[0]), int(custom_range[1])
    return int(scene_range[0]), int(scene_range[1])


def bake_curve(curve: animcurve.AnimCurve, frame_range):
    """Dense per-frame samples of a sparse-keyed curve
    (ref: bakeResults' dense output)."""
    return curve.to_dense(frame_range)


def smart_bake_keys(frames, values, tolerance=1e-3):
    """Reduce dense samples to the keys needed for linear
    reconstruction within `tolerance`.

    (ref: bakeResults smart=True keeps keys 'where the curve changes';
    implemented as greedy longest-span linear fit, the same contract:
    re-sampling the reduced keys reproduces the input within
    tolerance.)  Returns (key_frames, key_values) arrays.
    """
    frames = np.asarray(frames, np.float64)
    values = np.asarray(values, np.float64)
    n = len(frames)
    if n <= 2:
        return frames.copy(), values.copy()
    key_idx = [0]
    start = 0
    while start < n - 1:
        # Longest end such that linear interp start->end fits all
        # interior samples within tolerance.
        best = start + 1
        for end in range(start + 2, n):
            t = (frames[start + 1:end] - frames[start]) / (
                frames[end] - frames[start]
            )
            interp = values[start] + t * (values[end] - values[start])
            if np.max(np.abs(interp - values[start + 1:end])) > tolerance:
                break
            best = end
        else:
            best = n - 1
        key_idx.append(best)
        start = best
    idx = np.asarray(key_idx)
    return frames[idx], values[idx]


def smooth_keyframes(values, mode="gaussian", width=2.0, blend=None):
    """Smooth a dense channel (ref: tools/smoothkeyframes/lib.py —
    applies utils.smooth.smooth with a per-key blend weight).

    blend: optional (N,) 0..1 per-sample mix between original and
    smoothed (the tool's soft-selection weighting)."""
    values = np.asarray(values, np.float64)
    smoothed = np.asarray(smooth.smooth(mode, values, width))
    if blend is None:
        return smoothed
    blend = np.clip(np.asarray(blend, np.float64), 0.0, 1.0)
    return values * (1.0 - blend) + smoothed * blend
