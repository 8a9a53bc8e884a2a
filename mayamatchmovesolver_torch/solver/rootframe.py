"""Automatic root-frame selection from marker coverage.

Copy of mayamatchmovesolver_tpu/solver/rootframe.py (numpy only), the
port of the reference's rootframe logic
(ref: python/mmSolver/_api/rootframe.py:151 get_root_frames_from_markers,
:294 root_frames_subdivide, :333 root_frames_list_combine): root frames
anchor the coarse pass of the Standard solver strategy before animated
attributes are solved across every frame.
"""

import numpy as np


def get_root_frames_from_markers(marker_enable, frames,
                                 min_frames_per_marker=2):
    """Pick root frames so every marker is observed on at least
    `min_frames_per_marker` root frames.

    marker_enable: (M, F) bool/float array of per-frame marker enables.
    frames: length-F list of frame numbers.
    """
    enable = np.asarray(marker_enable) > 0.5
    frames = np.asarray(frames)
    num_markers, num_frames = enable.shape
    root = set()
    for m in range(num_markers):
        on = np.nonzero(enable[m])[0]
        if on.size == 0:
            continue
        # First and last observed frames are always roots
        # (the reference anchors marker start/end the same way).
        picks = [on[0], on[-1]]
        if min_frames_per_marker > 2 and on.size > 2:
            extra = np.linspace(
                0, on.size - 1, min_frames_per_marker
            ).astype(int)
            picks.extend(on[extra])
        root.update(int(frames[i]) for i in picks)
    return sorted(root)


def root_frames_subdivide(root_frames, max_frame_span):
    """Insert midpoints until no gap exceeds max_frame_span
    (ref: rootframe.py:294)."""
    out = sorted(set(int(f) for f in root_frames))
    changed = True
    while changed:
        changed = False
        result = []
        for a, b in zip(out, out[1:]):
            result.append(a)
            if b - a > max_frame_span:
                result.append((a + b) // 2)
                changed = True
        if out:
            result.append(out[-1])
        out = sorted(set(result))
    return out


def root_frames_list_combine(*lists):
    """(ref: rootframe.py:333)."""
    out = set()
    for lst in lists:
        out.update(int(f) for f in lst)
    return sorted(out)
