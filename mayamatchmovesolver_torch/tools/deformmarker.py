"""Deform-marker data capability: push marker 2D tracks through a lens.

The reference tool offsets marker animation curves by the camera's lens
distortion over a frame range, with apply / remove(revert)
(ref: python/mmSolver/tools/deformmarker/lib.py — it records the
original values on an anim layer so the deform is reversible, and
python/mmSolver/tools/togglecameradistort capability).  Here the
operation is a pure AttrBlock transform: evaluate the markers'
screen positions, map them through the camera's lens stack (distort or
undistort), and write them back — applying then removing is an
identity up to the lens model's fixed-point inverse tolerance.

Port of mayamatchmovesolver_tpu/tools/deformmarker.py: the evaluation
and the lens run on the scene's device; the new AttrBlock is on the
same device.
"""

from mayamatchmovesolver_torch.models import scenelens
from mayamatchmovesolver_torch.scene import flatscene
from mayamatchmovesolver_torch.tools._tensors import frame_tensor


def deform_markers(scene, attrs, scene_lens, frame_indices,
                   direction="distort"):
    """Return a new AttrBlock with every marker's tx/ty mapped through
    its camera's lens-layer stack.

    direction: 'distort' (apply) or 'undistort' (remove) — the
    reference's ApplyDistortion / RemoveDistortion modes."""
    if direction not in ("distort", "undistort"):
        raise ValueError("direction must be distort|undistort")
    frame_indices = frame_tensor(frame_indices, scene)
    ev = flatscene.evaluate(scene, attrs, frame_indices)
    mapped = scenelens.apply_scene_lens(
        scene_lens, scene, attrs, frame_indices, ev.marker_xy,
        scene.mkr_cam_index, direction=direction,
    )
    return flatscene.set_marker_screen_positions(
        scene, attrs, frame_indices, mapped
    )


def remove_marker_deform(scene, attrs, scene_lens, frame_indices):
    """Inverse of deform_markers(direction='distort')."""
    return deform_markers(scene, attrs, scene_lens, frame_indices,
                          direction="undistort")
