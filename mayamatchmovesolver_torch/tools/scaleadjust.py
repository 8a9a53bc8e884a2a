"""Scene-scale adjustment about a camera pivot.

Capability of the reference's cameraobjectscaleadjust /
cameraobjectscaleremove tools (ref: python/mmSolver/tools/
cameraobjectscaleadjust/lib.py:114 create_scale_rig — groups the
camera + tracked objects under a scale rig pivoted at the camera so
scaling the rig rescales the scene without changing the image;
lib.py:271 remove_scale_rig bakes the result back).

A matchmove solve is only defined up to global scale; this adjusts it:
scaling every camera position AND every bundle about a common pivot by
the same factor leaves all reprojections exactly unchanged (similarity
invariance), which is the property the reference's rig construction
guarantees and tests here assert.

Port of mayamatchmovesolver_tpu/tools/scaleadjust.py: the pivot and
scale arithmetic is the reference's host code; apply_scene_scale bakes
on `device` (default "cuda"; no fallback to the CPU) and reads every
node's positions in one transfer, where the reference reads a node at
a time.
"""

import numpy as np

from mayamatchmovesolver_torch.scene import attrblock
from mayamatchmovesolver_torch.tools._tensors import frame_tensor, host


def scale_about_pivot(points, pivot, scale):
    """Scale (..., 3) world points about a (3,) pivot."""
    points = np.asarray(points, dtype=np.float64)
    pivot = np.asarray(pivot, dtype=np.float64)
    return pivot + (points - pivot) * float(scale)


def scale_for_known_distance(point_a, point_b, known_distance):
    """The scale factor making |a - b| equal a measured real-world
    distance — how artists pick the rig scale (ref: the tool's
    'scene scale' workflow, tools/cameraobjectscaleadjust docs)."""
    d = float(np.linalg.norm(
        np.asarray(point_a, np.float64) - np.asarray(point_b, np.float64)
    ))
    if d <= 0.0:
        raise ValueError("reference points are coincident")
    return float(known_distance) / d


def scale_for_known_depth(camera_position, point, known_depth):
    """Scale making a bundle sit at a known distance from the camera."""
    d = float(np.linalg.norm(
        np.asarray(point, np.float64)
        - np.asarray(camera_position, np.float64)
    ))
    if d <= 0.0:
        raise ValueError("bundle is at the camera position")
    return float(known_depth) / d


def apply_scene_scale(sg, scale, pivot=None, frame_indices=None,
                      cameras=None, bundles=None, *, device="cuda"):
    """Rescale camera translations + bundle positions about a pivot.

    (ref: create_scale_rig + remove_scale_rig baked into one step —
    the rig's net effect on the scene data.)  pivot defaults to the
    first camera's first-frame position (the reference parents the rig
    at the camera).  Operates on the SceneGraph builder in place.
    Returns the pivot used.
    """
    scene, attrs = sg.bake(device=device)
    cameras = list(sg._cameras) if cameras is None else list(cameras)
    bundles = list(sg._bundles) if bundles is None else list(bundles)
    if frame_indices is None:
        frame_indices = np.arange(sg.num_frames)
    frame_indices = np.asarray(frame_indices)

    nodes = cameras + bundles
    positions = np.zeros((0, len(frame_indices), 3))
    if nodes:
        codes = [[n.attr(c).code for c in ("tx", "ty", "tz")]
                 for n in nodes]
        (values,) = host(attrblock.gather_attr_values(
            attrs, codes,
            frame_tensor(frame_indices, scene)))
        positions = values.transpose(0, 2, 1)  # (N, F, 3)

    if pivot is None:
        if not cameras:
            raise ValueError("no cameras to derive a pivot from")
        pivot = positions[0][0]
    pivot = np.asarray(pivot, np.float64)

    for node, pos in zip(nodes, positions):
        new_pos = scale_about_pivot(pos, pivot, scale)
        for ci, ch in enumerate(("tx", "ty", "tz")):
            code = node.attr(ch).code
            if attrblock.is_static_code(code):
                sg._attr_builder.set_value(code, float(new_pos[0, ci]))
            else:
                for fi, v in zip(frame_indices, new_pos[:, ci]):
                    sg._attr_builder.set_value(code, float(v), frame=fi)
    return pivot
