"""Set-camera-origin-frame: rigid re-basing of a solved shot.

Capability of the reference's setcameraoriginframe tool
(ref: python/mmSolver/tools/setcameraoriginframe/lib.py:122
set_camera_origin_frame — parents the camera + bundles under an
'origin' group whose inverse transform places the chosen frame's
camera at the world origin, optionally applying scene scale; the same
normalization the camera solver runs at solvercamerautils.py:730).

Operates on the scene graph's TRS data directly: every camera position/
orientation and every bundle position is transformed by the inverse of
the origin frame's camera pose, then scaled.

Port of mayamatchmovesolver_tpu/tools/originframe.py: the scene is
baked on `device` (default "cuda"; no fallback to the CPU), the camera
and every bundle are re-based and decomposed there in one batch, and
the TRS values come to the host in one transfer, where the reference
reads each node's world matrices in turn.
"""

import numpy as np
import torch

from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.scene import attrblock, flatscene
from mayamatchmovesolver_torch.tools import reparent as reparent_mod
from mayamatchmovesolver_torch.tools._tensors import frame_tensor, host


def set_camera_origin_frame(sg, camera, origin_frame_index=0,
                            scene_scale=1.0, bundles=None, *,
                            device="cuda"):
    """Re-base the shot so `camera` at the origin frame is the world
    origin with identity orientation, scaling the scene by
    scene_scale.  Writes new TRS values into the SceneGraph builder
    for the camera and every bundle.  Reprojection is invariant under
    this similarity transform (tested).
    """
    scene, attrs = sg.bake(device=device)
    frames = np.arange(sg.num_frames)
    ev = flatscene.evaluate(scene, attrs, frame_tensor(frames, scene))
    origin = ev.tfm_world[camera.index, int(origin_frame_index)].clone()
    # Remove scale from the origin pose (rigid re-base only).
    norms = torch.linalg.vector_norm(origin[:3, :3], dim=0)
    origin[:3, :3] = origin[:3, :3] / norms
    origin_inv = tfm_math.affine_inverse(origin)

    bundles = list(sg._bundles) if bundles is None else list(bundles)
    nodes = [camera] + bundles
    index = torch.as_tensor([n.index for n in nodes],
                            device=origin.device)
    rebased = torch.matmul(origin_inv, ev.tfm_world[index])
    rebased[..., :3, 3] *= float(scene_scale)
    trs = reparent_mod._local_trs_batch(
        rebased, None, [n.rotate_order for n in nodes]
    )
    for k, node in enumerate(nodes):
        _write_trs(sg, node, frames,
                   {name: values[k] for name, values in trs.items()})
    (origin_inv,) = host(origin_inv)
    return origin_inv


def _write_trs(sg, node, frames, trs):
    if node.parent is not None:
        raise ValueError(
            "set_camera_origin_frame writes local TRS; %r must be a "
            "root node (reparent it first)" % node.name
        )
    for name, values in trs.items():
        code = node.attr(name).code
        if attrblock.is_static_code(code):
            sg._attr_builder.set_value(code, float(np.mean(values)))
        else:
            for fi, v in zip(frames, values):
                sg._attr_builder.set_value(code, float(v), frame=fi)
