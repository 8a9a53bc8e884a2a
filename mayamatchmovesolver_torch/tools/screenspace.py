"""World <-> screen-space conversion over frames.

Capabilities of the reference's screen-space tools
(ref: python/mmSolver/tools/screenspacetransform/lib.py:32
create_screen_space_locator, tools/screenspacerigbake — bake a
transform into (screenX, screenY, depth) channels driven under the
camera, tools/screenspacemotiontrail — per-frame screen positions as a
trail).  There the conversion is a Maya node rig evaluated by the DG;
here it is two closed-form batched functions over the flat scene's
camera matrices.

Screen space is the solver's marker space: x, y in [-0.5, 0.5] (NDC
halved, ref: math/reprojection.rs:55-63); depth is the positive
distance along the camera's viewing direction (-Z), so
(screen_xy, depth) is a complete, invertible camera-relative
parameterization of a world point.

Port of mayamatchmovesolver_tpu/tools/screenspace.py on tensors: every
function computes on the device of the scene it is given.
"""

import numpy as np
import torch

from mayamatchmovesolver_torch.scene import flatscene
from mayamatchmovesolver_torch.tools._tensors import frame_tensor


def _like(x, ref):
    """x as a tensor of ref's dtype on ref's device."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=ref.device, dtype=ref.dtype)


def world_to_screen(ev: flatscene.SceneEval, points_world, cam_index=0):
    """World points -> (screen_xy, depth) per frame.

    ev: SceneEval from scene.evaluate() (carries cam_proj /
    cam_world_inv shaped (C, F, 4, 4)).
    points_world: (..., F, 3) world positions per frame (broadcasts:
    a static (3,) point works too).
    Returns (screen_xy (..., F, 2), depth (..., F)).
    """
    proj = ev.cam_proj[cam_index]  # (F, 4, 4)
    winv = ev.cam_world_inv[cam_index]
    points_world = _like(points_world, proj)
    if points_world.ndim == 1:
        points_world = torch.broadcast_to(
            points_world, proj.shape[:1] + (3,)
        )
    p = torch.cat(
        [points_world, torch.ones_like(points_world[..., :1])], dim=-1
    )
    cam_space = torch.einsum("fij,...fj->...fi", winv, p)
    clip = torch.einsum("fij,...fj->...fi", proj, cam_space)
    # Whatever its sign, a clip w under 1e-12 in magnitude becomes
    # +1e-12, as in the reference.
    w = clip[..., 3:]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    screen_xy = clip[..., :2] / w * 0.5
    depth = -cam_space[..., 2]
    return screen_xy, depth


def screen_to_world(ev: flatscene.SceneEval, screen_xy, depth,
                    cam_index=0):
    """Inverse of world_to_screen: (screen_xy, depth) -> world points.

    Uses the projection matrix's sparse structure
    (core/camera.py projection_matrix: rows
    [m00 0 m02 0; 0 m11 m12 0; 0 0 m22 m23; 0 0 -1 0]) to unproject
    analytically, as the reference does:
      w_clip = depth,  x_ndc = 2 * sx
      x_cam = (x_ndc * depth - m02 * z_cam) / m00,   z_cam = -depth.
    """
    proj = ev.cam_proj[cam_index]  # (F, 4, 4)
    cam_world = ev.cam_world[cam_index]
    screen_xy = _like(screen_xy, proj)
    depth = _like(depth, proj)
    m00 = proj[..., 0, 0]
    m02 = proj[..., 0, 2]
    m11 = proj[..., 1, 1]
    m12 = proj[..., 1, 2]
    z_cam = -depth
    x_cam = (2.0 * screen_xy[..., 0] * depth - m02 * z_cam) / m00
    y_cam = (2.0 * screen_xy[..., 1] * depth - m12 * z_cam) / m11
    cam_space = torch.stack(
        [x_cam, y_cam, z_cam, torch.ones_like(z_cam)], dim=-1
    )
    world = torch.einsum("fij,...fj->...fi", cam_world, cam_space)
    return world[..., :3]


def motion_trail(scene, attrs, frame_indices, tfm_index, cam_index=0):
    """Screen-space motion trail of a transform over frames.

    (ref: tools/screenspacemotiontrail — a locator trail of a node's
    screen positions.)  tfm_index: index into the baked transform list.
    Returns (screen_xy (F, 2), depth (F,)).
    """
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    points = ev.tfm_world[tfm_index, :, :3, 3]  # (F, 3)
    return world_to_screen(ev, points, cam_index=cam_index)


def screen_space_rig_bake(scene, attrs, frame_indices, tfm_index,
                          cam_index=0):
    """Bake a transform's world positions into screen-space channels.

    (ref: tools/screenspacerigbake/tool.py — bakes a rig of
    screenX/screenY/screenDepth channels under the camera.)
    Returns dict(screen_x (F,), screen_y (F,), depth (F,)).
    """
    screen_xy, depth = motion_trail(
        scene, attrs, frame_indices, tfm_index, cam_index
    )
    return {
        "screen_x": screen_xy[..., 0],
        "screen_y": screen_xy[..., 1],
        "depth": depth,
    }


def screen_space_rig_unbake(scene, attrs, frame_indices, screen_x,
                            screen_y, depth, cam_index=0):
    """Inverse bake: screen channels -> world positions per frame
    (ref: screenspacerigbake's 'remove rig' restores world motion)."""
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    ref = ev.cam_proj
    screen_xy = torch.stack(
        [_like(screen_x, ref), _like(screen_y, ref)], dim=-1
    )
    return screen_to_world(ev, screen_xy, depth, cam_index=cam_index)
