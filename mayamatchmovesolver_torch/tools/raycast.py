"""Ray-cast markers onto mesh geometry.

Capability of the reference's raycastmarker tool
(ref: python/mmSolver/tools/raycastmarker/lib.py — casts each
selected marker's camera ray at a mesh via utils/raytrace
closest_intersect and moves the marker's bundle to the hit point;
supports casting over a frame range and 'unlink if no hit').

The ray math: a marker at screen (x, y) defines the ray from the
camera position through the unprojected point at unit depth
(tools/screenspace.screen_to_world); intersection is the batched
Moller-Trumbore test in utils/raytrace.

Port of mayamatchmovesolver_tpu/tools/raycast.py: the rays and the
intersection are computed on the scene's device, the rays of all the
markers of one camera at once; apply_raycast_bundles bakes on `device`
(default "cuda"; no fallback to the CPU) and reads the hits to the host
in one transfer.
"""

import numpy as np
import torch

from mayamatchmovesolver_torch.scene import attrblock, flatscene
from mayamatchmovesolver_torch.tools import screenspace
from mayamatchmovesolver_torch.tools._tensors import frame_tensor, host
from mayamatchmovesolver_torch.utils import raytrace


def marker_rays(scene, attrs, frame_indices, marker_indices=None):
    """Camera rays through markers: returns (origins (M, F, 3),
    directions (M, F, 3) unit vectors)."""
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    if marker_indices is None:
        marker_indices = np.arange(scene.num_markers)
    marker_indices = np.asarray(marker_indices, np.int64)
    cam_of = scene.mkr_cam_index.cpu().numpy()[marker_indices]
    device = ev.marker_xy.device
    num_frames = ev.marker_xy.shape[1]
    origins = ev.marker_xy.new_empty((len(marker_indices), num_frames, 3))
    directions = torch.empty_like(origins)
    for cam_index in np.unique(cam_of):
        rows = torch.as_tensor(np.nonzero(cam_of == cam_index)[0],
                               device=device)
        mkr = torch.as_tensor(marker_indices[cam_of == cam_index],
                              device=device)
        cam_pos = ev.cam_world[int(cam_index), :, :3, 3]  # (F, 3)
        xy = ev.marker_xy[mkr]
        at_depth = screenspace.screen_to_world(
            ev, xy, torch.ones_like(xy[..., 0]), cam_index=int(cam_index),
        )  # (K, F, 3) points at depth 1
        d = at_depth - cam_pos
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        origins[rows] = cam_pos.expand_as(d)
        directions[rows] = d
    return origins, directions


def raycast_markers_to_mesh(scene, attrs, frame_index, vertices,
                            triangles, marker_indices=None,
                            max_distance=None):
    """Hit points for each marker's ray at one frame
    (ref: raycastmarker/lib.py raycast_markers_onto_meshes).

    Returns (positions (M, 3), hit (M,) bool): bundle positions for
    markers whose ray hits the mesh; non-hits keep NaN positions (the
    reference skips/optionally unlinks those markers).
    """
    origins, directions = marker_rays(
        scene, attrs, np.asarray([frame_index]), marker_indices
    )
    o = origins[:, 0]
    d = directions[:, 0]
    hit_pos, _, hit_dist, hit = raytrace.intersect_rays_mesh(
        o, d, vertices, triangles,
        max_dist=np.inf if max_distance is None else max_distance,
    )
    return hit_pos, hit


def apply_raycast_bundles(sg, frame_index, vertices, triangles,
                          markers=None, max_distance=None, *,
                          device="cuda"):
    """Move bundles of markers that hit the mesh (host-side write-back
    like the reference tool's main action).  Returns the hit mask."""
    scene, attrs = sg.bake(device=device)
    markers = list(sg._markers) if markers is None else list(markers)
    marker_indices = np.array([m.mkr_index for m in markers])
    pos, hit = raycast_markers_to_mesh(
        scene, attrs, frame_index, vertices, triangles,
        marker_indices=marker_indices, max_distance=max_distance,
    )
    pos, hit = host(pos, hit)
    hit = hit.astype(bool)
    for k, m in enumerate(markers):
        if not hit[k]:
            continue
        if m.bundle.parent is not None:
            raise ValueError(
                "raycast writes world positions; bundle %r must be a "
                "root node" % m.bundle.name
            )
        for ci, ch in enumerate(("tx", "ty", "tz")):
            code = m.bundle.attr(ch).code
            if attrblock.is_static_code(code):
                sg._attr_builder.set_value(code, float(pos[k, ci]))
            else:
                sg._attr_builder.set_value(
                    code, float(pos[k, ci]), frame=frame_index
                )
    return hit
