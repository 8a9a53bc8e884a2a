"""Marker/bundle utility operations.

Capabilities of the reference's small marker tools:
  - averagemarker (ref: python/mmSolver/tools/averagemarker/lib.py:29)
  - duplicatemarker (ref: tools/duplicatemarker)
  - markerbundlerename (ref: tools/markerbundlerename/lib.py:64
    rename_markers_and_bundles)
  - convertmarker: transform -> marker by reprojection
    (ref: tools/convertmarker/lib.py convert_nodes_to_marker_data_list)
  - reprojectbundle: push a bundle onto its marker's camera ray
    (ref: tools/reprojectbundle/lib.py reproject_bundle_current_frame)

Port of mayamatchmovesolver_tpu/tools/markertools.py: functions of a
baked scene compute on its device; create_average_marker and
duplicate_marker bake on `device` (default "cuda"; no fallback to the
CPU) and read every channel they need in one transfer; the name, link
and lock tools are the reference's host code.
"""

import numpy as np
import torch

from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.scene import attrblock, flatscene
from mayamatchmovesolver_torch.tools import screenspace
from mayamatchmovesolver_torch.tools._tensors import frame_tensor, host


def average_marker(marker_xy, enable=None):
    """Average several marker tracks into one
    (ref: tools/averagemarker/lib.py:29 — per-frame mean).
    marker_xy: (K, F, 2); enable: optional (K, F) mask.
    Returns ((F, 2) positions, (F,) any-enabled mask)."""
    if not torch.is_tensor(marker_xy):
        marker_xy = torch.as_tensor(np.asarray(marker_xy))
    if enable is None:
        return (
            torch.mean(marker_xy, dim=0),
            torch.ones(marker_xy.shape[1], dtype=torch.bool,
                       device=marker_xy.device),
        )
    if not torch.is_tensor(enable):
        enable = torch.as_tensor(np.asarray(enable))
    w = enable.to(marker_xy)[..., None]
    count = torch.clamp(torch.sum(w, dim=0), min=1e-9)
    avg = torch.sum(marker_xy * w, dim=0) / count
    return avg, torch.sum(w[..., 0], dim=0) > 0.5


def create_average_marker(sg, markers, name="avg_marker", bundle=None, *,
                          device="cuda"):
    """Create a marker averaging existing markers' screen tracks
    (ref: averagemarker/tool.py main — new marker + bundle at the
    average position)."""
    scene, attrs = sg.bake(device=device)
    frames = frame_tensor(np.arange(sg.num_frames), scene)
    codes = [[m.attr(ch).code for ch in ("tx", "ty", "enable")]
             for m in markers]
    vals = attrblock.gather_attr_values(attrs, codes, frames)  # (K, 3, F)
    avg, any_on = average_marker(vals[:, :2].transpose(1, 2), vals[:, 2])
    avg, any_on = host(avg, any_on)
    cam = markers[0].camera
    if bundle is None:
        bundle = sg.create_bundle(name + "_bnd")
    return sg.create_marker(
        name, camera=cam, bundle=bundle,
        tx=avg[:, 0], ty=avg[:, 1],
        enable=np.asarray(any_on, np.float64),
    )


def duplicate_marker(sg, marker, name=None, *, device="cuda"):
    """Copy a marker's track onto a new marker sharing the camera and
    bundle (ref: tools/duplicatemarker/lib.py)."""
    scene, attrs = sg.bake(device=device)
    frames = frame_tensor(np.arange(sg.num_frames), scene)
    channels = ("tx", "ty", "weight", "enable")
    codes = [marker.attr(ch).code for ch in channels]
    (vals,) = host(attrblock.gather_attr_values(
        attrs, codes, frames))
    values = {}
    for ch, code, v in zip(channels, codes, vals):
        values[ch] = float(v[0]) if attrblock.is_static_code(code) else v
    return sg.create_marker(
        name or (marker.name + "_copy"), camera=marker.camera,
        bundle=marker.bundle, group=marker.group, **values
    )


def rename_markers_and_bundles(markers, base_name, marker_suffix="_MKR",
                               bundle_suffix="_BND", start=1):
    """Consistent numbered rename of marker/bundle pairs
    (ref: markerbundlerename/lib.py:64 — '<name>_NN_MKR' plus the
    matching bundle).  Returns the new (marker, bundle) name pairs."""
    pairs = []
    number = int(start)
    for m in markers:
        mkr_name = "%s_%02d%s" % (base_name, number, marker_suffix)
        bnd_name = "%s_%02d%s" % (base_name, number, bundle_suffix)
        graph = m.graph
        for node, new_name in ((m, mkr_name), (m.bundle, bnd_name)):
            if node is None or node.name == new_name:
                continue
            if new_name in graph._names:
                raise ValueError("name already used: %r" % new_name)
            graph._names.discard(node.name)
            graph._names.add(new_name)
            node.name = new_name
        pairs.append((mkr_name, bnd_name))
        number += 1
    return pairs


def marker_from_transform(scene, attrs, frame_indices, tfm_index,
                          cam_index=0):
    """A transform's screen track — the data of convertmarker
    (ref: tools/convertmarker/lib.py — reprojects a transform into
    marker positions per frame).  Returns (marker_xy (F, 2),
    behind_camera (F,) bool)."""
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    points = ev.tfm_world[tfm_index, :, :3, 3]
    xy, depth = screenspace.world_to_screen(ev, points,
                                            cam_index=cam_index)
    return xy, depth <= 0.0


def reproject_bundle(scene, attrs, frame_indices, marker_index,
                     frame_for_depth=0):
    """Move a bundle onto the camera ray through its marker, keeping
    its current depth (ref: tools/reprojectbundle/lib.py — snap the
    bundle to the marker's ray at the current frame).  Returns the new
    (3,) world position."""
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    cam_index = int(scene.mkr_cam_index[marker_index])
    bnd_index = int(scene.mkr_bnd_index[marker_index])
    bnd_world = ev.bnd_world_point[bnd_index]  # (F, 3)
    _, depth = screenspace.world_to_screen(ev, bnd_world,
                                           cam_index=cam_index)
    new_world = screenspace.screen_to_world(
        ev, ev.marker_xy[marker_index], depth, cam_index=cam_index
    )
    (out,) = host(new_world[frame_for_depth])
    return out


def link_marker_bundle(marker, bundle):
    """Re-link a marker to a different bundle before bake (ref: the
    link-marker-bundle tool, python/mmSolver/tools/linkmarkerbundle/
    lib.py:29 — connects marker.bundle message plugs)."""
    if bundle.bnd_index is None:
        raise ValueError("link target must be a BundleNode")
    marker.bundle = bundle
    return marker


def unlink_marker_bundle(marker, scene_graph, name=None):
    """Detach a marker onto its own fresh bundle (the unlink half of
    the reference tool): creates a new bundle at the old bundle's
    position and links the marker to it."""
    old = marker.bundle
    pos = {
        ch: float(scene_graph.get_value(old.attr(ch)))
        for ch in ("tx", "ty", "tz")
    }
    bnd = scene_graph.create_bundle(
        name or ("%s_bnd" % marker.name), **pos
    )
    marker.bundle = bnd
    return bnd


def _toggle_lock(attrs):
    """Lock all when any is unlocked, else unlock all (the reference's
    toggle semantics; ref: tools/togglebundlelock/lib.py,
    togglemarkerlock/lib.py)."""
    any_unlocked = any(not a.locked for a in attrs)
    for a in attrs:
        a.locked = any_unlocked
    return any_unlocked


def toggle_bundle_lock(bundles):
    """Toggle the translate locks of bundles (ref:
    python/mmSolver/tools/togglebundlelock/lib.py).  Returns the new
    locked state."""
    attrs = [b.attr(ch) for b in bundles for ch in ("tx", "ty", "tz")]
    return _toggle_lock(attrs)


def toggle_marker_lock(markers):
    """Toggle marker tx/ty locks (ref:
    python/mmSolver/tools/togglemarkerlock/lib.py)."""
    attrs = [m.attr(ch) for m in markers for ch in ("tx", "ty")]
    return _toggle_lock(attrs)


def aim_at_target(scene_graph, transforms, target_position,
                  up=(0.0, 1.0, 0.0)):
    """Rotate transforms so their -Z axis (the camera viewing axis)
    points at the target, keeping `up` as close to +Y as possible —
    the aim-constraint capability of the camera-aim tool (ref:
    python/mmSolver/tools/cameraaim/lib.py:29 aim_at_target; the
    reference uses a temporary Maya aimConstraint).  Writes rx/ry/rz
    (XYZ order, degrees) on each transform; returns the euler
    angles.  Works on the scene graph's host values; the Euler
    extraction runs on the CPU."""
    target = np.asarray(target_position, float)
    up = np.asarray(up, float)
    out = []
    for tfm in transforms:
        pos = np.array([
            float(scene_graph.get_value(tfm.attr(ch)))
            for ch in ("tx", "ty", "tz")
        ])
        fwd = target - pos  # camera looks down -Z: z axis = -fwd
        n = np.linalg.norm(fwd)
        if n < 1e-12:
            out.append((0.0, 0.0, 0.0))
            continue
        z = -fwd / n
        x = np.cross(up, z)
        xn = np.linalg.norm(x)
        if xn < 1e-9:  # looking straight up/down: pick arbitrary x
            x = np.array([1.0, 0.0, 0.0])
        else:
            x = x / xn
        y = np.cross(z, x)
        r = np.stack([x, y, z], axis=-1)  # columns = local axes
        # Decompose with the engine's own euler convention (XYZ order)
        # so trs_matrix reproduces this frame exactly.
        eul = tfm_math.matrix_to_euler(
            torch.as_tensor(r)[None], torch.zeros(1, dtype=torch.long)
        )[0].numpy()
        angles = tuple(float(v) for v in eul)  # already degrees
        for ch, v in zip(("rx", "ry", "rz"), angles):
            scene_graph.set_value(tfm.attr(ch), float(v))
        out.append(angles)
    return out
