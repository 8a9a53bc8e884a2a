"""Bundle triangulation from marker observations.

Port of mayamatchmovesolver_tpu/solver/triangulate.py, the counterpart
of the reference's triangulate-bundle tool and API
(ref: python/mmSolver/_api/triangulatebundle.py,
python/mmSolver/tools/triangulatebundle, and the per-bundle
_triangulate_bundles step of camera_solve,
solvercamerautils.py:690): place 3D bundles by DLT triangulation from
their 2D marker tracks through the evaluated cameras.  Everything runs
on the attributes' device; the write-back reads the solution to the host
once to pick the attribute cells.
"""

import dataclasses

import numpy as np
import torch

from mayamatchmovesolver_torch.scene import flatscene
from mayamatchmovesolver_torch.solver import linalg


def triangulate_markers(scene, attrs, frame_indices):
    """DLT-triangulate every marker's bundle position from all frames.

    Uses the evaluated view-projection matrices: for observation
    (m, f) with marker coords (u, v) in NDC*0.5 space, rows
    u*P3 - 0.5*P1 and v*P3 - 0.5*P2 constrain the homogeneous point.
    Returns ((M, 3) positions, (M,) condition ok mask).
    """
    device = attrs.static_values.device
    frame_indices = torch.as_tensor(
        np.asarray(frame_indices, dtype=np.int64), device=device
    )
    ev = flatscene.evaluate(scene, attrs, frame_indices)

    view_proj = ev.cam_proj @ ev.cam_world_inv  # (C, F, 4, 4)
    vp = view_proj[scene.mkr_cam_index]  # (M, F, 4, 4)
    uv = ev.marker_xy  # (M, F, 2) — markers live in NDC*0.5 space
    mask = (ev.marker_enable > 0.5) & (ev.marker_weight > 0.0)

    p1 = vp[..., 0, :]
    p2 = vp[..., 1, :]
    p3 = vp[..., 3, :]  # w row
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    row_u = u * p3 - 0.5 * p1  # (M, F, 4)
    row_v = v * p3 - 0.5 * p2
    w = mask[..., None].to(row_u.dtype)
    rows = torch.cat([row_u * w, row_v * w], dim=1)  # (M, 2F, 4)
    ata = rows.transpose(-1, -2) @ rows
    x = linalg.smallest_eigenvector(ata)  # (M, 4)
    denom = torch.where(x[..., 3:].abs() < 1e-12, 1e-12, x[..., 3:])
    points = x[..., :3] / denom
    ok = mask.sum(dim=1) >= 2
    return points, ok


def _write_cells(attrs, cells):
    """A new AttrBlock with `cells` written: {code: value}, an animated
    code across all its frames."""
    like = attrs.static_values
    static, anim = attrs.static_values, attrs.anim_values
    for parity in (0, 1):
        picked = [(c // 2, v) for c, v in cells.items() if c % 2 == parity]
        if not picked:
            continue
        index = torch.as_tensor([i for i, _ in picked], device=like.device)
        values = torch.as_tensor([v for _, v in picked], dtype=like.dtype,
                                 device=like.device)
        if parity == 0:
            static = static.index_copy(0, index, values)
        else:
            anim = anim.index_copy(
                0, index, values[:, None].expand(-1, anim.shape[1])
            )
    return dataclasses.replace(attrs, static_values=static,
                               anim_values=anim)


def triangulate_into_attrs(scene, attrs, frame_indices,
                           marker_mask=None):
    """Triangulate and scatter positions into the attr block using only
    baked scene tensors (no scene-graph handle needed): each marker's
    bundle transform's tx/ty/tz attr cells receive the DLT solution.
    Animated position channels are written across ALL frames (a
    triangulated bundle is a static point).  Returns (attrs, ok) with ok
    a numpy mask."""
    points, ok = triangulate_markers(scene, attrs, frame_indices)
    codes = scene.tfm_attr_codes[
        scene.bnd_tfm_index[scene.mkr_bnd_index], 0:3
    ]  # (M, 3): tx ty tz
    # The one host read: positions, mask and cell codes together (a code
    # is a small integer, exact in any float dtype).
    host = torch.cat(
        [points.double(), ok[:, None].double(), codes.double()], dim=-1
    ).cpu().numpy()
    points, ok = host[:, :3], host[:, 3] > 0.5
    codes = host[:, 4:].astype(np.int64)
    if marker_mask is not None:
        ok = ok & np.asarray(marker_mask, bool)
    cells = {}
    for mi in np.nonzero(ok)[0]:
        for ci, code in enumerate(codes[mi]):
            if code >= 0:
                cells[int(code)] = float(points[mi, ci])
    return _write_cells(attrs, cells), ok


def triangulate_and_update(scene_graph, scene, attrs, frame_indices):
    """Triangulate and write positions into the attr block for every
    bundle that is a root-level transform (static tx/ty/tz attrs)."""
    points, ok = triangulate_markers(scene, attrs, frame_indices)
    host = torch.cat([points.double(), ok[:, None].double()],
                     dim=-1).cpu().numpy()
    points, ok = host[:, :3], host[:, 3] > 0.5
    cells = {}
    for mkr in scene_graph._markers:
        b = mkr.bundle
        if b.parent is not None or not ok[mkr.mkr_index]:
            continue
        for ci, ch in enumerate(("tx", "ty", "tz")):
            code = b.attr(ch).code
            if code % 2 == 0:
                cells[int(code)] = float(points[mkr.mkr_index, ci])
    return _write_cells(attrs, cells), ok
