"""World-preserving reparenting and controller baking.

Capabilities of the reference's reparent2 and createcontroller2 tools
(ref: python/mmSolver/tools/reparent2/lib.py:155 reparent — bake world
matrices, re-parent, re-set local TRS so world motion is unchanged;
tools/createcontroller2 — bake a node's world motion onto a new
'controller' transform, then bake back).  There the baking runs Maya's
DG per frame; here it is a batched matrix decompose over all frames at
once (core/transform.py decompose_matrix).

Port of mayamatchmovesolver_tpu/tools/reparent.py: the inverse and the
decomposition run on the matrices' device, the Euler filter on the host
in float64 after one transfer.  reparent() bakes the SceneGraph on
`device` (default "cuda"; there is no fallback to the CPU).
"""

import numpy as np
import torch

from mayamatchmovesolver_torch.core import transform as tfm_math
from mayamatchmovesolver_torch.core.constants import RotateOrder
from mayamatchmovesolver_torch.scene import attrblock, flatscene
from mayamatchmovesolver_torch.tools._tensors import frame_tensor, host
from mayamatchmovesolver_torch.utils import animcurve

_CHANNELS = ("tx", "ty", "tz", "rx", "ry", "rz", "sx", "sy", "sz")


def _local_trs_batch(child_world, parent_world, rotate_orders):
    """local_trs_under_parent for N nodes at once.

    child_world: (N, F, 4, 4); parent_world: the same shape or None;
    rotate_orders: (N,) ints.  Decomposes on the matrices' device, reads
    (N, F, 9) to the host once and Euler-filters there.  Returns a dict
    of (N, F) numpy arrays keyed tx..sz.
    """
    if parent_world is None:
        local = child_world
    else:
        local = torch.matmul(tfm_math.affine_inverse(parent_world),
                             child_world)
    orders = torch.as_tensor(np.asarray(rotate_orders, np.int64),
                             device=local.device)
    t, r_deg, s = tfm_math.decompose_matrix(local, orders[:, None])
    (trs,) = host(torch.cat([t, r_deg, s], dim=-1))  # (N, F, 9)
    # euler_filter_array unwraps along the last axis: run it per
    # channel over the frame axis.
    trs[..., 3:6] = animcurve.euler_filter_array(
        np.swapaxes(trs[..., 3:6], -1, -2)
    ).swapaxes(-1, -2)
    return {name: trs[..., i] for i, name in enumerate(_CHANNELS)}


def local_trs_under_parent(child_world, parent_world=None,
                           rotate_order=RotateOrder.XYZ):
    """Local TRS values that reproduce child_world under parent_world.

    child_world: (F, 4, 4) world matrices to preserve.
    parent_world: (F, 4, 4) new parent world matrices (None = world).
    Returns dict of per-frame arrays tx..tz, rx..rz (degrees, euler
    filtered for continuity), sx..sz.
    """
    if not torch.is_tensor(child_world):
        child_world = torch.as_tensor(np.asarray(child_world, np.float64))
    if parent_world is not None:
        parent_world = parent_world[None].to(child_world)
    trs = _local_trs_batch(child_world[None], parent_world,
                           [int(rotate_order)])
    return {name: values[0] for name, values in trs.items()}


def reparent(sg, node, new_parent, frame_indices=None, *, device="cuda"):
    """Re-parent `node` under `new_parent` preserving world motion.

    (ref: reparent2/lib.py:155.)  Writes the new local TRS into the
    SceneGraph's attr builder and flips the parent pointer.  Attributes
    that were static but need animation after the reparent are
    promoted by writing per-frame values (static stays static when the
    new locals are constant).
    """
    p = new_parent
    while p is not None:
        if p is node:
            raise ValueError("cannot parent %s under its own "
                             "descendant" % node.name)
        p = p.parent
    scene, attrs = sg.bake(device=device)
    if frame_indices is None:
        frame_indices = np.arange(sg.num_frames)
    frame_indices = np.asarray(frame_indices)
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    child_world = ev.tfm_world[node.index]
    parent_world = (
        None if new_parent is None else ev.tfm_world[new_parent.index]
    )
    trs = local_trs_under_parent(
        child_world, parent_world, rotate_order=node.rotate_order
    )
    for name, values in trs.items():
        code = node.attr(name).code
        if attrblock.is_static_code(code):
            if np.ptp(values) > 1e-12:
                raise ValueError(
                    "reparent would animate static attr %s.%s; create "
                    "the node with animated %s first"
                    % (node.name, name, name)
                )
            sg._attr_builder.set_value(code, float(values[0]))
        else:
            for fi, v in zip(frame_indices, values):
                sg._attr_builder.set_value(code, float(v), frame=fi)
    node.parent = new_parent
    return trs


def bake_world_trs(scene, attrs, frame_indices, tfm_index,
                   rotate_order=RotateOrder.XYZ):
    """A transform's world motion as TRS curves (the 'controller' of
    createcontroller2: a world-space duplicate of the node's motion)."""
    ev = flatscene.evaluate(scene, attrs,
                            frame_tensor(frame_indices, scene))
    return local_trs_under_parent(
        ev.tfm_world[tfm_index], None, rotate_order=rotate_order
    )
