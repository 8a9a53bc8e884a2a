"""Carry baked state from the JAX package into the port.

The reference package bakes a scene into a FlatScene, an AttrBlock and a
SceneLens.  These functions take those objects' fields as host numpy
arrays (one dict per object, plus the two static fields, doubling_steps
and model_types) and return the port's objects on a given device.  This
is how one scene reaches both packages: the counterpart of carrying
weights across.  Nothing here imports jax; the caller converts.
"""

import dataclasses

import numpy as np
import torch

from mayamatchmovesolver_torch.models.scenelens import SceneLens
from mayamatchmovesolver_torch.scene.attrblock import AttrBlock
from mayamatchmovesolver_torch.scene.flatscene import FlatScene

# Array fields of each object, in declaration order.
FLAT_SCENE_FIELDS = tuple(
    f.name for f in dataclasses.fields(FlatScene) if f.name != "doubling_steps"
)
ATTR_BLOCK_FIELDS = tuple(f.name for f in dataclasses.fields(AttrBlock))
SCENE_LENS_FIELDS = ("param_codes",)


def _check_keys(arrays, fields, what):
    if set(arrays) != set(fields):
        raise ValueError(
            "%s arrays need exactly the fields %s, got %s"
            % (what, sorted(fields), sorted(arrays))
        )


def flat_scene(arrays, doubling_steps, *, device, dtype):
    """FlatScene on `device`: integer fields as int64, cam_render_size
    in `dtype` (the attribute dtype it is evaluated with)."""
    _check_keys(arrays, FLAT_SCENE_FIELDS, "FlatScene")
    fields = {
        name: torch.as_tensor(
            np.array(arrays[name]),
            dtype=dtype if name == "cam_render_size" else torch.int64,
            device=device,
        )
        for name in FLAT_SCENE_FIELDS
    }
    return FlatScene(doubling_steps=int(doubling_steps), **fields)


def attr_block(arrays, *, device):
    """AttrBlock on `device`, keeping the arrays' float dtype."""
    _check_keys(arrays, ATTR_BLOCK_FIELDS, "AttrBlock")
    return AttrBlock(
        **{
            name: torch.as_tensor(np.array(arrays[name]), device=device)
            for name in ATTR_BLOCK_FIELDS
        }
    )


def scene_lens(arrays, model_types, *, device):
    """SceneLens on `device`; model_types is the per-camera tuple of
    layer model names."""
    _check_keys(arrays, SCENE_LENS_FIELDS, "SceneLens")
    return SceneLens(
        model_types=tuple(tuple(stack) for stack in model_types),
        param_codes=torch.as_tensor(
            np.array(arrays["param_codes"]), dtype=torch.int64,
            device=device,
        ),
    )
