"""Binding lens models to scene cameras with solvable parameters.

Port of mayamatchmovesolver_tpu/models/scenelens.py (ref:
src/mmSolver/mayahelper/maya_lens_model_utils.cpp, applied at
adjust_measureErrors.cpp:464-480).  A SceneLens maps each camera to a
stack of 3DE model layers plus packed attribute codes for every lens
parameter, so lens parameters live in the AttrBlock like any other
attribute and are solvable.  Distortion applies layer 0..N-1 in order;
undistortion applies the inverses in reverse (ref: lens_model.h:36-120,
src/distortion_layers.rs:255).
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mayamatchmovesolver_torch.models import base, tde
from mayamatchmovesolver_torch.scene import flatscene as flatscene_mod
from mayamatchmovesolver_torch.scene.attrblock import (
    ATTR_NONE,
    gather_attr_values,
)

LENS_MODEL_NONE = ""
LENS_MODEL_CLASSIC = "tde_classic"
LENS_MODEL_RADIAL_DEG4 = "tde_radial_std_deg4"
LENS_MODEL_ANAMORPHIC_DEG4 = "tde_anamorphic_std_deg4"
LENS_MODEL_ANAMORPHIC_DEG4_RESCALED = "tde_anamorphic_std_deg4_rescaled"

_MODEL_CLASSES = {
    LENS_MODEL_CLASSIC: tde.TdeClassic,
    LENS_MODEL_RADIAL_DEG4: tde.TdeRadialStdDeg4,
    LENS_MODEL_ANAMORPHIC_DEG4: tde.TdeAnamorphicStdDeg4,
    LENS_MODEL_ANAMORPHIC_DEG4_RESCALED: tde.TdeAnamorphicStdDeg4Rescaled,
}
# name -> ((field, default), ...) in parameter order.
_MODEL_FIELDS = {
    name: tuple((f.name, f.default) for f in dataclasses.fields(cls))
    for name, cls in _MODEL_CLASSES.items()
}
# param slots: model params then pixel_aspect in the last slot.
MAX_LENS_PARAMS = 1 + max(len(f) for f in _MODEL_FIELDS.values())


@dataclasses.dataclass(frozen=True)
class SceneLens:
    """Per-camera lens-layer stacks.

    model_types[c] is the tuple of layer model names for camera c (an
    empty tuple = no lens); param_codes is (C, L, MAX_LENS_PARAMS) int64
    where L is the deepest stack in the scene.
    """

    model_types: Tuple[Tuple[str, ...], ...]
    param_codes: torch.Tensor = None

    def has_any(self):
        return any(len(stack) > 0 for stack in self.model_types)


def attach_lens(scene_graph, camera, model_type, **param_values):
    """Append a lens layer to the camera; creates the layer's parameter
    attributes on the camera node.

    Values may be scalars (static) or per-frame arrays (animated).
    Returns dict name -> Attribute (solvable).  Call several times to
    build a multi-layer stack (distortion applies in call order).
    """
    from mayamatchmovesolver_torch.scene.scenegraph import Attribute

    if model_type not in _MODEL_FIELDS:
        raise ValueError("unknown lens model type: %r" % model_type)
    layers = getattr(camera, "lens_layers", None)
    if layers is None:
        layers = []
        camera.lens_layers = layers
    layer_index = len(layers)
    prefix = "lens_" if layer_index == 0 else "lens%d_" % layer_index

    created = {}
    for name, default in _MODEL_FIELDS[model_type]:
        value = param_values.pop(name, float(default))
        code = scene_graph._attr_builder.add(value)
        attr = Attribute(camera, prefix + name, code)
        camera.attrs[prefix + name] = attr
        created[name] = attr
    pa = param_values.pop("pixel_aspect", 1.0)
    code = scene_graph._attr_builder.add(pa)
    attr = Attribute(camera, prefix + "pixel_aspect", code)
    camera.attrs[prefix + "pixel_aspect"] = attr
    created["pixel_aspect"] = attr
    if param_values:
        raise ValueError(
            "unknown lens parameters for %s: %r"
            % (model_type, sorted(param_values))
        )
    layers.append((model_type, created))
    return created


def bake_scene_lens(scene_graph, *, device) -> SceneLens:
    """Collect lens bindings after the scene graph is built."""
    stacks = []
    for cam in scene_graph._cameras:
        layers = getattr(cam, "lens_layers", [])
        stacks.append(tuple(model_type for model_type, _ in layers))
    max_layers = max((len(s) for s in stacks), default=0) or 1
    codes = np.full(
        (len(scene_graph._cameras), max_layers, MAX_LENS_PARAMS),
        ATTR_NONE, dtype=np.int64,
    )
    for ci, cam in enumerate(scene_graph._cameras):
        for li, (model_type, attrs) in enumerate(
            getattr(cam, "lens_layers", [])
        ):
            for pi, (name, _) in enumerate(_MODEL_FIELDS[model_type]):
                codes[ci, li, pi] = attrs[name].code
            codes[ci, li, MAX_LENS_PARAMS - 1] = attrs["pixel_aspect"].code
    return SceneLens(
        model_types=tuple(stacks),
        param_codes=torch.as_tensor(codes, device=device),
    )


def _film_back_for_camera(scene, attrs, cam_index, frame_indices,
                          pixel_aspect):
    cv = gather_attr_values(
        attrs, scene.cam_attr_codes[cam_index], frame_indices
    )  # (8, F)
    vals = {n: cv[i] for i, n in enumerate(flatscene_mod.CAM_ATTRS)}
    return base.FilmBack(
        film_back_width_cm=vals["sensor_width_mm"] * 0.1,
        film_back_height_cm=vals["sensor_height_mm"] * 0.1,
        lens_center_offset_x_cm=vals["lens_offset_x_mm"] * 0.1,
        lens_center_offset_y_cm=vals["lens_offset_y_mm"] * 0.1,
        pixel_aspect=pixel_aspect,
    )


def _layer_model_and_filmback(scene_lens, scene, attrs, frame_indices,
                              ci, li, model_type):
    """Materialize one layer's model + film back from the attr block."""
    n_params = len(_MODEL_FIELDS[model_type])
    pv = gather_attr_values(
        attrs, scene_lens.param_codes[ci, li, :n_params], frame_indices
    )  # (P, F)
    pa_code = scene_lens.param_codes[ci, li, MAX_LENS_PARAMS - 1]
    pa = gather_attr_values(attrs, pa_code[None], frame_indices)[0]
    # ATTR_NONE pixel aspect gathers to 0 -> default 1.0.
    pa = torch.where(pa_code < 0, 1.0, pa)
    model = _MODEL_CLASSES[model_type](*(pv[i] for i in range(n_params)))
    fb = _film_back_for_camera(scene, attrs, ci, frame_indices, pa)
    return model, fb


def apply_scene_lens(scene_lens: SceneLens, scene, attrs, frame_indices,
                     point_xy, mkr_cam_index, direction="distort"):
    """Distort (or undistort) projected points through each camera's
    lens-layer stack.

    point_xy: (M, F, 2) marker-space positions.  The solver distorts the
    *projected* point to compare against the observed (distorted) marker
    (ref: adjust_measureErrors.cpp:464-480).  NaN outputs fall back to
    the input position (ref: adjust_measureErrors.cpp:250-259).
    """
    if not scene_lens.has_any():
        return point_xy

    out = point_xy
    for ci, stack in enumerate(scene_lens.model_types):
        if not stack:
            continue
        layer_order = (
            enumerate(stack) if direction == "distort"
            else reversed(list(enumerate(stack)))
        )
        mapped = point_xy
        for li, model_type in layer_order:
            model, fb = _layer_model_and_filmback(
                scene_lens, scene, attrs, frame_indices, ci, li,
                model_type,
            )
            if direction == "distort":
                mapped = tde.distort(model, fb, mapped)
            else:
                mapped = tde.undistort(model, fb, mapped)
        mapped = torch.where(torch.isfinite(mapped), mapped, point_xy)
        is_cam = (mkr_cam_index == ci)[:, None, None]
        out = torch.where(is_cam, mapped, out)
    return out
