"""Center 2D: pan/zoom the camera view onto a point of interest.

Capability of the reference's centertwodee tool
(ref: python/mmSolver/tools/centertwodee/lib.py + tool.py — rigs an
mmReprojection node driving the viewport camera's pan/zoom, with
slider<->node range remapping in lib.py:37-120).  Here the pan is the
camera's film offset (lens_offset_x/y_mm) and the zoom is a focal-length
multiplier; the offsets that center a target are computed in closed
form from the projection math instead of a live node rig.

From core/camera.py's frustum: a film offset ``o`` shifts an on-axis
point's marker-space x by ``-(o / film_width_mm) * scale_x`` (the
film-fit scale).  Centering a point currently at marker coord ``m``
therefore needs ``o = m * film_width_mm / scale_x``.

Port of mayamatchmovesolver_tpu/tools/centertwodee.py: the offsets are
computed on the scene's device; apply_center bakes on `device` (default
"cuda"; no fallback to the CPU) and reads the new offsets to the host
in one transfer.
"""

import numpy as np
import torch

from mayamatchmovesolver_torch.core import camera as cam_math
from mayamatchmovesolver_torch.scene import attrblock, flatscene
from mayamatchmovesolver_torch.tools import screenspace
from mayamatchmovesolver_torch.tools._tensors import frame_tensor, host

# UI slider <-> node value ranges (ref: centertwodee/constant.py).
SLIDER_MIN = 0.0
SLIDER_MAX = 100.0
PAN_MIN = -1.0
PAN_MAX = 1.0
ZOOM_MIN = 0.01
ZOOM_MAX = 1.0


def lerp(min_value, max_value, mix):
    """(ref: centertwodee/lib.py:37 _lerp)."""
    return (1.0 - mix) * min_value + mix * max_value


def inverse_lerp(min_value, max_value, mix):
    """(ref: centertwodee/lib.py:51 _inverse_lerp)."""
    return (mix - min_value) / (max_value - min_value)


def remap(old_min, old_max, new_min, new_max, mix):
    """(ref: centertwodee/lib.py:65 _remap)."""
    return lerp(new_min, new_max, inverse_lerp(old_min, old_max, mix))


def _film_fit_scales(scene, attrs, frame_indices, cam_index):
    """Per-frame (scale_x, scale_y, film_w_mm, film_h_mm)."""
    codes = scene.cam_attr_codes[cam_index]
    film_wh = attrblock.gather_attr_values(
        attrs, codes[:2], frame_tensor(frame_indices, scene)
    )
    film_w, film_h = film_wh[0], film_wh[1]
    render_w, render_h = scene.cam_render_size[cam_index]
    film_aspect = film_w / film_h
    render_aspect = render_w / render_h
    fit = scene.cam_film_fit[cam_index]
    # film_fit_logic's scale for the projection x/y axes: reuse the
    # marker-space relationship instead — the offset-induced marker
    # shift carries exactly scale_x = render/film aspect ratio for
    # HORIZONTAL (1 for VERTICAL on x), symmetric on y.  Derive both
    # from film_fit_logic to stay exact for FILL/OVERSCAN too.
    one = torch.ones_like(film_aspect)
    right = film_w * 0.5
    left = -right
    top = film_h * 0.5
    bottom = -top
    scale_x, scale_y, _ = cam_math.film_fit_logic(
        right, left, top, bottom, render_aspect * one, film_aspect, fit
    )
    return scale_x, scale_y, film_w, film_h


def center_offsets(scene, attrs, frame_indices, target_world,
                   cam_index=0):
    """Film offsets (mm) that center a world-space target per frame.

    target_world: (3,) static or (F, 3) per-frame world position.
    Returns (offset_x_mm (F,), offset_y_mm (F,)) to ADD to the camera's
    current lens_offset_x/y_mm so the target reprojects to (0, 0).
    """
    frame_indices = frame_tensor(frame_indices, scene)
    ev = flatscene.evaluate(scene, attrs, frame_indices)
    screen_xy, _ = screenspace.world_to_screen(
        ev, target_world, cam_index=cam_index
    )
    scale_x, scale_y, film_w, film_h = _film_fit_scales(
        scene, attrs, frame_indices, cam_index
    )
    # marker shift per mm of offset: -scale/film_size (x), and the
    # y-axis of the frustum carries film_h with its own fit scale.
    offset_x = screen_xy[..., 0] * film_w / scale_x
    offset_y = screen_xy[..., 1] * film_h / scale_y
    return offset_x, offset_y


def apply_center(sg, cam, frame_indices, target_world, *, device="cuda"):
    """Write centering offsets onto a SceneGraph camera (host-side).

    Adds to the camera's existing static lens offsets and returns the
    (offset_x, offset_y) arrays written.  Mirrors the reference tool's
    'apply' action (tool.py main) minus the viewport.
    """
    scene, attrs = sg.bake(device=device)
    frame_indices = np.asarray(frame_indices)
    fi = frame_tensor(frame_indices, scene)
    off_x, off_y = center_offsets(
        scene, attrs, fi, target_world, cam_index=cam.cam_index,
    )
    ox_attr = cam.attr("lens_offset_x_mm")
    oy_attr = cam.attr("lens_offset_y_mm")
    cur = attrblock.gather_attr_values(
        attrs, [ox_attr.code, oy_attr.code], fi
    )
    new_x, new_y = host(cur[0] + off_x, cur[1] + off_y)
    # A static offset takes the mean-centering value; an animated one
    # is written per frame for exact centering.
    for attr, values in ((ox_attr, new_x), (oy_attr, new_y)):
        if attrblock.is_static_code(attr.code):
            sg._attr_builder.set_value(attr.code, float(values.mean()))
        else:
            for fi, v in zip(frame_indices, values):
                sg._attr_builder.set_value(attr.code, v, frame=fi)
    return new_x, new_y


def zoom_focal(focal_length_mm, zoom):
    """Zoom as a focal multiplier (ref: the tool drives viewport camera
    zoom; node range ZOOM_MIN..ZOOM_MAX maps to magnification)."""
    focal = focal_length_mm
    if not torch.is_tensor(focal):
        focal = torch.as_tensor(np.asarray(focal, np.float64))
    zoom = zoom if torch.is_tensor(zoom) else torch.as_tensor(
        np.asarray(zoom, np.float64), device=focal.device)
    return focal / torch.clamp(zoom, min=ZOOM_MIN)
