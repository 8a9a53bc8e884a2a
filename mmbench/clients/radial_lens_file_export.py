"""Requests that export a shot's frames through a spherical 3DEqualizer 4
lens file, one frame each, as clients/lens_file_export.py exports them
through an anamorphic one: the frame's models from the file's curves
(io/lensfile.py::LensLayers.models_at), the ST map that undistorts the
plate and the plate warped through it, then the map that distorts and a
CG layer warped through that; the frame is done when both outputs are on
the device.  Set-up, the program's requests and the kept sample are that
client's; plates and CG layers are made in the configuration's dtype
(half floats for ACES plates), which the warp widens to a float32 output.

What differs is the lens of the plain side: reference/radial.py (3DE4
Radial - Standard, Degree 4, float64) makes the maps the check holds
the program's against, and, in bfloat16, the control's maps.  The checks
are lens_file_export.py's.
"""

import torch

from mmbench.clients import lens_file_export as base
from mmbench.common import checks
from mmbench.reference import radial as ref_lens
from mmbench.reference import stmap as ref_stmap

DIRECTIONS = base.DIRECTIONS
knobs_at, nuke_script, camera = base.knobs_at, base.nuke_script, base.camera
setup, control, release = base.setup, base.control, base.release
_frame = base._frame


def plain_map(state, f, direction, dtype, device):
    """The plain map of frame f's lens in `dtype`: float64 for the
    check, bfloat16 in the control's place."""
    width, height = state["size"]
    return ref_lens.stmap([state["knobs"][f]], state["camera"], width,
                          height, direction, dtype=dtype, device=device)


def request(state, i, rec):
    """The program's frame (lens_file_export.request), or under control()
    the plain maps and warps in bfloat16 in its place."""
    if not state["control"]:
        return base.request(state, i, rec)
    f, k = _frame(state, i)
    dev = state["plates"].device
    out = []
    for direction, source in zip(DIRECTIONS,
                                 (state["plates"][k], state["layers"][k])):
        st_map = plain_map(state, f, direction, torch.bfloat16, dev).float()
        out += [st_map, ref_stmap.warp(source, st_map, torch.bfloat16).float()]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    state["outputs"].offer((i, out))
    return 1, True


def check(state):
    """Over the kept frames, the largest |map - plain map| (UV units),
    |warped - plain warp of the program's map| (image values), and
    |warped - plain warp of the plain map| where the plain map samples
    the image `interior_margin_px` inside its edges."""
    width, height = state["size"]
    worst = dict(map_uv=0.0, warp=0.0, warp_interior=0.0)
    if not len(state["outputs"]):
        worst = {name: float("nan") for name in worst}
    for i, out in state["outputs"]:
        f, k = _frame(state, i)
        sources = (state["plates"][k], state["layers"][k])
        for n, direction in enumerate(DIRECTIONS):
            st_map, warped = out[2 * n], out[2 * n + 1]
            plain = plain_map(state, f, direction, torch.float64,
                              st_map.device)
            readings = dict(map_uv=checks.max_abs(st_map, plain))
            followed = ref_stmap.warp(sources[n], st_map, torch.float64)
            readings["warp"] = checks.max_abs(warped, followed)
            del followed
            inside = ref_stmap.interior(plain, width, height,
                                        state["margin"])
            plain_warp = ref_stmap.warp(sources[n], plain, torch.float64)
            readings["warp_interior"] = (
                checks.max_abs(warped[inside], plain_warp[inside])
                if bool(inside.any()) else float("nan"))
            del plain, plain_warp, inside
            for name, value in readings.items():
                worst[name] = checks.worst(worst[name], value)
    limits = state["limits"]
    return [(k, v, limits[k]) for k, v in worst.items()]
