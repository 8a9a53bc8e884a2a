"""Requests that export a shot's frames through a lens file of two layers,
one frame each: a 3DEqualizer 4 grid calibration of the prime
(LD_3DE4_Radial_Standard_Degree_4, static) under the focus pull's
breathing solved as an animated 3DE classic layer over it
(LD_3DE_Classic_LD_Model), handed over as one Nuke script of two nodes.
The frame's two models come from the file's curves
(io/lensfile.py::LensLayers.models_at), then the stacked ST map that
undistorts the plate (ops/stmap.py::stmap of the list: on the card one
pack launch, the first layer from the pixel index, the second from the
map in place) and the half plate warped through it, then the stacked map
that distorts and a half CG layer warped through that; the frame is
done when both outputs are on the device.  The program's frame is
clients/lens_file_export.py's request.

The configuration's `lenses` are the nodes, in file and application
order; every knob it gives as a range is a curve with a key a frame.
Set-up writes them as a Nuke script's text, which the program parses
(io/lensfile.py::parse_string).  Set-up is a copy of
lens_file_export.setup for a script of a list of nodes, and the control
branch of request and check are radial_lens_file_export.py's copies
with the stacked reference: the debt of ROADMAP Queue E item 4.

The plain side is reference/stack.py, which sends each layer to the
plain lens of its node class: in float64 it makes the maps the check
holds the program's against; in bfloat16 the control's maps.  The checks
are lens_file_export.py's.
"""

import torch

from mmbench.clients import lens_file_export as base
from mmbench.common import checks
from mmbench.common.records import Recorder
from mmbench.reference import stack as ref_lens
from mmbench.reference import stmap as ref_stmap

DIRECTIONS = base.DIRECTIONS
camera, control, release = base.camera, base.control, base.release
_frame = base._frame


def knobs_at(config, f):
    """Each layer's knobs at the shot's frame f (from 0), in file order:
    a number, or a range [first, last] run linearly across the frames."""
    frames = int(config["frames"])
    out = []
    for layer in config["lenses"]:
        knobs = {}
        for name, value in layer["knobs"].items():
            if isinstance(value, (int, float)):
                knobs[name] = float(value)
            else:
                lo, hi = value
                knobs[name] = lo + (hi - lo) * f / (frames - 1)
        out.append(knobs)
    return out


def nuke_script(config, first_frame):
    """The configuration as one Nuke script of its nodes in order, each
    with the camera knobs, each animated knob a curve with a key a frame
    from `first_frame`; every number written to its last digit."""
    cam = camera(config)
    frames = [knobs_at(config, f) for f in range(int(config["frames"]))]
    lines = []
    for n, layer in enumerate(config["lenses"]):
        lines += [layer["node"] + " {", " direction undistort"]
        for name, value in zip(base._CAMERA, (cam.width, cam.height,
                                              cam.pixel_aspect)):
            lines.append(" %s %r" % (name, value))
        for name, value in layer["knobs"].items():
            if isinstance(value, (int, float)):
                lines.append(" %s %r" % (name, float(value)))
            else:
                keys = " ".join("x%d %r" % (first_frame + f, knobs[n][name])
                                for f, knobs in enumerate(frames))
                lines.append(" %s {{curve %s }}" % (name, keys))
        lines += [" name lens%d" % (n + 1), "}"]
    return "\n".join(lines) + "\n"


def setup(ctx):
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod
    from mayamatchmovesolver_torch.ops import warp

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    width, height = cfg["plate"]
    ring = int(tr["plates"])
    dtype = getattr(torch, cfg["dtype"])
    images = torch.rand((2, ring, height, width, cfg["channels"]),
                        generator=ctx.generator(1), dtype=dtype, device=dev)
    first = int(tr["first_frame"])
    lens = lensfile.parse_string(nuke_script(cfg, first))
    count = int(tr["check_sample"])
    state = dict(
        size=(width, height), plates=images[0], layers=images[1],
        frames=int(cfg["frames"]), first_frame=first,
        nodes=[layer["node"] for layer in cfg["lenses"]],
        knobs=[knobs_at(cfg, f) for f in range(int(cfg["frames"]))],
        camera=camera(cfg),
        program=dict(lens=lens, fb=lens.film_back(), stmap=stmap_mod.stmap,
                     warp=warp.warp_image),
        control=False, maps={}, outputs=checks.Reservoir(count + 1, ctx.seed),
        limits=tr["limits"], margin=float(tr["interior_margin_px"]))
    # Build the kernels, and grow the allocator's pool by the frames the
    # window keeps and the one it makes, so that keeping them allocates
    # nothing new there.
    for i in range(count + 1):
        request(state, i, Recorder())
    state["outputs"] = checks.Reservoir(count, ctx.seed)
    return state


def plain_map(state, f, direction, dtype, device):
    """The plain map of frame f's stack in `dtype`: float64 for the
    check, bfloat16 in the control's place."""
    width, height = state["size"]
    return ref_lens.stmap(list(zip(state["nodes"], state["knobs"][f])),
                          state["camera"], width, height, direction,
                          dtype=dtype, device=device)


def request(state, i, rec):
    """The program's frame (lens_file_export.request), or under control()
    the plain stacked maps and warps in bfloat16 in its place."""
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
