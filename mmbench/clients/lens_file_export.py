"""Requests that export a shot's frames through a 3DEqualizer lens file,
one frame each, as an artist does with a lens calibration handed over as
a Nuke script: the frame's models are evaluated from the file's curves
(io/lensfile.py::LensLayers.models_at), then the ST map that undistorts
the plate (ops/stmap.py::stmap, on the card the hand kernel
csrc/stmap.cu) and the plate warped through it (ops/warp.py::warp_image),
then the map that distorts and a CG layer warped through that; the frame
is done when both outputs are on the device.  Every knob the
configuration gives as a range is a curve with a key a frame, so every
frame makes its maps.  The solver is bypassed.

In set-up the configuration is written as a Nuke script's text, which
the program parses (io/lensfile.py::parse_string).  Plates and CG layers
are rings made from the seed.  A sample of the frames, drawn from the
seed over the whole window as it runs (checks.Reservoir), keeps its maps
and outputs.  The check holds each kept map against the plain map of the
configuration's own numbers (reference/anamorphic.py, float64), so that
a knob the program misreads fails; each warped output against the plain
warp of the program's own map over the whole frame, and against the
plain warp of the plain map where that map samples the image away from
its edges (reference/stmap.py; clients/lens_export.py says why only
there).
"""

import torch

from mmbench.clients import lens_export
from mmbench.common import checks
from mmbench.common.records import Recorder
from mmbench.reference import anamorphic as ref_lens
from mmbench.reference import stmap as ref_stmap

DIRECTIONS = lens_export.DIRECTIONS
control = lens_export.control
release = lens_export.release

# Camera knobs of a 3DEqualizer lens node, from the configuration.
_CAMERA = ("tde4_filmback_width_cm", "tde4_filmback_height_cm",
           "tde4_pixel_aspect")


def knobs_at(config, f):
    """The lens's knobs at the shot's frame f (from 0): a number, or a
    range [first, last] run linearly across the frames."""
    frames = int(config["frames"])
    out = {}
    for name, value in config["lens"]["knobs"].items():
        if isinstance(value, (int, float)):
            out[name] = float(value)
        else:
            lo, hi = value
            out[name] = lo + (hi - lo) * f / (frames - 1)
    return out


def camera(config):
    return ref_lens.Camera([mm / 10.0 for mm in config["film_back_mm"]],
                           config["pixel_aspect"])


def nuke_script(config, first_frame):
    """The configuration as the Nuke script 3DEqualizer exports: one lens
    node, its camera knobs, each animated knob a curve with a key a frame
    from `first_frame`; every number written to its last digit."""
    cam = camera(config)
    lines = [config["lens"]["node"] + " {", " direction undistort"]
    for name, value in zip(_CAMERA, (cam.width, cam.height,
                                     cam.pixel_aspect)):
        lines.append(" %s %r" % (name, value))
    frames = [knobs_at(config, f) for f in range(int(config["frames"]))]
    for name, value in config["lens"]["knobs"].items():
        if isinstance(value, (int, float)):
            lines.append(" %s %r" % (name, float(value)))
        else:
            keys = " ".join("x%d %r" % (first_frame + f, knobs[name])
                            for f, knobs in enumerate(frames))
            lines.append(" %s {{curve %s }}" % (name, keys))
    lines += [" name lens", "}"]
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


def _frame(state, i):
    return i % state["frames"], i % state["plates"].shape[0]


def request(state, i, rec):
    f, k = _frame(state, i)
    width, height = state["size"]
    dev = state["plates"].device
    p = state["program"] if not state["control"] else None
    if p is not None:
        with rec.span("lens"):
            lenses = p["lens"].models_at(state["first_frame"] + f)
    out = []
    for direction, source in zip(DIRECTIONS,
                                 (state["plates"][k], state["layers"][k])):
        if p is None:
            st_map = plain_map(state, f, direction, torch.bfloat16,
                               dev).float()
            warped = ref_stmap.warp(source, st_map, torch.bfloat16).float()
        else:
            with rec.span("stmap"):
                st_map = p["stmap"](lenses, p["fb"], width, height,
                                    direction, device=dev)
            with rec.span("warp"):
                warped = p["warp"](source, st_map)
        out += [st_map, warped]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    state["outputs"].offer((i, out))
    return 1, True


def plain_map(state, f, direction, dtype, device):
    """The plain map of frame f's lens in `dtype`: float64 for the
    check, bfloat16 in the control's place."""
    width, height = state["size"]
    return ref_lens.stmap([state["knobs"][f]], state["camera"], width,
                          height, direction, dtype=dtype, device=device)


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
