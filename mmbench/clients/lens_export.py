"""Requests that export a shot's frames through its solved lens, one
frame each: the ST map that undistorts the plate (ops/stmap.py::stmap,
on the card the hand kernel csrc/stmap.cu) and the plate warped through
it (ops/warp.py::warp_image), then the map that distorts and a CG layer
warped through that; the frame is done when both outputs are on the
device.  As the source's DistortionLayers do, a shot makes its maps
anew only where a frame's lens parameters differ from the frame
before: a lens that breathes (its configuration's distortion a range,
run across the shot's frames) needs maps every frame, a static one a
pair at the shot's first frame, and its other frames only warp.  The
solver is bypassed.

Plates and CG layers are a ring made from the seed in set-up.  A
sample of the frames, drawn from the seed over the whole window as it
runs (checks.Reservoir), keeps its maps and outputs.  The check holds
each kept map against the plain map of the same lens
(reference/stmap.py, float64); each warped output against the plain
warp of the program's own map over the whole frame; and against the
plain warp of the plain map where that map samples the image away from
its edges.  Only there: the warp clamps its taps, so that samples
beyond the image's left and top edges blend its first two columns or
rows by their fraction, which jumps at every whole pixel there.
"""

import contextlib

import torch

from mmbench.common import checks
from mmbench.common.records import Recorder
from mmbench.reference import stmap as ref_stmap

DIRECTIONS = ("undistort", "distort")


def _distortions(config):
    """Each frame's distortion: the configuration's number, or its range
    [first, last] run linearly across the frames."""
    frames = int(config["frames"])
    value = config["lens"]["distortion"]
    if isinstance(value, (int, float)):
        return [float(value)] * frames
    lo, hi = value
    return [lo + (hi - lo) * f / (frames - 1) for f in range(frames)]


def setup(ctx):
    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod
    from mayamatchmovesolver_torch.ops import warp

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    width, height = cfg["plate"]
    ring = int(tr["plates"])
    dtype = getattr(torch, cfg["dtype"])
    images = torch.rand((2, ring, height, width, cfg["channels"]),
                        generator=ctx.generator(1), dtype=dtype, device=dev)
    distortions = _distortions(cfg)
    lenses = [models.TdeClassic.create(distortion=d, device=dev, dtype=dtype)
              for d in distortions]
    fb = models.FilmBack.create(width_cm=cfg["film_back_mm"][0] / 10.0,
                                height_cm=cfg["film_back_mm"][1] / 10.0,
                                device=dev, dtype=dtype)
    count = int(tr["check_sample"])
    state = dict(
        size=(width, height), plates=images[0], layers=images[1],
        distortions=distortions,
        film_back_cm=(cfg["film_back_mm"][0] / 10.0,
                      cfg["film_back_mm"][1] / 10.0),
        program=dict(lenses=lenses, fb=fb, stmap=stmap_mod.stmap,
                     warp=warp.warp_image),
        control=False, maps={}, outputs=checks.Reservoir(count + 1, ctx.seed),
        limits=tr["limits"], margin=float(tr["interior_margin_px"]))
    # Build the kernel, and grow the allocator's pool by the frames the
    # window keeps and the one it makes, so that keeping them allocates
    # nothing new there.
    for i in range(count + 1):
        request(state, i, Recorder())
    state["outputs"] = checks.Reservoir(count, ctx.seed)
    return state


def _frame(state, i):
    return i % len(state["distortions"]), i % state["plates"].shape[0]


def _new_maps(state, f):
    """Whether frame f makes its maps: a shot's first frame, or a lens
    that changed since the frame before."""
    d = state["distortions"]
    return f == 0 or d[f] != d[f - 1] or not state["maps"]


def request(state, i, rec):
    f, k = _frame(state, i)
    width, height = state["size"]
    dev = state["plates"].device
    make = _new_maps(state, f)
    out = []
    for direction, source in zip(DIRECTIONS,
                                 (state["plates"][k], state["layers"][k])):
        if state["control"]:
            if make:
                state["maps"][direction] = _control_map(state, f, direction,
                                                        dev)
            st_map = state["maps"][direction]
            warped = ref_stmap.warp(source, st_map, torch.bfloat16).float()
        else:
            p = state["program"]
            if make:
                with rec.span("stmap"):
                    state["maps"][direction] = p["stmap"](
                        p["lenses"][f], p["fb"], width, height, direction,
                        device=dev)
            st_map = state["maps"][direction]
            with rec.span("warp"):
                warped = p["warp"](source, st_map)
        out += [st_map, warped]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    state["outputs"].offer((i, out))
    return 1, True


def _control_map(state, f, direction, device):
    """The plain map in bfloat16, in the program's place."""
    width, height = state["size"]
    return ref_stmap.stmap(state["distortions"][f], state["film_back_cm"],
                           width, height, direction, dtype=torch.bfloat16,
                           device=device).float()


@contextlib.contextmanager
def control(state):
    """The plain map and warp computed in bfloat16 in the program's
    place: the precision below the configuration's float32, which has no
    matrix product for TF32 to act on."""
    state["control"], state["maps"] = True, {}
    try:
        yield
    finally:
        state["control"], state["maps"] = False, {}


def release(state):
    state.pop("program", None)
    state.pop("maps", None)


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
            plain = ref_stmap.stmap(state["distortions"][f],
                                    state["film_back_cm"], width, height,
                                    direction, dtype=torch.float64,
                                    device=st_map.device)
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
