#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout (the
ST-map kernel and its layer variant, both of csrc/stmap.cu), reads their
registers and SASS opcode counts, holds each against its plain
PyTorch version, then drives the port's main paths and checks what comes
out:

  * phases 4-5: a dense lens + focal + camera solve of a synthetic HD
    shot on the card, and the ST-map export of the solved lens;
  * phase 6: where a warm dense solve's time goes;
  * phase 7: the same shot with its bundles free, through solve() on the
    Schur BA (CG and Cholesky), and the export of each solved lens;
  * phase 8: the Schur BA at production scale (1024 frames x 2048
    bundles, focal and distortion in the border) with both Jacobian
    assemblies: agreement, time per iteration, memory, a profiled
    iteration, and the export of the solved lens;
  * phase 9: the shot's camera solved frame by frame with the bundles
    known, through solve_per_frame: all frames at once under the batched
    LM, then the first frames in order with the Kalman warm start;
  * phase 10: the dense and the BA solve with host hooks (progress
    callback, interruption) and a checkpoint written at the
    interruption, loaded and resumed to the uninterrupted solve's end;
  * phase 11: a two-layer lens file written, parsed and attached; its
    stack exported as ST maps (first layer through the kernel, second
    through its layer variant) and an HD image warped through the maps;
  * phase 12: the shot's camera, bundles and focal length from nothing
    but its 2D tracks: api.execute of a Collection with SolverCamera
    (RANSAC relative pose, triangulation, resection, two Schur BAs), a
    profile of the bootstrap, and the export of a lens;
  * phase 13: the lensed shot through api.execute with SolverStandard
    (automatic root frames, root pass, per-frame pass, global pass),
    each root-frame strategy, SolverTriangulate with refinement on
    displaced bundles and SolverBasic, and the export of the solved lens;
  * phase 14: the command line (cli.main, in this process) on the shot's
    uvtrack files: camera-solve from the 2D tracks, solve per frame and
    with the Schur BA from an initial camera, reproject, lensdistort at
    HD in both directions (EXRs read back and held against the plain
    version), image-warp through the map file and through the lens, and
    lensdistort once more through python -m in a process of its own;
  * phase 15: the artist tools on the lensed shot (tools/): screen-space
    trail and rig bake, center 2D, reparent under animated and static
    transforms and back, origin frame and scene scale, ray-cast of the
    64 markers onto a 131,072-triangle plane, marker deform and its
    removal, average / duplicate / convert / reproject markers, copy and
    paste of the 64 markers, the camera file, the deviation files of a
    solve, each held to an invariant, and the export of the lens.

Needs one CUDA device; it fails (non-zero exit, no result line) without
one, when the build or a launch fails, or when any check misses.  It
imports nothing of JAX.

    python3 chip_smoke.py

The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it names the card and its power limit, the one before
that is the kernel table as JSON.
"""

import dataclasses
import functools
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel-vs-plain tolerance: float32 on both sides, operations in
# another order (the kernel folds the frames around the polynomial into
# two affine maps on the host, needs no division and contracts into FMAs).
TOL = 2e-5
HD = (1920, 1080)
RAGGED = (1001, 333)

# The shot: 120 frames of a moving camera, 64 tracked bundles, a 36x24
# mm film back, 35 mm lens with 3DE classic distortion 0.08.
FRAMES, BUNDLES = 120, 64
FOCAL, DISTORTION = 35.0, 0.08
# What the solve starts from: every camera channel, the focal length and
# the distortion moved off the truth (degrees for rotations).
CAMERA_OFFSET = dict(tx=0.1, ty=-0.05, tz=0.15, rx=0.3, ry=-0.8, rz=0.2)
FOCAL_OFFSET, DISTORTION_OFFSET = 1.5, -0.03
# Recovery thresholds.  The JAX package, float32 on a CPU, solves this
# shot to focal error 0.0 mm, distortion error 3.2e-8 and error_final
# 3.7e-5 px (PERF.md); the thresholds leave float32 round-off on another
# device a few hundred ulps.  The BA solves of phase 7 are held to them
# too.
FOCAL_TOL_MM, DISTORTION_TOL, ERROR_FINAL_TOL_PX = 1e-3, 1e-5, 1e-3

# Phase 8: the production-scale BA of the JAX package's bench.py
# (bench_production_ba): 1024 frames x 2048 bundles seen in every frame,
# focal 35 mm and classic distortion 0.08 in the border, started at
# focal 35.5 and distortion 0.06 with camera and bundle noise 0.02;
# float32, CG with 30 steps, eps = 0 and 6 LM iterations.
PROD_FRAMES, PROD_BUNDLES, PROD_ITERATIONS, PROD_CG = 1024, 2048, 6, 30
PROD_FOCAL, PROD_DISTORTION = 35.0, 0.08
# After 6 iterations the JAX package, float32 on a CPU, reaches focal
# error 0.181 / 0.207 / 0.262 mm, distortion error 0.00083 / 0.00119 /
# 0.00209 and cost reduction 5.2e6 / 3.9e6 / 6.9e5 at 64x128 / 256x512 /
# 512x1024 (the full size was not run on the CPU; PERF.md).  The
# thresholds leave float32 CG, whose path depends on round-off, about
# 1.5x room on the worst of them.
PROD_FOCAL_TOL_MM, PROD_DISTORTION_TOL, PROD_MIN_COST_REDUCTION = (
    0.35, 0.004, 1e5)
# The two assemblies' normal blocks, float32: every field within this
# share of its largest entry (1e-6 measured on a CPU at 256x512).
BLOCKS_RTOL = 1e-4

# Phase 9: the per-frame camera solve starts every frame CAMERA_OFFSET
# plus seeded noise off the truth (translations in scene units,
# rotations in degrees), and must come back within the tolerances: the
# lens and the bundles are exact, so what is left is float32 round-off
# of a 6-parameter pose from 64 points (2.4e-6 and 4.7e-6 degrees on a
# CPU over the first 24 frames).
PERFRAME_NOISE = dict(translate=0.02, rotate=0.1)
PERFRAME_TRANSLATE_TOL, PERFRAME_ROTATE_TOL_DEG = 2e-4, 2e-4
SEQUENTIAL_FRAMES = 24
# Phase 11: the second layer of the lens file, on top of the shot's
# classic lens.
STACK_RADIAL = dict(degree2_distortion=0.01, degree2_u=0.002,
                    degree4_distortion=-0.003, cylindric_direction=10.0,
                    cylindric_bending=0.01)

# Phase 10: a hooked or resumed solve runs the same iteration body the
# same number of times as the plain one, so the iterations and the stop
# reason are equal and the solved parameters agree within this share of
# the largest: a few hundred float32 ulps for the card's unordered block
# sums, far under what a resume from a wrong state (damping reset, an
# iteration lost) would leave.
HOOKED_RTOL = 1e-5
# The image warped through the identity map, see phase_stack_and_warp.
IDENTITY_WARP_TOL = 1e-3

# Phase 12: the camera solve starts from a camera parked at zeros, bundles
# at the origin and this focal length (the truth is FOCAL).  On a CPU, at
# 120 x 64, the port solves all 120 frames and 64 bundles to focal
# 35.000000 mm and a deviation of 5.3e-05 px with a float32 scene (7.0e-11
# px with a float64 one, where the JAX package reaches focal 34.999999998
# mm and 7.0e-11 px; PERF.md).  The limits leave a float32 BA on another
# device a few hundred ulps, as FOCAL_TOL_MM and ERROR_FINAL_TOL_PX do.
CAMERA_FOCAL_GUESS = 30.0
CAMERA_MIN_BUNDLES = 60
CAMERA_FOCAL_TOL_MM, CAMERA_ERROR_TOL_PX = 1e-3, 1e-3
# Phase 13: the other root-frame strategies run with roots this far apart
# (5 roots over the shot's 120 frames); bundles start this far off.
STRATEGY_ROOT_SPAN = 40
TRIANGULATE_NOISE = 0.5
TRIANGULATE_TOL = 1e-3

# Phase 15: the artist tools on the shot (float32 scenes).  Pixels are
# marker-space differences times the plate width.  The largest misses of
# a float32 CPU rehearsal at full size (phase_tools("cpu")) are noted
# beside each tolerance.
TOOLS_PX_TOL = 1e-3  # reprojections and tracks (4.6e-4: ray-cast hits)
TOOLS_WORLD_RTOL = 1e-4  # world positions, of the camera path (7.4e-7)
TOOLS_RAY_TOL = 1e-4  # ray-cast hits, scene units (5.7e-6)
TOOLS_IDENTITY_TOL = 1e-5  # origin-frame camera, camera file (1.9e-6)
TOOLS_MIN_DEFORM_PX = 1.0  # the lens must move the tracks this far (10)
TOOLS_ORIGIN_FRAME, TOOLS_SCENE_SCALE, TOOLS_RESCALE = 60, 2.0, 0.5
TOOLS_RAY_FRAMES = (0, 60, 119)
# The ray-cast mesh: a square grid of 256 x 256 quads (131,072
# triangles) facing the camera at the bundles' median depth, its half
# size this many times that depth.
TOOLS_MESH_QUADS, TOOLS_MESH_HALF = 256, 2.0

# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bound.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
# Floating-point operations per pixel the map needs, an FMA counted as
# two.  The frame: the pixel-to-core map is affine in (col, row) once
# the host folds the pixel-to-dn scaling into m_in (2 FMAs per axis, 8),
# and so is the core-to-unit map with m_out (8).  Between them one step
# a +- h(x, y) per evaluation, with h = core - identity: the fixed
# point's update p <- t - h(p) is the step's last FMA, and its start is
# the same step from p = t, so neither costs anything beside the steps.
# The classic step needs x2, y2, r2, r4 and 7 per axis (18); the radial
# one x2, y2, r2, 2x, 2xy, the radial factor (3), u, v (4), r2 + 2x2,
# r2 + 2y2 (4) and 6 FMAs (28); the anamorphic one, a polynomial in r2
# and d = x2 - y2 with coefficients folded on the host (cos2*r2 = d,
# cos4*r4 = 2*d^2 - r4, no division), x2, y2, r2, d and 11 per axis
# (26).  Undistort is one step, distort 1 + DISTORT_INVERSE_ITERATIONS.
STMAP_FRAME_FLOPS = 16
STMAP_STEP_FLOPS = {"TdeClassic": 18, "TdeRadialStdDeg4": 28,
                    "TdeAnamorphicStdDeg4": 26,
                    "TdeAnamorphicStdDeg4Rescaled": 26}
# The timed launches of phase 3 write (and, from a map, read) this many
# maps in turn: 4 HD maps are 133 MB, so a map has left the card's 50 MB
# L2 before its turn comes again and the memory bound applies.
TIMING_ROTATION = 4

STMAP_SOURCE = "mayamatchmovesolver_torch/csrc/stmap.cu"
STMAP_REPLACES = "mayamatchmovesolver_tpu/ops/stmap.py:197"
# The reference maps a stack's further layers point-wise in XLA.
STMAP_LAYER_REPLACES = (STMAP_REPLACES + " (further layers of a stack: "
                        "mayamatchmovesolver_tpu/ops/stmap.py:364-372, XLA)")
MODEL_PARAMS = {
    "TdeClassic": dict(distortion=0.15, anamorphic_squeeze=1.05,
                       curvature_x=0.02, curvature_y=-0.01,
                       quartic_distortion=0.03),
    "TdeRadialStdDeg4": dict(degree2_distortion=0.12, degree2_u=0.01,
                             degree2_v=-0.02, degree4_distortion=0.04,
                             degree4_u=-0.005, degree4_v=0.008,
                             cylindric_direction=25.0,
                             cylindric_bending=0.1),
    "TdeAnamorphicStdDeg4": dict(degree2_cx02=0.05, degree2_cy02=0.03,
                                 degree2_cx22=0.02, degree2_cy22=-0.01,
                                 degree4_cx04=0.01, degree4_cy04=-0.005,
                                 degree4_cx24=0.004, degree4_cy24=0.002,
                                 degree4_cx44=-0.003, degree4_cy44=0.001,
                                 lens_rotation=4.0, squeeze_x=1.1,
                                 squeeze_y=0.95),
    "TdeAnamorphicStdDeg4Rescaled": dict(degree2_cx02=0.05,
                                         degree2_cy02=0.03,
                                         degree2_cx22=0.02,
                                         degree2_cy22=-0.01,
                                         degree4_cx04=0.01,
                                         degree4_cy04=-0.005,
                                         lens_rotation=-3.0, squeeze_x=1.05,
                                         squeeze_y=1.0, rescale=1.1),
}


def shot(frames=FRAMES, bundles=BUNDLES, seed=7):
    """The shot as numpy: per-frame camera channels and bundle positions."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 1.0, frames)
    camera = dict(
        tx=-3.0 + 6.0 * t,
        ty=1.5 + 0.3 * np.sin(6.0 * t),
        tz=12.0 + 2.0 * t,
        rx=2.0 * np.sin(3.0 * t),
        ry=-8.0 + 16.0 * t,
        rz=0.5 * np.sin(2.0 * t),
    )
    positions = np.stack([
        rng.uniform(-5.0, 5.0, bundles),
        rng.uniform(-2.0, 4.0, bundles),
        rng.uniform(-14.0, -6.0, bundles),
    ], axis=-1)
    return camera, positions


def build_problem_inputs(device, frames=FRAMES, bundles=BUNDLES,
                         solve_bundles=False, per_frame=False):
    """Scene, perturbed attributes, lens and solve attributes on `device`,
    float32, with marker tracks made by the port's own evaluate + lens
    distortion; with solve_bundles the bundle positions are solved too
    (not moved off the truth).  With per_frame only the six camera
    channels are solved: the focal length and the distortion stay at the
    truth and every frame gets seeded noise on top of CAMERA_OFFSET.
    Returns (scene, attrs, lens, solve_attrs, codes); codes["camera"]
    maps each camera channel to its row of anim_values."""
    from mayamatchmovesolver_torch.core.constants import FilmFit
    from mayamatchmovesolver_torch.models import scenelens
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import (
        set_marker_screen_positions,
    )

    camera, positions = shot(frames, bundles)
    sg = SceneGraph(frame_range=(1, frames), dtype=np.float32)
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=HD[0],
        render_height=HD[1], focal_length_mm=FOCAL, sensor_width_mm=36.0,
        sensor_height_mm=24.0, **camera,
    )
    scenelens.attach_lens(sg, cam, scenelens.LENS_MODEL_CLASSIC,
                          distortion=DISTORTION)
    bnds = []
    for i, (x, y, z) in enumerate(positions):
        bnds.append(sg.create_bundle("b%d" % i, tx=x, ty=y, tz=z))
        sg.create_marker("m%d" % i, camera=cam, bundle=bnds[-1],
                         tx=np.zeros(frames), ty=np.zeros(frames))
    scene, attrs = sg.bake(device=device)
    lens = scenelens.bake_scene_lens(sg, device=device)
    fi = torch.arange(frames, device=device)
    tracks = scenelens.apply_scene_lens(
        lens, scene, attrs, fi, evaluate(scene, attrs, fi).point_xy,
        scene.mkr_cam_index, direction="distort")
    attrs = set_marker_screen_positions(scene, attrs, fi, tracks)

    codes = dict(focal=cam.attr("focal_length_mm").code // 2,
                 distortion=cam.attr("lens_distortion").code // 2,
                 camera={ch: cam.attr(ch).code // 2 for ch in CAMERA_OFFSET})
    static = attrs.static_values.clone()
    anim = attrs.anim_values.clone()
    noise = np.random.RandomState(11)
    for ch, delta in CAMERA_OFFSET.items():
        anim[codes["camera"][ch]] += delta
        if per_frame:
            sigma = PERFRAME_NOISE["translate" if ch[0] == "t" else "rotate"]
            anim[codes["camera"][ch]] += torch.as_tensor(
                noise.normal(0.0, sigma, frames), dtype=anim.dtype,
                device=device)
    if not per_frame:
        static[codes["focal"]] += FOCAL_OFFSET
        static[codes["distortion"]] += DISTORTION_OFFSET
    attrs = dataclasses.replace(attrs, static_values=static,
                                anim_values=anim)
    solve_attrs = [cam.attr(ch) for ch in CAMERA_OFFSET]
    if per_frame:
        return scene, attrs, lens, solve_attrs, codes
    solve_attrs += [cam.attr("focal_length_mm"), cam.attr("lens_distortion")]
    if solve_bundles:
        solve_attrs += [b.attr(ch) for b in bnds for ch in ("tx", "ty", "tz")]
    return scene, attrs, lens, solve_attrs, codes


def solve_shot(device, frames=FRAMES, bundles=BUNDLES, schur=False,
               ba_linear_solver=None, **hooks):
    """The solve of the shot on `device`: dense, or with schur=True the
    Schur BA with the bundles free; `hooks` are further SolverOptions
    (iteration_callback, interrupt_check, callback_interval, ...).
    Returns (attrs_out, result, codes, problem size)."""
    from mayamatchmovesolver_torch.solver import SolverOptions, registry, solve

    scene, attrs, lens, solve_attrs, codes = build_problem_inputs(
        device, frames, bundles, solve_bundles=schur)
    options = SolverOptions(image_width=float(HD[0]), **hooks)
    if schur:
        options = SolverOptions(
            image_width=float(HD[0]),
            solver_type=registry.SOLVER_TYPE_BA_SCHUR,
            ba_linear_solver=ba_linear_solver, **hooks)
    attrs_out, result = solve(scene, attrs, np.arange(frames), solve_attrs,
                              options, lens=lens)
    size = dict(parameters=len(result.solved_parameters),
                residuals=scene.num_markers * frames * 2)
    return attrs_out, result, codes, size


def solve_shot_per_frame(device, frames=FRAMES, bundles=BUNDLES,
                         sequential=False):
    """The shot's camera solved frame by frame on `device`, bundles and
    lens known: all `frames` at once, or with sequential=True in order
    with the Kalman warm start.  Returns (attrs_out, result, the largest
    translation error, the largest rotation error in degrees)."""
    from mayamatchmovesolver_torch.solver import SolverOptions, solve_per_frame

    scene, attrs, lens, solve_attrs, codes = build_problem_inputs(
        device, frames, bundles, per_frame=True)
    attrs_out, result = solve_per_frame(
        scene, attrs, np.arange(frames), solve_attrs,
        SolverOptions(image_width=float(HD[0])), lens=lens,
        sequential=sequential)
    truth, _ = shot(frames, bundles)
    worst = dict(t=0.0, r=0.0)
    for ch, row in codes["camera"].items():
        err = attrs_out.anim_values[row].cpu().numpy() - truth[ch]
        worst[ch[0]] = max(worst[ch[0]], float(np.abs(err).max()))
    return attrs_out, result, worst["t"], worst["r"]


def export_stmaps(distortion, device):
    """ST maps at HD, both directions, of the classic lens with the solved
    distortion."""
    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    model = models.TdeClassic.create(distortion=distortion, device=device,
                                     dtype=torch.float32)
    fb = models.FilmBack.create(width_cm=3.6, height_cm=2.4, device=device,
                                dtype=torch.float32)
    maps = {d: stmap_mod.stmap(model, fb, HD[0], HD[1], d, device=device)
            for d in ("distort", "undistort")}
    return model, fb, maps


def _cuda_ms(fn, launches=20, repeats=5):
    """Milliseconds per call, by CUDA events around `launches` calls back
    to back after a warm-up; the median of `repeats` such runs.  Where
    the host takes longer per call than the device, this is host time."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _raw_launch(model, fb, direction, maps, from_map):
    """A kernel alone: its C entry point with the arguments made once,
    as a no-argument call (no wrapper, no launch count) that takes the
    (H, W, 4) maps in `maps` in turn: the kernel that starts from the
    pixel index writes them, the layer variant (`from_map`) maps them in
    place."""
    from mayamatchmovesolver_torch import _kernels
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    height, width = maps[0].shape[:2]
    core_id, params = stmap_mod._kernel_params(
        model, fb, direction, None if from_map else (width, height))
    function = _kernels.stmap_functions()[from_map]
    # At 10 microseconds a kernel, a launch loop that does more than the
    # bare C call is bound by the host, and its reading wanders between
    # 1x and 2x the kernel's time.
    turns = itertools.cycle([
        stmap_mod._launch_args(st_map, core_id, direction, params)
        for st_map in maps])

    def launch(keep=(maps, params)):  # what the addresses in turns point to
        err = function(*next(turns))
        if err != 0:
            raise RuntimeError("stmap kernel launch failed: %d" % err)

    return launch


def stmap_flops(model_name, direction):
    """Floating-point operations per pixel the map needs, an FMA as two."""
    from mayamatchmovesolver_torch.models.base import (
        DISTORT_INVERSE_ITERATIONS,
    )

    steps = 1 + (DISTORT_INVERSE_ITERATIONS if direction == "distort" else 0)
    return STMAP_FRAME_FLOPS + steps * STMAP_STEP_FLOPS[model_name]


def stmap_bound(model_name, direction, width, height, from_map=False):
    """(bound_ms, bound_by): the least time one H100 could take for this
    map, the larger of its bytes (one 16-byte texel written per pixel;
    from a map, the same texel read first) over the memory rate and the
    floating-point operations the function needs over the float32 rate."""
    pixels = width * height
    bytes_ms = pixels * (32 if from_map else 16) / H100_HBM_BYTES_PER_S * 1e3
    flops_ms = (pixels * stmap_flops(model_name, direction)
                / H100_FP32_FLOPS * 1e3)
    if bytes_ms >= flops_ms:
        return bytes_ms, "bytes"
    return flops_ms, "operations"


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print("[1 device] %s | torch %s CUDA %s | %s" % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0)))
    print("[1 device] tf32: cuda.matmul.allow_tf32=%s cudnn.allow_tf32=%s "
          "float32_matmul_precision=%s" % (
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision()))
    return smi


def _kernel_label(mangled):
    """'classic distort from-map' from a stmap_kernel<CORE, DISTORT,
    FROM_MAP> instantiation's mangled name, None for another symbol."""
    import re

    found = re.search(r"stmap_kernelILi(\d)ELb(\d)ELb(\d)E", mangled)
    if not found:
        return None
    core, distort, from_map = (int(g) for g in found.groups())
    return "%s %s %s" % (("classic", "radial", "anamorphic")[core],
                         ("undistort", "distort")[distort],
                         ("from-pixel", "from-map")[from_map])


def kernel_resources(report):
    """{label: (registers, stack bytes, spill bytes)} from ptxas's
    --resource-usage report of csrc/stmap.cu."""
    import re

    out = {}
    for entry in report.split("Compiling entry function '")[1:]:
        label = _kernel_label(entry.split("'", 1)[0])
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", entry)
        registers = re.search(r"Used (\d+) registers", entry)
        if label and stack and registers:
            out[label] = (int(registers.group(1)), int(stack.group(1)),
                          int(stack.group(2)) + int(stack.group(3)))
    return out


def sass_counts(library):
    """{label: {opcode: count}} of every stmap_kernel instantiation in the
    built library, by `cuobjdump -sass` (it ships with nvcc; it is an
    error if it is missing)."""
    import collections
    import os
    import re
    import shutil

    from mayamatchmovesolver_torch import _kernels

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True,
                          text=True, timeout=300, check=True).stdout
    opcode = re.compile(
        r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _kernel_label(line)
            if current:
                out[current] = collections.Counter()
        elif current:
            found = opcode.match(line)
            if found:
                out[current][found.group(1)] += 1
    return out


def phase_build():
    """Build csrc/stmap.cu, bind both entry points, and print what the
    compiler made of each kernel: registers, stack and spills a thread
    (ptxas) and the SASS opcode counts (cuobjdump)."""
    from mayamatchmovesolver_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build("stmap")
    _kernels.stmap_functions()
    print("[2 build] %s in %.2f s (%s)" % (
        path.name, time.perf_counter() - t0, " ".join(_kernels.NVCC_FLAGS)))
    resources = kernel_resources(
        _kernels.resource_usage_path("stmap").read_text())
    counts = sass_counts(path)
    if len(counts) != 12 or set(counts) != set(resources):
        raise AssertionError(
            "expected 12 stmap_kernel instantiations, ptxas reports %d and "
            "the SASS holds %d" % (len(resources), len(counts)))
    for label in sorted(counts):
        ops = counts[label]
        named = ("FFMA", "FMUL", "FADD")
        registers, stack, spills = resources[label]
        print("[2 build] %-30s %2d registers, %d bytes stack, %d bytes "
              "spilled; SASS %3d opcodes: %s, other %d; MUFU %d" % (
                  label, registers, stack, spills, sum(ops.values()),
                  ", ".join("%s %d" % (n, ops[n]) for n in named),
                  sum(v for k, v in ops.items() if k not in named),
                  ops["MUFU"]))
        # No division, reciprocal or square root in any kernel, and
        # nothing spilled.
        if ops["MUFU"] or stack or spills:
            raise AssertionError("%s: a special-function opcode or a "
                                 "spill in the kernel" % label)


def _layer_source_model(name, models, device):
    """The model whose first-layer map feeds the layer kernel's check of
    model `name`: the shot's classic lens, or for the classic model the
    lens file's radial layer, so the points are no regular grid."""
    if name == "TdeClassic":
        return models.TdeRadialStdDeg4.create(**STACK_RADIAL, device=device,
                                              dtype=torch.float32)
    return models.TdeClassic.create(distortion=DISTORTION, device=device,
                                    dtype=torch.float32)


def phase_kernel_vs_plain(device):
    """Every model and direction of both kernels (from the pixel index,
    from a map) at HD and a ragged size against its plain version; per
    kernel returns the largest difference and the HD timings of the case
    the main paths run (the classic distort export; the lens file's
    radial distort layer)."""
    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    fb = models.FilmBack.create(width_cm=3.6, height_cm=2.4,
                                offset_x_cm=0.05, offset_y_cm=-0.02,
                                device=device, dtype=torch.float32)
    reported = {"stmap": ("TdeClassic", "distort"),
                "stmap_layer": ("TdeRadialStdDeg4", "distort")}
    results = {kernel: dict(max_abs_err=0.0) for kernel in reported}
    for kernel, (name, params), direction, (w, h) in (
            (k, m, d, size) for k in reported
            for m in MODEL_PARAMS.items() for d in ("distort", "undistort")
            for size in (HD, RAGGED)):
        model = getattr(models, name).create(**params, device=device,
                                             dtype=torch.float32)
        from_map = kernel == "stmap_layer"
        if from_map:
            source = stmap_mod.stmap_cuda(
                _layer_source_model(name, models, device), fb, w, h,
                direction, device=device)
            work = source.clone()
            got = stmap_mod.stmap_layer_cuda(work, model, fb, direction)
            if got is not work or got.data_ptr() != work.data_ptr():
                raise AssertionError("the layer kernel did not map in place")

            def plain():
                return stmap_mod.stmap_layer_torch(source, model, fb,
                                                   direction)

            def call():
                return stmap_mod.stmap_layer_cuda(work, model, fb, direction)

        else:
            got = stmap_mod.stmap_cuda(model, fb, w, h, direction,
                                       device=device)

            def plain():
                return stmap_mod.stmap_torch(model, fb, w, h, direction,
                                             device=device)

            def call():
                return stmap_mod.stmap_cuda(model, fb, w, h, direction,
                                            device=device)

        want = plain()
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        finite = bool(got.isfinite().all())
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"],
                                             diff)
        line = "[3 kernel %s] %-28s %-9s %4dx%-4d max|diff| %.3g" % (
            kernel, name, direction, w, h, diff)
        if (w, h) == HD:
            # Launched in place over and over, a map's values run away
            # to inf and NaN; the kernels have no branch on their data,
            # so their time does not depend on them.
            maps = [got.clone() for _ in range(TIMING_ROTATION)]
            ms = _cuda_ms(_raw_launch(model, fb, direction, maps, from_map),
                          launches=100)
            # One map again and again stays in the L2, as a stack's map
            # does between its layers.
            l2_ms = _cuda_ms(_raw_launch(model, fb, direction, maps[:1],
                                         from_map), launches=100)
            del maps
            call_ms = _cuda_ms(call)
            plain_ms = _cuda_ms(plain)
            bound_ms, bound_by = stmap_bound(name, direction, w, h, from_map)
            line += ("  kernel %.4f ms (on one map, in the L2: %.4f ms)  "
                     "wrapper call %.4f ms  plain %.4f ms  bound %.4f ms "
                     "by %s (%.0f%% of it)" % (
                         ms, l2_ms, call_ms, plain_ms, bound_ms, bound_by,
                         100.0 * bound_ms / ms))
            if not ms >= bound_ms:
                raise AssertionError(
                    "%s %s %s: %.4f ms is under the bound of %.4f ms: the "
                    "bound counts too much" % (kernel, name, direction, ms,
                                               bound_ms))
            if (name, direction) == reported[kernel]:
                results[kernel].update(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
        print(line)
        if not finite or not diff <= TOL:
            raise AssertionError(
                "%s kernel disagrees with plain version: %s %s %dx%d "
                "max|diff| %g > %g (finite: %s)" % (
                    kernel, name, direction, w, h, diff, TOL, finite))
    return results


def _check_recovery(tag, attrs_out, result, codes):
    """Print the solve's result and hold focal, distortion and
    error_final to the thresholds; returns the solved distortion."""
    for line in result.as_key_value_strings():
        if not line.startswith("error_per_frame="):
            print("%s %s" % (tag, line))
    focal = float(attrs_out.static_values[codes["focal"]])
    distortion = float(attrs_out.static_values[codes["distortion"]])
    print("%s focal %.6f mm (true %.1f, error %.3g), distortion %.8f (true "
          "%.2f, error %.3g)" % (tag, focal, FOCAL, focal - FOCAL, distortion,
                                 DISTORTION, distortion - DISTORTION))
    if not result.success:
        raise AssertionError("solve failed: %s" % result.reason_string)
    if abs(focal - FOCAL) > FOCAL_TOL_MM:
        raise AssertionError("focal %.5f off by more than %g mm"
                             % (focal, FOCAL_TOL_MM))
    if abs(distortion - DISTORTION) > DISTORTION_TOL:
        raise AssertionError("distortion %.6f off by more than %g"
                             % (distortion, DISTORTION_TOL))
    if not result.error_final <= ERROR_FINAL_TOL_PX:
        raise AssertionError("error_final %g px above %g px"
                             % (result.error_final, ERROR_FINAL_TOL_PX))
    return distortion


def _check_export(tag, distortion, device):
    """Export both ST maps of the solved lens through the kernel and hold
    them against the plain version."""
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    model, fb, maps = export_stmaps(distortion, device)
    torch.cuda.synchronize(device)
    for direction, image in maps.items():
        plain = stmap_mod.stmap_torch(model, fb, HD[0], HD[1], direction,
                                      device=device)
        diff = float((image - plain).abs().max())
        print("%s %s ST map %s finite=%s max|diff vs plain| %.3g" % (
            tag, direction, tuple(image.shape), bool(image.isfinite().all()),
            diff))
        if tuple(image.shape) != (HD[1], HD[0], 4) or not bool(
                image.isfinite().all()) or not diff <= TOL:
            raise AssertionError("bad %s ST map" % direction)


def phase_main_path(device):
    """The dense solve and the export, from the user's entry points."""
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    attrs_out, result, codes, size = solve_shot(device)
    solve_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    print("[4 solve] %d parameters, %d residuals; solve %.3f s (%.3f s "
          "with scene set-up); peak device memory %.1f MiB" % (
              size["parameters"], size["residuals"],
              result.timer.solve_seconds, solve_wall, peak / 2**20))
    distortion = _check_recovery("[4 solve]", attrs_out, result, codes)
    _check_export("[5 export]", distortion, device)


def phase_ba_path(device):
    """The shot with its bundles free, through solve() on the Schur BA:
    the auto linear solver (CG: 120 x 6 = 720 camera unknowns, past the
    threshold of 512) and Cholesky; then the export of each solved
    lens."""
    for linear_solver in (None, "cholesky"):
        tag = "[7 ba %s]" % (linear_solver or "auto")
        t0 = time.perf_counter()
        attrs_out, result, codes, size = solve_shot(
            device, schur=True, ba_linear_solver=linear_solver)
        print("%s %d residuals; solve %.3f s (%.3f s with scene set-up)" % (
            tag, size["residuals"], result.timer.solve_seconds,
            time.perf_counter() - t0))
        if (result.solver_type_name != "ba_schur"
                or "fallback" in result.reason_string):
            raise AssertionError("not solved by the Schur BA: %s, %s" % (
                result.solver_type_name, result.reason_string))
        distortion = _check_recovery(tag, attrs_out, result, codes)
        _check_export(tag, distortion, device)


def profile_ba_shot(device):
    """One warm LM iteration of the shot's BA (auto linear solver: CG)
    under the profiler, after the BA path (nothing here counts toward
    it)."""
    from mayamatchmovesolver_torch.solver import SolverOptions, ba, ba_bridge

    scene, attrs, lens, solve_attrs, _ = build_problem_inputs(
        device, solve_bundles=True)
    bridge, reason = ba_bridge.build_ba_bridge(
        scene, attrs, np.arange(FRAMES), solve_attrs,
        SolverOptions(image_width=float(HD[0])), lens=lens)
    if bridge is None:
        raise AssertionError("the shot is not BA-shaped: %s" % reason)
    body = ba._make_ba_body(bridge.problem, 1e-6, 1e-6, 1e-6, "cg", 30, "ad")
    _profile_iteration(device, "[7 ba profile]", body,
                       ba.ba_init(bridge.problem))


def production_problem(device, frames=PROD_FRAMES, bundles=PROD_BUNDLES,
                       seed=3):
    """bench.py's production BA problem, built by the port on `device`:
    observations made by the port's own residual at the truth, then the
    start moved off it (same seeds and perturbations)."""
    from mayamatchmovesolver_torch.solver import ba

    rng = np.random.RandomState(seed)
    cam_true = np.zeros((frames, 6), np.float32)
    cam_true[:, 0] = np.linspace(-4, 4, frames)
    cam_true[:, 1] = 1.0
    cam_true[:, 2] = 12.0
    cam_true[:, 4] = np.linspace(-8, 8, frames)
    bnd_true = np.stack([rng.uniform(-6, 6, bundles),
                         rng.uniform(-3, 3, bundles),
                         rng.uniform(-10, -3, bundles)],
                        axis=-1).astype(np.float32)
    truth = ba.make_ba_problem(
        marker_uv=np.zeros((bundles, frames, 2), np.float32),
        weight=np.ones((bundles, frames), np.float32),
        mkr_bnd_index=np.arange(bundles), cam_params=cam_true,
        bnd_params=bnd_true, focal_length_mm=PROD_FOCAL, solve_focal=True,
        lens_model_type="tde_classic",
        lens_params=dict(distortion=PROD_DISTORTION),
        lens_solve_names=["distortion"], device=device)
    uv = -ba.ba_residuals(truth, truth.cam_params, truth.bnd_params) / (
        truth.image_width)
    cam0 = cam_true + rng.normal(0, 0.02, cam_true.shape).astype(np.float32)
    bnd0 = bnd_true + rng.normal(0, 0.02, bnd_true.shape).astype(np.float32)
    return truth._replace(
        marker_uv=uv,
        cam_params=torch.as_tensor(cam0, device=device),
        bnd_params=torch.as_tensor(bnd0, device=device),
        shared_params=torch.tensor([35.5, 0.06], dtype=torch.float32,
                                   device=device))


def _synced_seconds(device, fn, repeats=3):
    """Median wall seconds of `fn` with the card synchronized around it,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _profile_iteration(device, tag, body, state):
    """One warm LM iteration under torch.profiler: launches, device time,
    idle share of the wall time and the top 5 kernels."""
    _profiled(device, tag, "one LM iteration", lambda: body(state))


def phase_production(device):
    """The Schur BA at production scale with both assemblies; returns the
    solved distortion."""
    from mayamatchmovesolver_torch.solver import ba

    problem = production_problem(device)
    start = (problem, problem.cam_params, problem.bnd_params,
             problem.shared_params)
    print("[8 production] %d frames x %d bundles: %d observations, %d "
          "parameters" % (PROD_FRAMES, PROD_BUNDLES,
                          PROD_FRAMES * PROD_BUNDLES,
                          6 * PROD_FRAMES + 3 * PROD_BUNDLES + 2))
    blocks = {a: ba.assemble_normal_blocks(*start, assembly=a)
              for a in ba.ASSEMBLIES}
    worst = {}
    for name in blocks["ad"]._fields:
        ad, an = getattr(blocks["ad"], name), getattr(blocks["analytic"], name)
        worst[name] = float((ad - an).abs().max() / ad.abs().max())
    print("[8 production] first assembly, analytic vs ad, max|diff| / "
          "max|ad| per field: " + " ".join(
              "%s %.2g" % kv for kv in worst.items()))
    if not max(worst.values()) <= BLOCKS_RTOL:
        raise AssertionError("the assemblies disagree beyond %g" % BLOCKS_RTOL)
    del blocks

    kw = dict(max_iterations=PROD_ITERATIONS, eps1=0.0, eps2=0.0, eps3=0.0,
              linear_solver="cg", cg_iterations=PROD_CG)
    solved = None
    for assembly in ba.ASSEMBLIES:
        tag = "[8 production %s]" % assembly

        def run():
            out = ba.solve_ba(problem, assembly=assembly, **kw)
            torch.cuda.synchronize(device)
            return out

        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        run()
        first = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        result = run()
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        its = int(result.iterations)
        focal, distortion = result.shared_params.tolist()
        cost0, cost = float(result.cost_initial), float(result.cost)
        print("%s %d iterations: first call %.3f s, warm %.3f s = %.4f "
              "s/iteration; peak device memory %.1f MiB" % (
                  tag, its, first, warm, warm / its, peak / 2**20))
        print("%s focal %.4f mm (error %.4f), distortion %.6f (error %.6f), "
              "cost %.6g -> %.6g (reduction %.3g)" % (
                  tag, focal, focal - PROD_FOCAL, distortion,
                  distortion - PROD_DISTORTION, cost0, cost,
                  cost0 / max(cost, 1e-30)))
        if (its != PROD_ITERATIONS
                or abs(focal - PROD_FOCAL) > PROD_FOCAL_TOL_MM
                or abs(distortion - PROD_DISTORTION) > PROD_DISTORTION_TOL
                or not cost0 / max(cost, 1e-30) >= PROD_MIN_COST_REDUCTION):
            raise AssertionError("%s missed its thresholds" % tag)

        # Where a warm iteration's time goes, stage by stage: the
        # assembly, the solve from its blocks with 0 and with PROD_CG CG
        # steps, and the trial cost.
        mu = torch.tensor(1e-3, dtype=torch.float32, device=device)
        assembly_s = _synced_seconds(device, lambda: ba.assemble_normal_blocks(
            *start, assembly=assembly), repeats=5)
        blocks = ba.assemble_normal_blocks(*start, assembly=assembly)
        solve0_s = _synced_seconds(device, lambda: ba._schur_cg_solve(
            problem, blocks, mu, 0), repeats=5)
        solve_s = _synced_seconds(device, lambda: ba._schur_cg_solve(
            problem, blocks, mu, PROD_CG), repeats=5)
        trial_s = _synced_seconds(device, lambda: ba.ba_cost(*start),
                                  repeats=5)
        del blocks
        print("%s split of a warm iteration (medians of 5): assembly %.4f "
              "s, Schur reduction + preconditioner + back-substitution %.4f "
              "s, CG (%d steps) %.4f s, trial cost %.4f s" % (
                  tag, assembly_s, solve0_s, PROD_CG, solve_s - solve0_s,
                  trial_s))
        body = ba._make_ba_body(problem, 0.0, 0.0, 0.0, "cg", PROD_CG,
                                assembly)
        _profile_iteration(device, tag, body, ba.ba_init(problem))
        solved = distortion
    return solved


def phase_per_frame(device):
    """The shot's camera frame by frame: all 120 frames under the batched
    LM (first and warm), a profiled batched iteration, then the first
    frames in order with the Kalman warm start."""
    from mayamatchmovesolver_torch.solver import lm, problem
    from mayamatchmovesolver_torch.solver.solve import (
        SolverOptions,
        _lm_config,
        build_problem,
    )

    def check(tag, result, frames, translate, rotate):
        stops = sorted(set(result.per_frame_stop_reason))
        print("%s %d frames: success=%d stop reasons %s, %d reverted, %d "
              "iterations (most of any frame), %d function / %d Jacobian "
              "evaluations; error %.6g -> %.6g px; camera within %.3g units "
              "and %.3g degrees of the truth" % (
                  tag, frames, result.success, stops,
                  sum(result.per_frame_reverted), result.iterations,
                  result.function_evals, result.jacobian_evals,
                  result.error_initial, result.error_final, translate,
                  rotate))
        if (len(result.per_frame_stop_reason) != frames
                or not all(s in (1, 2, 3, 4)
                           for s in result.per_frame_stop_reason)
                or any(result.per_frame_reverted) or not result.success
                or not result.error_final <= ERROR_FINAL_TOL_PX
                or not translate <= PERFRAME_TRANSLATE_TOL
                or not rotate <= PERFRAME_ROTATE_TOL_DEG):
            raise AssertionError("%s missed its thresholds" % tag)

    tag = "[9 per-frame]"
    t0 = time.perf_counter()
    _, result, translate, rotate = solve_shot_per_frame(device)
    first = time.perf_counter() - t0
    check(tag, result, FRAMES, translate, rotate)
    t0 = time.perf_counter()
    _, warm, translate, rotate = solve_shot_per_frame(device)
    warm_wall = time.perf_counter() - t0
    check(tag + " again", warm, FRAMES, translate, rotate)
    print("%s %d problems of 6 parameters and %d residuals: first solve "
          "%.3f s (%.3f s with scene set-up), warm %.3f s (%.3f s) = %.4f s "
          "per batched LM iteration" % (
              tag, FRAMES, 2 * BUNDLES, result.timer.solve_seconds, first,
              warm.timer.solve_seconds, warm_wall,
              warm.timer.solve_seconds / warm.iterations))

    scene, attrs, lens, solve_attrs, _ = build_problem_inputs(
        device, per_frame=True)
    options = SolverOptions(image_width=float(HD[0]))
    base = build_problem(scene, attrs, [0], solve_attrs, options, lens=lens)
    frames_t = torch.arange(FRAMES, device=device)
    mask = torch.ones((scene.num_markers, FRAMES), dtype=torch.bool,
                      device=device)
    fn = problem.per_frame_residual_fn(base, frames_t, mask)
    config = _lm_config(options)
    state = lm.lm_init(
        fn, problem.per_frame_initial_parameters(base, frames_t), config)
    body = lm._make_body(lm._make_normal_system(fn, "fwd"), config)
    _profile_iteration(device, "[9 per-frame profile]", body, state)

    tag = "[9 sequential]"
    t0 = time.perf_counter()
    _, result, translate, rotate = solve_shot_per_frame(
        device, frames=SEQUENTIAL_FRAMES, sequential=True)
    wall = time.perf_counter() - t0
    check(tag, result, SEQUENTIAL_FRAMES, translate, rotate)
    print("%s a host loop of %d single-frame solves with the Kalman warm "
          "start: %.3f s (%.3f s with scene set-up) = %.4f s per frame" % (
              tag, SEQUENTIAL_FRAMES, result.timer.solve_seconds, wall,
              result.timer.solve_seconds / SEQUENTIAL_FRAMES))
    _check_export("[9 export]", DISTORTION, device)


def _hooked_solves(tag, device, schur):
    """solve() with a progress callback every 2 iterations against the
    plain solve, then interrupted after the first block.  Returns the
    solved distortion."""
    kind = dict(schur=schur, ba_linear_solver="cholesky" if schur else None)
    _, plain, codes, _ = solve_shot(device, **kind)
    calls = []
    attrs_out, hooked, _, _ = solve_shot(
        device, callback_interval=2,
        iteration_callback=lambda it, cost: calls.append((it, cost)), **kind)
    its = [it for it, _ in calls]
    costs = [cost for _, cost in calls]
    print("%s hooked solve %.3f s (plain %.3f s), %d iterations (plain %d), "
          "stop %d (plain %d); callback saw iterations %s, cost %.6g -> %.6g"
          % (tag, hooked.timer.solve_seconds, plain.timer.solve_seconds,
             hooked.iterations, plain.iterations, hooked.stop_reason,
             plain.stop_reason, its, costs[0], costs[-1]))
    if (its != sorted(set(its)) or its[-1] != hooked.iterations
            or any(b > a for a, b in zip(costs, costs[1:]))
            or hooked.user_interrupted
            or hooked.solver_type_name != plain.solver_type_name):
        raise AssertionError("%s the callback sequence is wrong" % tag)
    distortion = _check_recovery(tag, attrs_out, hooked, codes)
    a, b = hooked.solved_parameters, plain.solved_parameters
    diff = float(np.abs(a - b).max() / np.abs(b).max())
    print("%s hooked vs plain solved parameters: max|diff| / max|x| %.3g" % (
        tag, diff))
    # The blocks change when the host looks, not what is computed: the
    # same iterations and stop reason, and the parameters within
    # HOOKED_RTOL (every run on an H100 read exactly 0, on both routes).
    if (hooked.iterations != plain.iterations
            or hooked.stop_reason != plain.stop_reason
            or diff > HOOKED_RTOL):
        raise AssertionError("%s the hooked solve left the plain one" % tag)

    asked = []
    _, stopped, _, _ = solve_shot(
        device, callback_interval=2,
        interrupt_check=lambda: asked.append(1) or True, **kind)
    print("%s interrupted after the first block: user_interrupted=%d, %d "
          "iterations, error %.6g -> %.6g px, reason %r" % (
              tag, stopped.user_interrupted, stopped.iterations,
              stopped.error_initial, stopped.error_final,
              stopped.reason_string))
    if (not stopped.user_interrupted or stopped.iterations != 2
            or stopped.iterations >= plain.iterations or len(asked) != 1
            or not stopped.error_final <= stopped.error_initial):
        raise AssertionError("%s the interruption went wrong" % tag)
    return distortion


def phase_hooks_and_checkpoints(device):
    """Host hooks and checkpoints on the dense and the BA route."""
    import os
    import tempfile

    from mayamatchmovesolver_torch.solver import (
        SolverOptions, ba, ba_bridge, checkpoint, lm, problem)
    from mayamatchmovesolver_torch.solver.solve import (
        _lm_config,
        build_problem,
    )

    options = SolverOptions(image_width=float(HD[0]))
    with tempfile.TemporaryDirectory() as folder:
        tag = "[10 dense]"
        distortion = _hooked_solves(tag, device, schur=False)
        scene, attrs, lens, solve_attrs, _ = build_problem_inputs(device)
        prob = build_problem(scene, attrs, np.arange(FRAMES), solve_attrs,
                             options, lens=lens)
        fn, config = problem.residual_fn(prob), _lm_config(options)
        init = lm.lm_init(fn, problem.initial_parameters(prob), config)
        whole = lm.lm_run_block(fn, init, config)
        path = os.path.join(folder, "lm.npz")
        checkpoint.save_lm_state(path, lm.lm_run_block(fn, init, config, 2),
                                 metadata={"iteration": 2})
        state, meta = checkpoint.load_lm_state(path, device=device)
        resumed = lm.lm_run_block(fn, state, config)
        diff = float((resumed.x - whole.x).abs().max() / whole.x.abs().max())
        print("%s checkpoint at iteration %d (%d bytes) resumed on %s: %d "
              "iterations (uninterrupted %d), max|diff| / max|x| %.3g" % (
                  tag, meta["iteration"], os.path.getsize(path),
                  state.x.device, int(resumed.it), int(whole.it), diff))
        if (int(state.it) != 2 or not state.x.is_cuda
                or int(resumed.it) != int(whole.it)
                or int(resumed.stop) != int(whole.stop)
                or diff > HOOKED_RTOL):
            raise AssertionError("%s the resumed solve left the "
                                 "uninterrupted one" % tag)

        tag = "[10 ba]"
        _hooked_solves(tag, device, schur=True)
        scene, attrs, lens, solve_attrs, _ = build_problem_inputs(
            device, solve_bundles=True)
        bridge, reason = ba_bridge.build_ba_bridge(
            scene, attrs, np.arange(FRAMES), solve_attrs, options, lens=lens)
        if bridge is None:
            raise AssertionError("the shot is not BA-shaped: %s" % reason)
        kw = dict(max_iterations=options.iterations, eps1=options.eps1,
                  eps2=options.eps2, eps3=options.eps3,
                  linear_solver="cholesky")
        init = ba.ba_init(bridge.problem, options.tau)
        whole = ba.ba_run_block(bridge.problem, init, options.iterations,
                                **kw)
        path = os.path.join(folder, "ba.npz")
        checkpoint.save_ba_state(
            path, ba.ba_run_block(bridge.problem, init, 2, **kw))
        state, _ = checkpoint.load_ba_state(path, device=device)
        resumed = ba.ba_run_block(bridge.problem, state, options.iterations,
                                  **kw)
        focal = [float(s.sh[0]) for s in (resumed, whole)]
        lens_d = [float(s.sh[1]) for s in (resumed, whole)]
        pose = float((resumed.cam - whole.cam).abs().max()
                     / whole.cam.abs().max())
        print("%s checkpoint at iteration 2 (%d bytes) resumed on %s: %d "
              "iterations (uninterrupted %d), focal %.6f (%.6f), distortion "
              "%.8f (%.8f), cost %.6g (%.6g), cameras max|diff| / max %.3g"
              % (tag, os.path.getsize(path), state.cam.device,
                 int(resumed.it), int(whole.it), focal[0], focal[1],
                 lens_d[0], lens_d[1], float(resumed.cost), float(whole.cost),
                 pose))
        if (int(state.it) != 2 or not state.cam.is_cuda
                or int(resumed.it) != int(whole.it)
                or int(resumed.stop) != int(whole.stop)
                or int(resumed.nfev) != int(whole.nfev)
                or int(resumed.njev) != int(whole.njev)
                or abs(focal[0] - focal[1]) > HOOKED_RTOL * FOCAL
                or abs(lens_d[0] - lens_d[1]) > HOOKED_RTOL * DISTORTION
                or abs(focal[0] - FOCAL) > FOCAL_TOL_MM
                or pose > HOOKED_RTOL):
            raise AssertionError("%s the resumed solve left the "
                                 "uninterrupted one" % tag)
    _check_export("[10 export]", distortion, device)


def _plain_stack(models, fb, direction, device):
    """The stack's map with every layer in plain PyTorch."""
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    return stmap_mod.stmap_stack_torch(models, fb, HD[0], HD[1], direction,
                                       device=device)


def lens_file_stack(distortion, device, folder):
    """A two-layer lens file (the shot's classic lens, a radial layer on
    top) written, parsed back and attached to a camera; returns the
    stack's models and film back as baked, float32 on `device`."""
    import os

    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.models import scenelens
    from mayamatchmovesolver_torch.scene import SceneGraph

    layers = lensfile.LensLayers(layers=[
        lensfile.LensLayer(scenelens.LENS_MODEL_CLASSIC,
                           {"distortion": {None: distortion}}),
        lensfile.LensLayer(scenelens.LENS_MODEL_RADIAL_DEG4,
                           {k: {None: v} for k, v in STACK_RADIAL.items()}),
    ])
    path = os.path.join(folder, "stack.nk")
    lensfile.write(path, layers)
    parsed = lensfile.parse(path)
    if [l.model_type for l in parsed.layers] != [
            l.model_type for l in layers.layers]:
        raise AssertionError("the lens file did not parse back")

    sg = SceneGraph(frame_range=(1, 2), dtype=np.float32)
    cam = sg.create_camera("cam", tz=10.0, sensor_width_mm=36.0,
                           sensor_height_mm=24.0)
    sg.create_marker("m", camera=cam, bundle=sg.create_bundle("b", tz=-5.0))
    created = scenelens.attach_lens_file(sg, cam, path)
    scene, attrs = sg.bake(device=device)
    lens = scenelens.bake_scene_lens(sg, device=device)
    frame = torch.zeros(1, dtype=torch.int64, device=device)
    models, fb = [], None
    for li, model_type in enumerate(lens.model_types[0]):
        model, fb = scenelens._layer_model_and_filmback(
            lens, scene, attrs, frame, 0, li, model_type)
        models.append(type(model)(*[
            getattr(model, f.name)[0] for f in dataclasses.fields(model)]))
    fb = type(fb)(*[getattr(fb, f.name)[0] for f in dataclasses.fields(fb)])
    baked = float(attrs.static_values[created[0]["distortion"].code // 2])
    # The file holds 6 significant digits (%g).
    if len(models) != 2 or abs(baked - distortion) > 1e-6 * abs(distortion):
        raise AssertionError("attach_lens_file baked %r for %r"
                             % (baked, distortion))
    return models, fb


def phase_stack_and_warp(device, distortion):
    """The lens file's stack exported at HD in both directions (one
    kernel launch a layer: the first from the pixel index, the second
    from the map) against the all-plain stack, and an HD image warped
    through the maps.  Returns what time_stack_and_warp needs."""
    import tempfile

    from mayamatchmovesolver_torch import models as models_mod
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod
    from mayamatchmovesolver_torch.ops import warp

    tag = "[11 stack]"
    with tempfile.TemporaryDirectory() as folder:
        stack, fb = lens_file_stack(distortion, device, folder)

    def launches():
        return (stmap_mod.stmap_cuda.launches,
                stmap_mod.stmap_layer_cuda.launches)

    maps = {}
    for direction in ("distort", "undistort"):
        before = launches()
        maps[direction] = stmap_mod.stmap(stack, fb, HD[0], HD[1], direction,
                                          device=device)
        launched = tuple(b - a for a, b in zip(before, launches()))
        # A Passthrough layer is the identity and launches nothing.
        padded = stmap_mod.stmap(
            [stack[0], models_mod.Passthrough(), stack[1]], fb, HD[0], HD[1],
            direction, device=device)
        launched_padded = tuple(
            b - a - n for a, b, n in zip(before, launches(), launched))
        plain = _plain_stack(stack, fb, direction, device)
        torch.cuda.synchronize(device)
        diff = float((maps[direction] - plain).abs().max())
        print("%s %s: %d stmap + %d stmap_layer kernel launches for %d "
              "layers, %s finite=%s max|diff vs all-plain stack| %.3g" % (
                  tag, direction, launched[0], launched[1], len(stack),
                  tuple(maps[direction].shape),
                  bool(maps[direction].isfinite().all()), diff))
        if (launched != (1, len(stack) - 1) or launched_padded != launched
                or not torch.equal(padded, maps[direction])
                or tuple(maps[direction].shape) != (HD[1], HD[0], 4)
                or not bool(maps[direction].isfinite().all())
                or not diff <= TOL):
            raise AssertionError("bad %s stack map" % direction)
    one = stmap_mod.stmap(stack[0], fb, HD[0], HD[1], "undistort",
                          device=device)
    if not float((maps["undistort"] - one).abs().max()) > 1e-4:
        raise AssertionError("the second layer changed nothing")

    tag = "[11 warp]"
    rng = np.random.RandomState(5)
    image_cpu = torch.as_tensor(
        rng.uniform(0.0, 1.0, (HD[1], HD[0], 4)).astype(np.float32))
    image = image_cpu.to(device)
    # Through the Passthrough map: v is up in warp_image and the map's
    # rows run the other way, so the image comes back with its rows
    # reversed.  The map samples pixel centres, where the floor turns on
    # float32's last bit; that shows only in the first column and the
    # source's first row (their clamped neighbour is another pixel),
    # which are left out.  Elsewhere the sample position u * w - 0.5 is
    # float32 at w = 1920, good to 2^-13 px in each of x and y, and the
    # random image changes by up to 1 from pixel to pixel.
    ident = stmap_mod.stmap(models_mod.Passthrough(), fb, HD[0], HD[1],
                            device=device)
    flipped = warp.warp_image(image, ident)
    diff = float((flipped - image.flip(0))[:-1, 1:].abs().max())
    print("%s through the Passthrough map: the image with its rows "
          "reversed, max|diff| %.3g" % (tag, diff))
    if (tuple(flipped.shape) != tuple(image.shape)
            or not diff <= IDENTITY_WARP_TOL):
        raise AssertionError("the identity warp is not the image")
    # Through the solved lens's map, built by warp_image_with_lens on the
    # card (the kernel): the same map on the CPU gives the same image.
    before = stmap_mod.stmap_cuda.launches
    warped = warp.warp_image_with_lens(image, stack[0], fb, "undistort")
    launched = stmap_mod.stmap_cuda.launches - before
    on_cpu = warp.warp_image(image_cpu, one.cpu())
    diff = float((warped.cpu() - on_cpu).abs().max())
    moved = float((warped - image).abs().mean())
    print("%s through the solved lens's map (%d kernel launch): max|diff "
          "vs the CPU's warp through the same map| %.3g, mean|warped - "
          "image| %.3g" % (tag, launched, diff, moved))
    if (launched != 1 or not bool(warped.isfinite().all()) or not diff <= 1e-5
            or not moved > 1e-3):
        raise AssertionError("the lens warp left the CPU result")
    return stack, fb, image, one


def time_stack_and_warp(device, stack, fb, image, lens_map):
    """CUDA-event times of the stack export and the warp, after the
    stack path (nothing here counts toward it)."""
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod
    from mayamatchmovesolver_torch.ops import warp

    for direction in ("distort", "undistort"):
        ms = _cuda_ms(lambda: stmap_mod.stmap(stack, fb, HD[0], HD[1],
                                              direction, device=device))
        plain_ms = _cuda_ms(lambda: _plain_stack(stack, fb, direction,
                                                 device))
        print("[11 stack times] %s: %.4f ms a call (all plain %.4f ms)" % (
            direction, ms, plain_ms))
    warp_ms = _cuda_ms(lambda: warp.warp_image(image, lens_map))
    both_ms = _cuda_ms(lambda: warp.warp_image_with_lens(
        image, stack[0], fb, "undistort"))
    print("[11 warp times] %dx%dx4 float32: warp_image %.4f ms, "
          "warp_image_with_lens (map + warp) %.4f ms" % (
              HD[0], HD[1], warp_ms, both_ms))


def shot_graph(device, frames=FRAMES, bundles=BUNDLES, lens=True,
               dtype=np.float32, **camera_extra):
    """The shot as an editable scene graph at the truth, its markers
    carrying the tracks that the port's own evaluate (and, with `lens`,
    its lens distortion) makes on `device`; `camera_extra` are further
    attribute values of the camera (per-frame arrays animate them).
    Returns (sg, cam, bundle nodes, marker nodes, raw marker positions
    (M, F, 2))."""
    from mayamatchmovesolver_torch.core.constants import FilmFit
    from mayamatchmovesolver_torch.models import scenelens
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import marker_fit_scale

    camera, positions = shot(frames, bundles)
    sg = SceneGraph(frame_range=(1, frames), dtype=dtype)
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=HD[0],
        render_height=HD[1], focal_length_mm=FOCAL, sensor_width_mm=36.0,
        sensor_height_mm=24.0, **camera, **camera_extra,
    )
    if lens:
        scenelens.attach_lens(sg, cam, scenelens.LENS_MODEL_CLASSIC,
                              distortion=DISTORTION)
    bnds, mkrs = [], []
    for i, (x, y, z) in enumerate(positions):
        bnds.append(sg.create_bundle("b%d" % i, tx=x, ty=y, tz=z))
        mkrs.append(sg.create_marker("m%d" % i, camera=cam, bundle=bnds[-1],
                                     tx=np.zeros(frames),
                                     ty=np.zeros(frames)))
    scene, attrs = sg.bake(device=device)
    fi = torch.arange(frames, device=device)
    tracks = evaluate(scene, attrs, fi).point_xy
    if lens:
        tracks = scenelens.apply_scene_lens(
            scenelens.bake_scene_lens(sg, device=device), scene, attrs, fi,
            tracks, scene.mkr_cam_index, direction="distort")
    fsx, fsy = marker_fit_scale(scene, attrs, fi)
    raw = torch.stack([tracks[..., 0] / fsx, tracks[..., 1] / fsy],
                      dim=-1).cpu().numpy()
    for i, mkr in enumerate(mkrs):
        sg.set_value(mkr.attr("tx"), raw[i, :, 0])
        sg.set_value(mkr.attr("ty"), raw[i, :, 1])
    return sg, cam, bnds, mkrs, raw


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _TimedCalls:
    """While active, every call of `module.name` for the given names is
    timed with the device synchronized around it; `calls` collects
    (name, seconds, args, kwargs)."""

    def __init__(self, module, names, device):
        self.module, self.names, self.device = module, names, device
        self.calls, self._real = [], {}

    def __enter__(self):
        for name in self.names:
            real = self._real[name] = getattr(self.module, name)

            def timed(*args, _name=name, _real=real, **kwargs):
                _sync(self.device)
                t0 = time.perf_counter()
                out = _real(*args, **kwargs)
                _sync(self.device)
                self.calls.append((_name, time.perf_counter() - t0, args,
                                   kwargs))
                return out

            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self.module, name, real)


def solve_camera_from_tracks(device, frames=FRAMES, bundles=BUNDLES,
                             dtype=np.float32):
    """The camera path: the shot's geometry seen through no lens (the
    SfM has none), a scene that knows nothing but the 2D tracks (camera
    parked at zeros, focal length CAMERA_FOCAL_GUESS, bundles at the
    origin), and api.execute of a Collection with SolverCamera on
    `device`.  Holds the result to the limits and returns (result, the
    solved focal length, the timed stages)."""
    import mayamatchmovesolver_torch.api as mmapi
    from mayamatchmovesolver_torch.core.constants import FilmFit
    from mayamatchmovesolver_torch.sfm import camerasolve

    tag = "[12 camera]"
    _, _, _, _, raw = shot_graph(device, frames, bundles, lens=False,
                                 dtype=dtype)
    sg = mmapi.SceneGraph(frame_range=(1, frames), dtype=dtype)
    zeros = np.zeros(frames)
    cam = sg.create_camera(
        "cam", film_fit=FilmFit.HORIZONTAL, render_width=HD[0],
        render_height=HD[1], focal_length_mm=CAMERA_FOCAL_GUESS,
        sensor_width_mm=36.0, sensor_height_mm=24.0, tx=zeros, ty=zeros,
        tz=zeros, rx=zeros, ry=zeros, rz=zeros)
    col = mmapi.Collection(sg)
    for i in range(bundles):
        col.add_marker(sg.create_marker(
            "m%d" % i, camera=cam,
            bundle=sg.create_bundle("b%d" % i, tx=0.0, ty=0.0, tz=0.0),
            tx=raw[i, :, 0], ty=raw[i, :, 1]))
    col.set_solver(mmapi.SolverCamera(range(frames), solve_focal=True))
    col.options = mmapi.SolverOptions(image_width=float(HD[0]))
    ok, messages = mmapi.validate(col)
    if not ok:
        raise AssertionError("%s not valid: %s" % (tag, messages))

    stages = ("camera_solve", "refine_with_bundle_adjustment")
    t0 = time.perf_counter()
    with _TimedCalls(camerasolve, stages, device) as timed:
        attrs_out, results = mmapi.execute(col, device=device)
    _sync(device)
    whole = time.perf_counter() - t0
    result = results[0]
    for line in result.as_key_value_strings():
        if not line.startswith("error_per_frame="):
            print("%s %s" % (tag, line))
    focal = float(attrs_out.static_values[
        cam.attr("focal_length_mm").code // 2])
    seconds = [t for _, t, _, _ in timed.calls]
    print("%s %d frames x %d bundles, %s: bootstrap %.3f s, BA with the "
          "focal length free %.3f s, BA at the solved focal length %.3f s, "
          "the whole execute %.3f s; focal %.6f mm (true %.1f, guessed %.1f)"
          % (tag, frames, bundles, attrs_out.static_values.dtype, seconds[0],
             seconds[1], seconds[2], whole, focal, FOCAL, CAMERA_FOCAL_GUESS))
    wanted = "camera solve: %d/%d frames, " % (frames, frames)
    solved_bundles = int(result.reason_string.split(", ")[1].split("/")[0])
    if (len(results) != 1 or not result.success
            or [name for name, _, _, _ in timed.calls]
            != [stages[0], stages[1], stages[1]]
            or not result.reason_string.startswith(wanted)
            or solved_bundles < bundles - (BUNDLES - CAMERA_MIN_BUNDLES)
            or abs(focal - FOCAL) > CAMERA_FOCAL_TOL_MM
            or not result.error_final <= CAMERA_ERROR_TOL_PX
            or attrs_out.static_values.device.type
            != torch.device(device).type):
        raise AssertionError("%s missed its limits" % tag)
    return result, focal, timed.calls


def _profiled(device, tag, what, fn):
    """`fn` once warm on the host clock and once under torch.profiler:
    launches, device time, idle share, and what torch.linalg.eigh costs
    a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("%s %s %.4f s warm; the profiler saw no device time" % (
            tag, what, wall))
        return
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print("%s %s %.4f s warm; under the profiler: %d kernel launches, %.4f "
          "s device time, device idle %.1f%% of the warm wall time" % (
              tag, what, wall, sum(e.count for e in kernels), device_s,
              100.0 * max(0.0, 1.0 - device_s / wall)))
    for e in events:
        if e.key == "aten::linalg_eigh":
            print("%s   torch.linalg.eigh: %d calls, %.3f ms of host time "
                  "and %.3f ms of device time a call (its own kernels and "
                  "its children's)" % (
                      tag, e.count, e.cpu_time_total / e.count / 1e3,
                      e.device_time_total / e.count / 1e3))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print("%s   %-60.60s %6d x  %.4f s" % (
            tag, e.key, e.count, e.self_device_time_total / 1e6))


def phase_camera(device):
    """The camera path on the card, then the export of a lens at the
    smoke's distortion; returns what profile_camera_bootstrap needs."""
    _, _, calls = solve_camera_from_tracks(device)
    _check_export("[12 export]", DISTORTION, device)
    return calls[0][2], calls[0][3]


def profile_camera_bootstrap(device, args, kwargs):
    """The bootstrap of the camera path (camera_solve with the very
    arguments SolverCamera gave it) under the profiler, after the path
    (nothing here counts toward it)."""
    from mayamatchmovesolver_torch.sfm import camerasolve

    _profiled(device, "[12 bootstrap profile]",
              "camera_solve (RANSAC pair, %d resections, 2 refinement "
              "rounds)" % (FRAMES - 2),
              lambda: camerasolve.camera_solve(*args, **kwargs))


def shot_collection(device, what, frames=FRAMES, bundles=BUNDLES, **solver):
    """A Collection over the lensed shot with its start moved off the
    truth, for the strategy `what`:

      * "standard": CAMERA_OFFSET on every camera channel, the focal
        length and the distortion off by FOCAL_OFFSET and
        DISTORTION_OFFSET; all eight are the attributes; SolverStandard;
      * "triangulate": every bundle off by seeded noise of
        TRIANGULATE_NOISE; the bundle positions are the attributes;
        SolverTriangulate with refinement;
      * "basic": the camera channels off by CAMERA_OFFSET plus seeded
        noise a frame (PERFRAME_NOISE); they are the attributes;
        SolverBasic.

    Returns (collection, cam, bundle nodes)."""
    import mayamatchmovesolver_torch.api as mmapi

    sg, cam, bnds, mkrs, _ = shot_graph(device, frames, bundles)
    truth, positions = shot(frames, bundles)
    col = mmapi.Collection(sg)
    col.add_marker(*mkrs)
    col.options = mmapi.SolverOptions(image_width=float(HD[0]))
    noise = np.random.RandomState(11)
    channels = [cam.attr(ch) for ch in CAMERA_OFFSET]
    if what == "triangulate":
        for bnd, position in zip(bnds, positions):
            for ch, value in zip(("tx", "ty", "tz"), position):
                sg.set_value(bnd.attr(ch), value + noise.normal(
                    0.0, TRIANGULATE_NOISE))
                col.add_attribute(bnd.attr(ch))
        col.set_solver(mmapi.SolverTriangulate(range(frames), refine=True,
                                               **solver))
        return col, cam, bnds
    for ch, delta in CAMERA_OFFSET.items():
        moved = truth[ch] + delta
        if what == "basic":
            sigma = PERFRAME_NOISE["translate" if ch[0] == "t" else "rotate"]
            moved = moved + noise.normal(0.0, sigma, frames)
        sg.set_value(cam.attr(ch), moved)
    col.add_attribute(*channels)
    if what == "basic":
        col.set_solver(mmapi.SolverBasic(range(frames), **solver))
        return col, cam, bnds
    sg.set_value(cam.attr("focal_length_mm"), FOCAL + FOCAL_OFFSET)
    sg.set_value(cam.attr("lens_distortion"), DISTORTION + DISTORTION_OFFSET)
    col.add_attribute(cam.attr("focal_length_mm"),
                      cam.attr("lens_distortion"))
    col.set_solver(mmapi.SolverStandard(range(frames), **solver))
    return col, cam, bnds


def _camera_errors(attrs_out, cam, frames, bundles):
    """The largest translation and rotation (degrees) error of the
    solved camera channels against the shot's truth."""
    truth, _ = shot(frames, bundles)
    worst = dict(t=0.0, r=0.0)
    for ch in CAMERA_OFFSET:
        err = attrs_out.anim_values[cam.attr(ch).code // 2].cpu().numpy() \
            - truth[ch]
        worst[ch[0]] = max(worst[ch[0]], float(np.abs(err).max()))
    return worst["t"], worst["r"]


def solve_with_strategies(device, frames=FRAMES, bundles=BUNDLES):
    """The strategy path on `device`, every solve through api.execute:
    SolverStandard with automatic root frames and the global pass, the
    three other root-frame strategies with roots STRATEGY_ROOT_SPAN
    apart, SolverTriangulate with refinement, SolverBasic.  Holds each to
    its limits and returns the distortion SolverStandard solved."""
    import mayamatchmovesolver_torch.api as mmapi
    from mayamatchmovesolver_torch.solver import rootframe
    from mayamatchmovesolver_torch.solver.strategies import (
        RootFrameStrategy,
        root_frame_schedule,
    )

    def run(tag, col):
        t0 = time.perf_counter()
        attrs_out, results = mmapi.execute(col, device=device)
        _sync(device)
        wall = time.perf_counter() - t0
        steps = "; ".join(
            "%d iterations, stop %d, %.3g -> %.3g px" % (
                r.iterations, r.stop_reason, r.error_initial, r.error_final)
            for r in results)
        print("%s %d results in %.3f s: %s" % (tag, len(results), wall,
                                               steps))
        if col.last_results is not results or not all(
                r.success for r in results):
            raise AssertionError("%s a step failed: %s" % (
                tag, [r.reason_string for r in results]))
        return attrs_out, results

    def roots(span):
        return rootframe.root_frames_subdivide([0, frames - 1], span)

    tag = "[13 standard]"
    col, cam, _ = shot_collection(device, "standard", frames, bundles,
                                  root_frame_indices=None, global_solve=True)
    attrs_out, results = run(tag, col)
    codes = dict(focal=cam.attr("focal_length_mm").code // 2,
                 distortion=cam.attr("lens_distortion").code // 2)
    print("%s automatic root frames %s: a root pass, the per-frame pass "
          "over %d frames, the global pass" % (
              tag, roots(col.solver.root_frame_span), frames))
    if (len(results) != 3
            or len(results[1].per_frame_stop_reason) != frames):
        raise AssertionError("%s expected 3 results" % tag)
    distortion = _check_recovery(tag, attrs_out, results[-1], codes)

    for strategy in (RootFrameStrategy.FWD_PAIR,
                     RootFrameStrategy.FWD_PAIR_AND_GLOBAL,
                     RootFrameStrategy.FWD_INCREMENT):
        tag = "[13 standard %s]" % strategy
        col, cam, _ = shot_collection(
            device, "standard", frames, bundles, root_frame_indices=None,
            root_frame_span=STRATEGY_ROOT_SPAN, root_frame_strategy=strategy)
        attrs_out, results = run(tag, col)
        batches = root_frame_schedule(roots(STRATEGY_ROOT_SPAN), strategy)
        # No global pass: the lens is what the last root batch left, and
        # the per-frame pass puts every camera on it.
        if (len(results) != len(batches) + 1
                or not results[-1].error_final <= results[0].error_initial):
            raise AssertionError("%s expected %d results" % (
                tag, len(batches) + 1))

    tag = "[13 triangulate]"
    col, cam, bnds = shot_collection(device, "triangulate", frames, bundles)
    attrs_out, results = run(tag, col)
    _, positions = shot(frames, bundles)
    static = attrs_out.static_values.cpu().numpy()
    off = max(abs(static[bnd.attr(ch).code // 2] - value)
              for bnd, position in zip(bnds, positions)
              for ch, value in zip(("tx", "ty", "tz"), position))
    print("%s %s; bundles within %.3g units of the truth (started %.1f "
          "off)" % (tag, results[-1].reason_string, off, TRIANGULATE_NOISE))
    if (len(results) != 2
            or results[-1].reason_string != "triangulated %d/%d bundles" % (
                bundles, bundles)
            or not results[-1].error_final <= ERROR_FINAL_TOL_PX
            or not off <= TRIANGULATE_TOL):
        raise AssertionError("%s missed its limits" % tag)

    tag = "[13 basic]"
    col, cam, _ = shot_collection(device, "basic", frames, bundles)
    attrs_out, results = run(tag, col)
    translate, rotate = _camera_errors(attrs_out, cam, frames, bundles)
    print("%s camera within %.3g units and %.3g degrees of the truth" % (
        tag, translate, rotate))
    if (len(results) != 1
            or len(results[0].per_frame_stop_reason) != frames
            or any(results[0].per_frame_reverted)
            or not results[0].error_final <= ERROR_FINAL_TOL_PX
            or not translate <= PERFRAME_TRANSLATE_TOL
            or not rotate <= PERFRAME_ROTATE_TOL_DEG):
        raise AssertionError("%s missed its limits" % tag)
    return distortion


def phase_strategy(device):
    """The strategy path on the card, then the export of the lens that
    SolverStandard solved."""
    _check_export("[13 export]", solve_with_strategies(device), device)


def phase_profile(device):
    """Where a warm solve's time goes, after the main path (nothing here
    counts toward it): the whole solve run again, and the normal system
    — residual, vmap(jvp) Jacobian, JtJ and Jtr — timed warm on the host
    clock and once under torch.profiler for its device time and kernel
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mayamatchmovesolver_torch.solver import lm, problem
    from mayamatchmovesolver_torch.solver.solve import (
        SolverOptions,
        build_problem,
    )

    scene, attrs, lens, solve_attrs, _ = build_problem_inputs(device)
    prob = build_problem(scene, attrs, np.arange(FRAMES), solve_attrs,
                         SolverOptions(image_width=float(HD[0])), lens=lens)
    fn = problem.residual_fn(prob)
    x = problem.initial_parameters(prob)
    system = lm._make_normal_system(fn, "fwd")

    def wall(call):
        call()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    system_s, residual_s = wall(lambda: system(x)), wall(lambda: fn(x))
    t0 = time.perf_counter()
    _, again, _, _ = solve_shot(device)
    print("[6 profile] the same solve again in this process: %.3f s wall, "
          "%d iterations (the main path's solve includes first-call "
          "set-up of torch.func and the CUDA libraries)" % (
              time.perf_counter() - t0, again.iterations))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system(x)
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("[6 profile] normal system %.4f s warm (residual alone %.4f "
              "s); the profiler saw no device time" % (system_s, residual_s))
        return
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print("[6 profile] normal system %.4f s warm (residual alone %.4f s); "
          "under the profiler: %d kernel launches, %.4f s device time, "
          "device idle %.1f%% of the warm wall time" % (
              system_s, residual_s, launches, device_s,
              100.0 * max(0.0, 1.0 - device_s / system_s)))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        print("[6 profile]   %-60.60s %6d x  %.4f s" % (
            e.key, e.count, e.self_device_time_total / 1e6))


def write_shot_tracks(device, folder, frames=FRAMES, bundles=BUNDLES):
    """The shot's 2D tracks (no lens; float64 from the port's evaluate on
    `device`) written through the port's uvtrack writer as v4 files:
    tracks_3d.uv with the true bundles in its 3D blocks, tracks.uv
    without.  Returns the true pixel positions (bundles, frames, 2)."""
    import os

    from mayamatchmovesolver_torch.io import MarkerData, uvtrack
    from mayamatchmovesolver_torch.scene import evaluate

    sg, _, _, _, raw = shot_graph(device, frames, bundles, lens=False,
                                  dtype=np.float64)
    _, positions = shot(frames, bundles)
    for name, with_3d in (("tracks_3d.uv", True), ("tracks.uv", False)):
        data = []
        for i in range(bundles):
            md = MarkerData(name="m%d" % i, id=str(i), group_name="shot")
            for f in range(frames):
                md.x.set_value(f + 1, float(raw[i, f, 0]) + 0.5)
                md.y.set_value(f + 1, float(raw[i, f, 1]) + 0.5)
                md.weight.set_value(f + 1, 1.0)
                md.enable.set_value(f + 1, 1)
            if with_3d:
                md.bundle_x, md.bundle_y, md.bundle_z = (
                    float(v) for v in positions[i])
            data.append(md)
        uvtrack.write(os.path.join(folder, name), data, version=4)
    scene, attrs = sg.bake(device=device)
    xy = evaluate(scene, attrs, torch.arange(frames, device=device)).point_xy
    return ((xy.cpu().numpy() + 0.5) * np.array(HD, np.float64))


def _camera_path_errors(solved, camera, align):
    """The largest position and rotation (degrees) error of a camera path
    (tx..rz per frame, rotate order XYZ) against the truth; with align
    after the similarity transform that best maps its positions onto the
    truth's (Umeyama's least squares), whose scale comes back too."""
    from mayamatchmovesolver_torch.core.transform import (
        euler_to_rotation_matrix,
    )

    def poses(channels):
        ch = {k: torch.as_tensor(np.asarray(channels[k], np.float64))
              for k in CAMERA_OFFSET}
        return (torch.stack([ch["tx"], ch["ty"], ch["tz"]], -1).numpy(),
                euler_to_rotation_matrix(ch["rx"], ch["ry"], ch["rz"],
                                         0).numpy())

    (p_s, r_s), (p_t, r_t) = poses(solved), poses(camera)
    rot, scale, shift = np.eye(3), None, np.zeros(3)
    if align:
        a, b = p_s - p_s.mean(0), p_t - p_t.mean(0)
        u, sig, vt = np.linalg.svd(b.T @ a)
        d = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
        rot = u @ d @ vt
        scale = float(np.trace(np.diag(sig) @ d) / (a ** 2).sum())
        shift = p_t.mean(0) - scale * rot @ p_s.mean(0)
    p_s = (1.0 if scale is None else scale) * p_s @ rot.T + shift
    # The angle of R_s^T R_t from its distance to the identity.
    dr = np.swapaxes(rot @ r_s, 1, 2) @ r_t - np.eye(3)
    angle = 2.0 * np.arcsin(np.minimum(
        1.0, np.linalg.norm(dr, axis=(1, 2)) / (2.0 * np.sqrt(2.0))))
    return (float(np.abs(p_s - p_t).max()), float(np.degrees(angle).max()),
            scale)


def _cli(tag, device, *argv):
    """One verb of the port's CLI in this process, on `device`: returns
    (its stdout lines, its wall seconds with the device synchronized).
    A verb that stops or exits non-zero fails the path."""
    import contextlib
    import io

    from mayamatchmovesolver_torch import cli

    out = io.StringIO()
    _sync(device)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv] + ["--device", str(device)])
    except SystemExit as exc:
        raise AssertionError("%s %s stopped: %s" % (tag, argv[0], exc))
    _sync(device)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    print("%s %s: exit %d, %.3f s; %s" % (
        tag, argv[0], rc, seconds, lines[-1] if lines else "no output"))
    if rc != 0:
        raise AssertionError("%s %s exited %d: %s" % (tag, argv[0], rc,
                                                       lines))
    return lines, seconds


def drive_cli(device, folder, frames=FRAMES, bundles=BUNDLES, size=HD):
    """The port's command line on `device` in `folder`, as a pipeline
    runs it: the shot's tracks solved from nothing (camera-solve), the
    camera refined per frame and by the Schur BA (solve) from an initial
    camera, the true bundles reprojected through the solved camera, the
    lens written as ST-map EXRs in both directions (lensdistort, the
    kernel on a CUDA device) and a plate warped through the file's map
    and through the lens (image-warp).  Holds each to its limits and
    returns {verb: wall seconds}."""
    import json
    import os

    from mayamatchmovesolver_torch.io import exr

    tag = "[14 cli]"
    join = functools.partial(os.path.join, folder)
    truth_px = write_shot_tracks(device, folder, frames, bundles)
    camera, positions = shot(frames, bundles)
    seconds = {}

    _, seconds["camera-solve"] = _cli(
        tag, device, "camera-solve", "--markers", join("tracks.uv"),
        "--output", join("sfm.json"))
    with open(join("sfm.json")) as f:
        sfm = json.load(f)
    solved, valid = (sum(sfm["camera"]["frame_solved"]),
                     sum(sfm["points"]["valid"]))
    print("%s camera-solve: %d/%d frames solved, %d/%d points valid" % (
        tag, solved, frames, valid, bundles))
    if solved != frames or valid != bundles:
        raise AssertionError("%s camera-solve missed frames or points" % tag)

    with open(join("init.json"), "w") as f:
        json.dump({"frames": list(range(1, frames + 1)), "camera": {
            ch: (camera[ch] + CAMERA_OFFSET[ch]).tolist()
            for ch in CAMERA_OFFSET}}, f)
    for name, extra in (("per-frame", []),
                        ("ba_schur", ["--solver-type", "ba_schur"])):
        out = join("solved_%s.json" % name)
        lines, seconds["solve " + name] = _cli(
            tag, device, "solve", "--markers", join("tracks_3d.uv"),
            "--camera", join("init.json"), "--output", out, *extra)
        values = dict(line.split("=", 1) for line in lines if "=" in line
                      and not line.startswith("error_per_frame="))
        with open(out) as f:
            solved = json.load(f)["camera"]
        # The per-frame solve keeps the bundles, so its camera is the
        # truth's; the BA frees them, and its scene is the truth's up to
        # one similarity transform (the gauge that no bundle pins down).
        translate, rotate, scale = _camera_path_errors(
            solved, camera, align=name == "ba_schur")
        print("%s solve %s: success=%s, %s iterations, error %s -> %s px; "
              "camera within %.3g units and %.3g degrees of the truth%s" % (
                  tag, name, values.get("success"),
                  values.get("iteration_num"), values.get("error_initial"),
                  values.get("error_final"), translate, rotate,
                  "" if scale is None else
                  " after the similarity (scale %.6f) that best maps it "
                  "there" % scale))
        if (values.get("success") != "1"
                or not float(values["error_final"]) <= ERROR_FINAL_TOL_PX
                or not translate <= PERFRAME_TRANSLATE_TOL
                or not rotate <= PERFRAME_ROTATE_TOL_DEG):
            raise AssertionError("%s solve %s missed its limits" % (tag,
                                                                    name))

    with open(join("points.json"), "w") as f:
        json.dump(positions.tolist(), f)
    _, seconds["reproject"] = _cli(
        tag, device, "reproject", "--camera", join("solved_per-frame.json"),
        "--points", join("points.json"), "--space", "pixels", "--output",
        join("reprojected.json"))
    with open(join("reprojected.json")) as f:
        got = np.asarray(json.load(f)["points"])
    diff = float(np.abs(got - truth_px).max())
    print("%s reproject: %s pixels, max|diff vs the true tracks| %.3g px" % (
        tag, got.shape, diff))
    if got.shape != truth_px.shape or not diff <= ERROR_FINAL_TOL_PX:
        raise AssertionError("%s reproject left the tracks" % tag)

    lens = ("--distortion", DISTORTION, "--width", size[0], "--height",
            size[1])
    for direction in ("distort", "undistort"):
        _, seconds["lensdistort " + direction] = _cli(
            tag, device, "lensdistort", *lens, "--direction", direction,
            "--output", join("st_%s.exr" % direction))

    rng = np.random.RandomState(6)
    plate = rng.uniform(0.0, 1.0, (size[1], size[0], 3)).astype(np.float32)
    exr.write_pixels(join("plate.exr"), plate)
    _, seconds["image-warp --stmap"] = _cli(
        tag, device, "image-warp", join("plate.exr"), "--stmap",
        join("st_distort.exr"), "--output", join("warp_map.exr"))
    _, seconds["image-warp lens"] = _cli(
        tag, device, "image-warp", join("plate.exr"), "--distortion",
        DISTORTION, "--output", join("warp_lens.exr"))
    through_map, _ = exr.read_pixels(join("warp_map.exr"))
    through_lens, _ = exr.read_pixels(join("warp_lens.exr"))
    diff = float(np.abs(through_map - through_lens).max())
    moved = float(np.abs(through_lens[..., :3] - plate).mean())
    print("%s image-warp: through the file's map and through the lens "
          "max|diff| %.3g, mean|warped - plate| %.3g" % (tag, diff, moved))
    if (through_map.shape != (size[1], size[0], 4) or not diff <= TOL
            or not moved > 1e-3):
        raise AssertionError("%s the two warps disagree" % tag)

    # The module entry point, in a process of its own.
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mayamatchmovesolver_torch.cli",
         "lensdistort", *map(str, lens), "--output", join("st_module.exr"),
         "--device", str(device)],
        cwd=here, env=env, capture_output=True, text=True, timeout=300)
    seconds["python -m ... lensdistort"] = time.perf_counter() - t0
    files = []
    for name in ("st_distort.exr", "st_module.exr"):
        if os.path.exists(join(name)):
            with open(join(name), "rb") as f:
                files.append(f.read())
    same = proc.returncode == 0 and len(files) == 2 and files[0] == files[1]
    print("%s python -m mayamatchmovesolver_torch.cli lensdistort: exit %d, "
          "%.3f s (with interpreter start), file identical to the "
          "in-process one: %s" % (tag, proc.returncode,
                                  seconds["python -m ... lensdistort"], same))
    if not same:
        raise AssertionError("%s the module entry point failed: %s" % (
            tag, proc.stderr[-2000:]))
    return seconds


def phase_cli(device):
    """The CLI path on the card in a temporary folder, then each
    lensdistort EXR read back and held against the plain version of the
    same lens, and one HD map's EXR write and read timed."""
    import tempfile

    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.io import exr
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    tag = "[14 cli]"
    with tempfile.TemporaryDirectory() as folder:
        seconds = drive_cli(device, folder)
        f32 = dict(device=device, dtype=torch.float32)
        model = models.TdeClassic.create(distortion=DISTORTION, **f32)
        fb = models.FilmBack.create(width_cm=3.6, height_cm=2.4, **f32)
        for direction in ("distort", "undistort"):
            path = "%s/st_%s.exr" % (folder, direction)
            t0 = time.perf_counter()
            image, header = exr.read_pixels(path)
            read_s = time.perf_counter() - t0
            plain = stmap_mod.stmap_torch(model, fb, HD[0], HD[1], direction,
                                          device=device).cpu().numpy()
            diff = float(np.abs(image - plain).max())
            print("%s lensdistort %s EXR read back %s: max|diff vs plain| "
                  "%.3g" % (tag, direction, image.shape, diff))
            if image.shape != (HD[1], HD[0], 4) or not diff <= TOL:
                raise AssertionError("%s bad %s EXR" % (tag, direction))
        t0 = time.perf_counter()
        exr.write_pixels("%s/again.exr" % folder, image)
        write_s = time.perf_counter() - t0
        print("%s one %dx%d float32 RGBA ST map as ZIP EXR (%s): write %.3f "
              "s, read %.3f s" % (tag, HD[0], HD[1], header["compression"],
                                  write_s, read_s))
    print("%s verb wall seconds: %s" % (tag, json.dumps(seconds)))


def tools_graph(device):
    """The lensed shot for the tools: its camera's film offsets animated
    (zeros, so center-2D writes them frame by frame) and its scale
    channels animated (ones, so a reparent under an animated transform
    may write them)."""
    zeros, ones = np.zeros(FRAMES), np.ones(FRAMES)
    return shot_graph(device, lens=True, lens_offset_x_mm=zeros,
                      lens_offset_y_mm=zeros, sx=ones, sy=ones, sz=ones)


def _px(a, b):
    """The largest marker-space difference in pixels of the plate."""
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max()) * (
        HD[0])


def _evaluated(sg, device, frames=None):
    from mayamatchmovesolver_torch.scene import evaluate

    scene, attrs = sg.bake(device=device)
    fi = torch.arange(FRAMES, device=device) if frames is None else (
        torch.as_tensor(frames, device=device))
    return scene, attrs, evaluate(scene, attrs, fi)


def _check(tag, what, value, limit, above=False):
    print("%s %s %.3g (%s %.3g)" % (tag, what, value,
                                    "above" if above else "limit", limit))
    if not (value > limit if above else value <= limit):
        raise AssertionError("%s %s %g, limit %g" % (tag, what, value,
                                                     limit))


def _camera_path_length(ev):
    path = ev.cam_world[0, :, :3, 3]
    return float(torch.linalg.vector_norm(path[1:] - path[:-1],
                                          dim=-1).sum())


def tools_screen_space(device, tag="[15 tools screen space]"):
    """The motion trail of every bundle equals the engine's reprojection;
    the screen-space rig bake and unbake return the bundles."""
    from mayamatchmovesolver_torch.tools import screenspace

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    scene, attrs, ev = _evaluated(sg, device)
    fi = torch.arange(FRAMES, device=device)
    index = torch.as_tensor([b.index for b in bnds], device=device)
    xy, depth = screenspace.motion_trail(scene, attrs, fi, index)
    _check(tag, "motion trail vs evaluate, px", _px(xy, ev.point_xy),
           TOOLS_PX_TOL)
    rig = screenspace.screen_space_rig_bake(scene, attrs, fi, index)
    world = screenspace.screen_space_rig_unbake(
        scene, attrs, fi, rig["screen_x"], rig["screen_y"], rig["depth"])
    length = _camera_path_length(ev)
    _check(tag, "rig bake/unbake vs world, of the camera path",
           float((world - ev.bnd_world_point).abs().max()) / length,
           TOOLS_WORLD_RTOL)


def tools_center(device, tag="[15 tools center 2d]"):
    """Center 2D on bundle 0 over every frame: the animated film
    offsets put it at the image centre."""
    from mayamatchmovesolver_torch.tools import centertwodee

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    _, _, ev = _evaluated(sg, device)
    target = ev.bnd_world_point[0, 0].cpu().numpy()
    _check(tag, "bundle 0 before, px", _px(ev.point_xy[0], 0.0), 10.0,
           above=True)
    off_x, off_y = centertwodee.apply_center(
        sg, cam, np.arange(FRAMES), target, device=device)
    _check(tag, "offset x spread over the frames, mm", float(np.ptp(off_x)),
           1e-3, above=True)
    _, _, ev = _evaluated(sg, device)
    _check(tag, "bundle 0 after, px", _px(ev.point_xy[0], 0.0),
           TOOLS_PX_TOL)


def _world_xy(sg, device):
    _, _, ev = _evaluated(sg, device)
    return ev.tfm_world, ev.point_xy, _camera_path_length(ev)


def tools_reparent(device, tag="[15 tools reparent]"):
    """The camera (animated channels) under an animated transform, the 64
    bundles (static channels) under a static, rotated and offset one,
    then all back to the world: world matrices and reprojections kept."""
    from mayamatchmovesolver_torch.tools import reparent

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    t = np.linspace(0.0, 1.0, FRAMES)
    rig = sg.create_transform(
        "rig", tx=0.5 * t, ty=-0.2 * t, tz=0.3 * np.sin(4.0 * t),
        rx=3.0 * t, ry=-6.0 * t, rz=2.0 * np.sin(3.0 * t),
        sx=np.ones(FRAMES), sy=np.ones(FRAMES), sz=np.ones(FRAMES))
    base = sg.create_transform("base", tx=1.0, ty=-0.5, tz=2.0, rx=10.0,
                               ry=-20.0, rz=5.0)
    world0, xy0, length = _world_xy(sg, device)
    nodes = [cam.index] + [b.index for b in bnds]
    for label, cam_parent, bnd_parent in (("under the rigs", rig, base),
                                          ("back to the world", None, None)):
        reparent.reparent(sg, cam, cam_parent, device=device)
        for b in bnds:
            reparent.reparent(sg, b, bnd_parent, device=device)
        world, xy, _ = _world_xy(sg, device)
        _check(tag, "%s: world matrices, of the camera path" % label,
               float((world[nodes] - world0[nodes]).abs().max()) / length,
               TOOLS_WORLD_RTOL)
        _check(tag, "%s: reprojection, px" % label, _px(xy, xy0),
               TOOLS_PX_TOL)


def tools_origin_and_scale(device, tag="[15 tools origin frame, scale]"):
    """The camera at frame 60 to the origin with the scene scaled by 2,
    then the scene scaled by 0.5: the reprojections are kept."""
    from mayamatchmovesolver_torch.tools import originframe, scaleadjust

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    _, xy0, _ = _world_xy(sg, device)
    originframe.set_camera_origin_frame(
        sg, cam, origin_frame_index=TOOLS_ORIGIN_FRAME,
        scene_scale=TOOLS_SCENE_SCALE, device=device)
    world, xy, _ = _world_xy(sg, device)
    eye = torch.eye(4, dtype=world.dtype, device=world.device)
    _check(tag, "camera at frame %d vs identity" % TOOLS_ORIGIN_FRAME,
           float((world[cam.index, TOOLS_ORIGIN_FRAME] - eye).abs().max()),
           TOOLS_IDENTITY_TOL)
    _check(tag, "origin frame: reprojection, px", _px(xy, xy0),
           TOOLS_PX_TOL)
    scaleadjust.apply_scene_scale(sg, TOOLS_RESCALE, device=device)
    _, xy, _ = _world_xy(sg, device)
    _check(tag, "scene scale: reprojection, px", _px(xy, xy0),
           TOOLS_PX_TOL)


def tools_mesh(centre, right, up, half, quads=TOOLS_MESH_QUADS):
    """A square grid of quads x quads on the plane through `centre`
    spanned by `right` and `up` (numpy float64), two triangles a quad."""
    side = np.linspace(-half, half, quads + 1)
    s, t = np.meshgrid(side, side)
    vertices = (centre + s.reshape(-1, 1) * right
                + t.reshape(-1, 1) * up)
    n = quads + 1
    a = (np.arange(quads)[:, None] * n + np.arange(quads)[None, :]).ravel()
    triangles = np.concatenate([
        np.stack([a, a + 1, a + n + 1], -1),
        np.stack([a, a + n + 1, a + n], -1)])
    return vertices, triangles


def tools_raycast(device, tag="[15 tools ray-cast]"):
    """The 64 markers' rays at frames 0, 60 and 119 onto a 131,072-
    triangle plane at the bundles' median depth: every ray hits, on the
    plane, at the closed-form ray-plane point, reprojecting onto its
    marker; a copy behind the camera gets no hit; the bundles move to
    the frame-60 hits.  Returns (ms of one call, peak device bytes)."""
    from mayamatchmovesolver_torch.scene import evaluate
    from mayamatchmovesolver_torch.tools import raycast, screenspace

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    scene, attrs, ev = _evaluated(sg, device)
    pose = ev.cam_world[0, TOOLS_ORIGIN_FRAME].double().cpu().numpy()
    eye, right, up, forward = pose[:3, 3], pose[:3, 0], pose[:3, 1], -pose[
        :3, 2]
    depths = (ev.bnd_world_point[:, TOOLS_ORIGIN_FRAME].double().cpu()
              .numpy() - eye) @ forward
    depth = float(np.median(depths))
    centre = eye + depth * forward
    meshes = {}
    for side, c in (("front", centre), ("behind", eye - depth * forward)):
        v, tri = tools_mesh(c, right, up, TOOLS_MESH_HALF * depth)
        meshes[side] = (torch.as_tensor(v, dtype=torch.float32,
                                        device=device),
                        torch.as_tensor(tri, device=device))
    print("%s mesh: %d triangles at depth %.3f" % (
        tag, meshes["front"][1].shape[0], depth))
    timed = {}
    for frame in TOOLS_RAY_FRAMES:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t0 = time.perf_counter()
        hits, ok = raycast.raycast_markers_to_mesh(scene, attrs, frame,
                                                   *meshes["front"])
        _sync(device)
        timed[frame] = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)
        _check(tag, "frame %d: rays that miss" % frame,
               float((~ok).sum()), 0)
        h = hits.double().cpu().numpy()
        _check(tag, "frame %d: distance off the plane" % frame,
               float(np.abs((h - centre) @ forward).max()), TOOLS_RAY_TOL)
        o, d = (x[:, 0].double().cpu().numpy()
                for x in raycast.marker_rays(scene, attrs, [frame]))
        t = ((centre - o) @ forward) / (d @ forward)
        _check(tag, "frame %d: hits vs closed-form ray-plane" % frame,
               float(np.abs(o + t[:, None] * d - h).max()), TOOLS_RAY_TOL)
        ev1 = evaluate(scene, attrs, torch.as_tensor([frame], device=device))
        xy, _ = screenspace.world_to_screen(ev1, hits[:, None, :])
        _check(tag, "frame %d: hits reprojected vs markers, px" % frame,
               _px(xy, ev1.marker_xy), TOOLS_PX_TOL)
        _, behind = raycast.raycast_markers_to_mesh(scene, attrs, frame,
                                                    *meshes["behind"])
        _check(tag, "frame %d: hits on the mesh behind" % frame,
               float(behind.sum()), 0)
    print("%s raycast_markers_to_mesh ms (64 rays x %d triangles): %s; "
          "peak device memory %.1f MiB" % (
              tag, meshes["front"][1].shape[0],
              json.dumps({f: round(ms, 3) for f, ms in timed.items()}),
              peak / 2**20))
    want = raycast.raycast_markers_to_mesh(scene, attrs, TOOLS_ORIGIN_FRAME,
                                           *meshes["front"])[0]
    hit = raycast.apply_raycast_bundles(sg, TOOLS_ORIGIN_FRAME,
                                        *meshes["front"], device=device)
    _check(tag, "apply: bundles not moved", float((~hit).sum()), 0)
    _, _, ev = _evaluated(sg, device, [TOOLS_ORIGIN_FRAME])
    _check(tag, "apply: bundles vs the hits",
           float((ev.bnd_world_point[:, 0] - want).abs().max()),
           TOOLS_RAY_TOL)
    return timed[TOOLS_ORIGIN_FRAME], peak


def tools_deform(device, tag="[15 tools deform]"):
    """The lens applied to every track, then removed."""
    from mayamatchmovesolver_torch.models import scenelens
    from mayamatchmovesolver_torch.scene import evaluate
    from mayamatchmovesolver_torch.tools import deformmarker

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    scene, attrs, ev = _evaluated(sg, device)
    lens = scenelens.bake_scene_lens(sg, device=device)
    fi = torch.arange(FRAMES, device=device)
    deformed = deformmarker.deform_markers(scene, attrs, lens, fi,
                                           direction="distort")
    moved = evaluate(scene, deformed, fi).marker_xy
    _check(tag, "deform moved the tracks, px", _px(moved, ev.marker_xy),
           TOOLS_MIN_DEFORM_PX, above=True)
    restored = deformmarker.remove_marker_deform(scene, deformed, lens, fi)
    _check(tag, "deform then remove vs the tracks, px",
           _px(evaluate(scene, restored, fi).marker_xy, ev.marker_xy),
           TOOLS_PX_TOL)


def _track(sg, marker):
    return np.stack([np.asarray(sg.get_value(marker.attr(ch)), np.float64)
                     for ch in ("tx", "ty")], -1)


def tools_markers_and_files(device, folder, tag="[15 tools markers]"):
    """Average, duplicate, convert and reproject markers against their
    closed forms; copy and paste the 64 markers; the camera file; the
    deviation files of a solve of the shot."""
    from mayamatchmovesolver_torch.io import camerafile
    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.tools import (
        copypastemarker,
        deviation,
        markertools,
        screenspace,
    )

    sg, cam, bnds, mkrs, raw = tools_graph(device)
    avg = markertools.create_average_marker(sg, mkrs[:4], "avg",
                                            device=device)
    _check(tag, "average of 4 vs their mean, px",
           float(np.abs(_track(sg, avg) - raw[:4].mean(0)).max()) * HD[0],
           TOOLS_PX_TOL)
    dup = markertools.duplicate_marker(sg, mkrs[5], device=device)
    _check(tag, "duplicate vs its marker, px",
           float(np.abs(_track(sg, dup) - raw[5]).max()) * HD[0],
           TOOLS_PX_TOL)

    scene, attrs, ev = _evaluated(sg, device)
    fi = torch.arange(FRAMES, device=device)
    xy, behind = markertools.marker_from_transform(scene, attrs, fi,
                                                   bnds[7].index)
    # Closed form, float64 on the host: the pinhole through the film
    # back's width (horizontal fit), y scaled by the plate's aspect.
    cam_world = ev.cam_world[0].double().cpu().numpy()
    point = np.append(ev.bnd_world_point[7, 0].double().cpu().numpy(), 1.0)
    p = np.einsum("fij,j->fi", np.linalg.inv(cam_world), point)
    scale = FOCAL / 36.0 / -p[:, 2]
    want = np.stack([p[:, 0] * scale, p[:, 1] * scale * HD[0] / HD[1]], -1)
    _check(tag, "marker from transform vs the pinhole, px",
           _px(xy.double().cpu(), want), TOOLS_PX_TOL)
    if bool(behind.any()):
        raise AssertionError("%s bundle 7 behind the camera" % tag)

    frame = 30
    new = markertools.reproject_bundle(scene, attrs, fi, 9,
                                       frame_for_depth=frame)
    ev1 = evaluate(scene, attrs, torch.as_tensor([frame], device=device))
    new_xy, new_depth = screenspace.world_to_screen(
        ev1, torch.as_tensor(new, device=device))
    _, old_depth = screenspace.world_to_screen(ev1, ev1.bnd_world_point[9])
    _check(tag, "reprojected bundle vs its marker ray, px",
           _px(new_xy[0], ev1.marker_xy[9, 0]), TOOLS_PX_TOL)
    _check(tag, "reprojected bundle's depth change, relative",
           float(abs(new_depth[0] / old_depth[0] - 1.0)), 1e-5)

    text = copypastemarker.copy_markers_to_string(sg, mkrs)
    sg2 = SceneGraph(frame_range=(1, FRAMES), dtype=np.float32)
    cam2 = sg2.create_camera("cam2", render_width=HD[0],
                             render_height=HD[1])
    pasted = copypastemarker.paste_markers(sg2, cam2, text)
    if len(pasted) != len(mkrs):
        raise AssertionError("%s pasted %d markers" % (tag, len(pasted)))
    _check(tag, "%d pasted tracks vs copied, px" % len(pasted),
           max(float(np.abs(_track(sg2, m2) - _track(sg, m)).max())
               for (m2, _), m in zip(pasted, mkrs)) * HD[0],
           TOOLS_PX_TOL)

    path = "%s/cam%s" % (folder, camerafile.EXT)
    camerafile.write_camera(path, cam, attrs, sg.frame_range,
                            image={"width": HD[0], "height": HD[1]})
    sg3 = SceneGraph(frame_range=(1, FRAMES), dtype=np.float32)
    cam3 = camerafile.create_camera_from_file(sg3, path)
    bnd3 = sg3.create_bundle("b")
    sg3.create_marker("m", camera=cam3, bundle=bnd3)
    _, _, ev3 = _evaluated(sg3, device)
    _check(tag, "camera file: camera matrices at %d frames" % FRAMES,
           float((ev3.cam_world[0] - ev.cam_world[0]).abs().max()),
           TOOLS_IDENTITY_TOL)
    _check(tag, "camera file: projection matrices",
           float((ev3.cam_proj[0] - ev.cam_proj[0]).abs().max()),
           TOOLS_IDENTITY_TOL)

    _, result, _, _ = solve_shot(device)
    stats = deviation.deviation_stats(result)
    deviation.write_deviation_json("%s/deviation.json" % folder, result)
    frames, names = deviation.write_deviation_csv(
        "%s/deviation.csv" % folder, result)
    with open("%s/deviation.json" % folder) as f:
        written = json.load(f)["stats"]
    finite = [n for n, v in written.items()
              if np.isfinite(v["average"]) and np.isfinite(v["maximum"])]
    print("%s deviation of a solve of the shot: %d markers, %d frames, "
          "worst average %.3g px" % (
              tag, len(finite), len(frames),
              max(v["average"] for v in stats.values())))
    if len(finite) != BUNDLES or len(names) != BUNDLES:
        raise AssertionError("%s deviation statistics of %d markers" % (
            tag, len(finite)))


def phase_tools(device):
    """The artist tools on the shot, each step timed on the host clock
    with the device synchronized, then the lens's ST-map export (through
    the kernel on the card).  Returns the step seconds."""
    import tempfile

    seconds = {}

    def step(name, fn, *args):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(device, *args)
        _sync(device)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    step("screen space", tools_screen_space)
    step("center 2d", tools_center)
    step("reparent", tools_reparent)
    step("origin frame, scale", tools_origin_and_scale)
    ray_ms, peak = step("ray-cast", tools_raycast)
    step("deform", tools_deform)
    with tempfile.TemporaryDirectory() as folder:
        step("markers and files", tools_markers_and_files, folder)
    if torch.device(device).type == "cuda":
        step("export", lambda d: _check_export("[15 tools export]",
                                               DISTORTION, d))
    print("[15 tools] step wall seconds: %s; ray-cast %.3f ms a call, peak "
          "%.1f MiB" % (json.dumps(seconds), ray_ms, peak / 2**20))
    return seconds


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    device = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    checked = phase_kernel_vs_plain(device)

    # Each main path runs with the launch counts set to 0 just before it
    # and read just after.  Every path exports through the ST-map kernel;
    # the stack path runs its layer variant too.
    wrappers = {"stmap": stmap_mod.stmap_cuda,
                "stmap_layer": stmap_mod.stmap_layer_cuda}
    launches = {kernel: {} for kernel in wrappers}
    for name, path in (("dense", lambda: phase_main_path(device)),
                       ("ba", lambda: phase_ba_path(device)),
                       ("production", lambda: _check_export(
                           "[8 production export]", phase_production(device),
                           device)),
                       ("per-frame", lambda: phase_per_frame(device)),
                       ("hooks", lambda: phase_hooks_and_checkpoints(device)),
                       ("stack", lambda: phase_stack_and_warp(
                           device, DISTORTION)),
                       ("camera", lambda: phase_camera(device)),
                       ("strategy", lambda: phase_strategy(device)),
                       ("cli", lambda: phase_cli(device)),
                       ("tools", lambda: phase_tools(device))):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        made = path()
        for kernel, wrapper in wrappers.items():
            launches[kernel][name] = wrapper.launches
        print("[%s] launches on the %s path: stmap_cuda %d, "
              "stmap_layer_cuda %d (path %.1f s)" % (
                  name, name, launches["stmap"][name],
                  launches["stmap_layer"][name], time.perf_counter() - t0))
        needed = ("stmap", "stmap_layer") if name == "stack" else ("stmap",)
        # The CLI path's two lensdistort calls and its lens warp launch the
        # kernel in this process.
        least = 2 if name == "cli" else 1
        for kernel in needed:
            if launches[kernel][name] < least:
                raise AssertionError("the %s path launched the %s kernel "
                                     "%d times, fewer than %d" % (
                                         name, kernel,
                                         launches[kernel][name], least))
        if name == "dense":
            phase_profile(device)
        if name == "ba":
            profile_ba_shot(device)
        if name == "stack":
            time_stack_and_warp(device, *made)
        if name == "camera":
            profile_camera_bootstrap(device, *made)

    print(json.dumps({"kernels": [{
        "name": kernel, "route": "cuda", "source": STMAP_SOURCE,
        "replaces": replaces, "launches": sum(launches[kernel].values()),
        "max_abs_err": checked[kernel]["max_abs_err"],
        "ms": checked[kernel]["ms"],
        "plain_ms": checked[kernel]["plain_ms"],
        "bound_ms": checked[kernel]["bound_ms"],
        "bound_by": checked[kernel]["bound_by"],
        # No single PyTorch call computes a lens map.
        "library_ms": None,
    } for kernel, replaces in (("stmap", STMAP_REPLACES),
                               ("stmap_layer", STMAP_LAYER_REPLACES))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
