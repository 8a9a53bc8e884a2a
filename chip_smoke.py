#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version, then drives the port's main path
once — a dense lens + focal + camera solve of a synthetic HD shot on
the card, and the ST-map export of the solved lens — and checks what
comes out.  Needs one CUDA device; it fails (non-zero exit, no result
line) without one, when the build or a launch fails, or when any check
misses.  It imports nothing of JAX.

    python3 chip_smoke.py

The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it names the card and its power limit, the one before
that is the kernel table as JSON.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel-vs-plain tolerance: float32 with IEEE division on both sides,
# operations in another order (the kernel contracts into FMAs).
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
# device a few hundred ulps.
FOCAL_TOL_MM, DISTORTION_TOL, ERROR_FINAL_TOL_PX = 1e-3, 1e-5, 1e-3

STMAP_SOURCE = "mayamatchmovesolver_torch/csrc/stmap.cu"
STMAP_REPLACES = "mayamatchmovesolver_tpu/ops/stmap.py:197"
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


def build_problem_inputs(device, frames=FRAMES, bundles=BUNDLES):
    """Scene, perturbed attributes, lens and solve attributes on `device`,
    float32, with marker tracks made by the port's own evaluate + lens
    distortion.  Returns (scene, attrs, lens, solve_attrs, codes)."""
    import dataclasses

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
    for i, (x, y, z) in enumerate(positions):
        bnd = sg.create_bundle("b%d" % i, tx=x, ty=y, tz=z)
        sg.create_marker("m%d" % i, camera=cam, bundle=bnd,
                         tx=np.zeros(frames), ty=np.zeros(frames))
    scene, attrs = sg.bake(device=device)
    lens = scenelens.bake_scene_lens(sg, device=device)
    fi = torch.arange(frames, device=device)
    tracks = scenelens.apply_scene_lens(
        lens, scene, attrs, fi, evaluate(scene, attrs, fi).point_xy,
        scene.mkr_cam_index, direction="distort")
    attrs = set_marker_screen_positions(scene, attrs, fi, tracks)

    codes = dict(focal=cam.attr("focal_length_mm").code // 2,
                 distortion=cam.attr("lens_distortion").code // 2)
    static = attrs.static_values.clone()
    anim = attrs.anim_values.clone()
    for ch, delta in CAMERA_OFFSET.items():
        anim[cam.attr(ch).code // 2] += delta
    static[codes["focal"]] += FOCAL_OFFSET
    static[codes["distortion"]] += DISTORTION_OFFSET
    attrs = dataclasses.replace(attrs, static_values=static,
                                anim_values=anim)
    solve_attrs = [cam.attr(ch) for ch in CAMERA_OFFSET]
    solve_attrs += [cam.attr("focal_length_mm"), cam.attr("lens_distortion")]
    return scene, attrs, lens, solve_attrs, codes


def solve_shot(device, frames=FRAMES, bundles=BUNDLES):
    """The dense solve of the shot on `device`.  Returns
    (attrs_out, result, codes, problem size)."""
    from mayamatchmovesolver_torch.solver import SolverOptions, solve

    scene, attrs, lens, solve_attrs, codes = build_problem_inputs(
        device, frames, bundles)
    options = SolverOptions(image_width=float(HD[0]))
    attrs_out, result = solve(scene, attrs, np.arange(frames), solve_attrs,
                              options, lens=lens)
    size = dict(parameters=len(result.solved_parameters),
                residuals=scene.num_markers * frames * 2)
    return attrs_out, result, codes, size


def export_stmaps(attrs_out, codes, device):
    """ST maps of the solved lens at HD, both directions."""
    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    distortion = float(attrs_out.static_values[codes["distortion"]])
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


def _raw_launch(model, fb, width, height, direction, device):
    """The kernel alone: the C entry point with its parameters packed
    once, as a no-argument call (no wrapper, no launch count)."""
    import ctypes

    from mayamatchmovesolver_torch import _kernels
    from mayamatchmovesolver_torch.models.base import (
        DISTORT_INVERSE_ITERATIONS,
    )
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    core_id, params = stmap_mod._kernel_params(model, fb, direction)
    out = torch.empty((height, width, 4), dtype=torch.float32, device=device)
    fn = _kernels.stmap_function()
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        err = fn(out.data_ptr(), width, height, core_id,
                 int(direction == "distort"), DISTORT_INVERSE_ITERATIONS,
                 params.ctypes.data_as(ctypes.c_void_p), stream)
        if err != 0:
            raise RuntimeError("stmap kernel launch failed: %d" % err)

    return launch


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


def phase_build():
    from mayamatchmovesolver_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build("stmap")
    _kernels.stmap_function()
    print("[2 build] %s in %.2f s" % (path.name, time.perf_counter() - t0))


def phase_kernel_vs_plain(device):
    """Every model and direction at HD and a ragged size; returns the
    largest difference and the HD timings of the export's case."""
    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    fb = models.FilmBack.create(width_cm=3.6, height_cm=2.4,
                                offset_x_cm=0.05, offset_y_cm=-0.02,
                                device=device, dtype=torch.float32)
    worst, timing = 0.0, None
    for name, params in MODEL_PARAMS.items():
        model = getattr(models, name).create(**params, device=device,
                                             dtype=torch.float32)
        for direction in ("distort", "undistort"):
            for w, h in (HD, RAGGED):
                got = stmap_mod.stmap_cuda(model, fb, w, h, direction,
                                           device=device)
                want = stmap_mod.stmap_torch(model, fb, w, h, direction,
                                             device=device)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                worst = max(worst, diff)
                line = "[3 kernel] %-28s %-9s %4dx%-4d max|diff| %.3g" % (
                    name, direction, w, h, diff)
                if (w, h) == HD:
                    ms = _cuda_ms(_raw_launch(model, fb, w, h, direction,
                                              device), launches=100)
                    call_ms = _cuda_ms(lambda: stmap_mod.stmap_cuda(
                        model, fb, w, h, direction, device=device))
                    plain_ms = _cuda_ms(lambda: stmap_mod.stmap_torch(
                        model, fb, w, h, direction, device=device))
                    line += ("  kernel %.4f ms  wrapper call %.4f ms  plain "
                             "%.4f ms" % (ms, call_ms, plain_ms))
                    if (name, direction) == ("TdeClassic", "distort"):
                        timing = (ms, plain_ms)
                print(line)
                if not diff <= TOL:
                    raise AssertionError(
                        "kernel disagrees with plain version: %s %s %dx%d "
                        "max|diff| %g > %g" % (name, direction, w, h, diff,
                                               TOL))
    return worst, timing


def phase_main_path(device):
    """The solve and the export, from the user's entry points."""
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    attrs_out, result, codes, size = solve_shot(device)
    solve_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    for line in result.as_key_value_strings():
        if not line.startswith("error_per_frame="):
            print("[4 solve] " + line)
    focal = float(attrs_out.static_values[codes["focal"]])
    distortion = float(attrs_out.static_values[codes["distortion"]])
    print("[4 solve] %d parameters, %d residuals; solve %.3f s (%.3f s "
          "with scene set-up); peak device memory %.1f MiB" % (
              size["parameters"], size["residuals"],
              result.timer.solve_seconds, solve_wall, peak / 2**20))
    print("[4 solve] focal %.6f mm (true %.1f, error %.3g), distortion "
          "%.8f (true %.2f, error %.3g)" % (
              focal, FOCAL, focal - FOCAL, distortion, DISTORTION,
              distortion - DISTORTION))
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

    model, fb, maps = export_stmaps(attrs_out, codes, device)
    torch.cuda.synchronize(device)
    for direction, image in maps.items():
        plain = stmap_mod.stmap_torch(model, fb, HD[0], HD[1], direction,
                                      device=device)
        diff = float((image - plain).abs().max())
        print("[5 export] %s ST map %s finite=%s max|diff vs plain| %.3g" % (
            direction, tuple(image.shape), bool(image.isfinite().all()),
            diff))
        if tuple(image.shape) != (HD[1], HD[0], 4) or not bool(
                image.isfinite().all()) or not diff <= TOL:
            raise AssertionError("bad %s ST map" % direction)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    device = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    worst, (ms, plain_ms) = phase_kernel_vs_plain(device)

    stmap_mod.stmap_cuda.launches = 0
    phase_main_path(device)
    launches = stmap_mod.stmap_cuda.launches
    print("[5 export] stmap_cuda launches on the main path: %d" % launches)
    if launches <= 0:
        raise AssertionError("the main path never launched the stmap kernel")

    phase_profile(device)

    print(json.dumps({"kernels": [{
        "name": "stmap", "route": "cuda", "source": STMAP_SOURCE,
        "replaces": STMAP_REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
