"""The port's CUDA kernels (the ST map from the pixel index and its
layer variant from a map), its Schur BA, its per-frame solve, its lens
stacks, its checkpoints, its robust relative pose, its from-scratch
camera solve, its Collection API, its command line (lensdistort,
reproject), its tools (ray-mesh intersection, screen-space rig bake,
reparent) and its frame-sharded solvers (with no process group and under
a one-rank NCCL group) on the card, a lens file's anamorphic map at
ALEXA LF open-gate size, the ST-map wrapper's spans and
counters there, the image warp's kernel (csrc/warp.cu) against the eager
warp on the card and the float64 warp on the CPU at 1e-6 (a float16
image through a float32 map too), a lens file's radial map at VENICE 2
8.6K size, the program's spans under a capture (operator records with no
device-side copy, holding the hand kernels launched inside them), the
two-layer lens stack of a radial calibration under a
classic layer with a half plate warped through it, the fused undistort
stack kernel bit-equal to a launch a layer, and the no-fallback rule.

This file imports nothing of jax, so it runs on a machine with a GPU and
no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch/test_torch_cuda.py

Without a CUDA device the card tests skip themselves and the dispatch
test checks that a CUDA request raises.  Kernel tolerance 2e-5: both
sides float32, in another operation order (the kernels divide nowhere).  BA
tolerance: parameters within 1e-5 of each tensor's largest entry, the
cost within 1e-3 relative (float32 on either side; on the CPU float32
and float64 part by 3e-7 and 1e-4 on this problem: the final cost is a
small difference of large terms).  Per-frame solve: camera channels
within 1e-4 of the CPU's (float32 on both; a 6-parameter pose from 8
exact points).
"""

import dataclasses

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.ops.stmap as t_stmap
import _torch_stmap_emulation as emulation
from _torch_stmap_models import MODELS, program_ranges, torch_model, weaker
from mayamatchmovesolver_torch.solver import ba as t_ba
from mayamatchmovesolver_torch.solver import checkpoint as t_checkpoint
from mayamatchmovesolver_torch.solver import lm as t_lm
from mayamatchmovesolver_torch.utils.profiler import counters

ATOL = 2e-5


def test_stmap_on_cuda_launches_the_kernel_or_raises():
    """No fallback: a CUDA device means the kernel or an exception,
    never a CPU result."""
    model, fb = torch_model("classic")
    launches = counters["stmap.launches"]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            t_stmap.stmap(model, fb, 64, 32, device="cuda")
        assert counters["stmap.launches"] == launches
        return
    out = t_stmap.stmap(model, fb, 64, 32, device="cuda")
    assert out.is_cuda
    assert counters["stmap.launches"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", list(MODELS))
def test_stmap_cuda_kernel_matches_plain_version(name, direction):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model(name, device="cuda")
    for width, height in ((200, 100), (1001, 333), (1920, 1080)):
        got = t_stmap.stmap_cuda(model, fb, width, height, direction,
                                 device="cuda")
        want = t_stmap.stmap_torch(model, fb, width, height, direction,
                                   device="cuda")
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), atol=ATOL,
            err_msg="%s/%s %dx%d" % (name, direction, width, height))


def _ba_problem(device, frames=12, bundles=10):
    """A float32 one-camera BA problem with classic distortion and focal
    in the border, observations made by the port's residual at the truth,
    started off it."""
    rng = np.random.RandomState(2)
    cam = np.zeros((frames, 6))
    cam[:, 0] = np.linspace(-3, 3, frames)
    cam[:, 1] = 1.0 + 0.5 * np.sin(np.linspace(0, 3, frames))
    cam[:, 2] = 4.0 + np.linspace(0, 2, frames)
    cam[:, 3] = np.linspace(-5, 5, frames)
    cam[:, 4] = np.linspace(-20, 20, frames)
    bnd = np.stack([rng.uniform(-3, 3, bundles), rng.uniform(-2, 2, bundles),
                    rng.uniform(-6, 0, bundles)], -1)
    kw = dict(weight=np.ones((bundles, frames)),
              mkr_bnd_index=np.arange(bundles), solve_focal=True,
              lens_model_type="tde_classic", lens_solve_names=["distortion"],
              device=device)
    truth = t_ba.make_ba_problem(
        marker_uv=np.zeros((bundles, frames, 2), np.float32), cam_params=cam,
        bnd_params=bnd, lens_params=dict(distortion=0.1), **kw)
    uv = -t_ba.ba_residuals(truth, truth.cam_params,
                            truth.bnd_params) / truth.image_width
    return t_ba.make_ba_problem(
        marker_uv=uv, cam_params=cam + rng.normal(0, 0.05, cam.shape),
        bnd_params=bnd + rng.normal(0, 0.05, bnd.shape),
        focal_length_mm=36.0, lens_params=dict(distortion=0.07), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
@pytest.mark.parametrize("assembly", ["ad", "analytic"])
def test_solve_ba_on_cuda_matches_cpu(assembly, linear_solver):
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    kw = dict(max_iterations=4, tau=0.1, eps1=0.0, eps2=0.0, eps3=0.0,
              linear_solver=linear_solver, cg_iterations=40,
              assembly=assembly)
    want = t_ba.solve_ba(_ba_problem("cpu"), **kw)
    got = t_ba.solve_ba(_ba_problem("cuda"), **kw)
    assert got.cam_params.is_cuda and got.cam_params.dtype == torch.float32
    assert int(got.iterations) == int(want.iterations) == 4
    for name in ("cam_params", "bnd_params", "shared_params"):
        a, b = getattr(got, name).cpu().numpy(), getattr(want, name).numpy()
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)


def _launches():
    return (counters["stmap.launches"], counters["stmap_layer.launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_stmap_stack_on_cuda_launches_the_kernel_once(direction):
    """A stack runs no eager PyTorch layer on the card: a distort stack's
    first layer is one stmap_cuda launch, every further 3DE layer one
    stmap_layer_cuda launch; an undistort stack of two 3DE layers is one
    launch from the pixel index; a Passthrough layer launches nothing;
    and the map equals the all-plain stack on the card."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.models import tde

    classic, fb = torch_model("classic", device="cuda")
    radial, _ = torch_model("radial_deg4", device="cuda")
    radial = type(radial)(**{k: v * 0.2 for k, v in vars(radial).items()})
    stack = [classic, radial]
    layer = int(direction == "distort")
    before = _launches()
    got = t_stmap.stmap(stack, fb, 640, 360, direction, device="cuda")
    assert _launches() == (before[0] + 1, before[1] + layer)
    got2 = t_stmap.stmap_stack(
        [tde.Passthrough(), classic, tde.Passthrough(), radial], fb, 640,
        360, direction, device="cuda")
    assert _launches() == (before[0] + 2, before[1] + 2 * layer)
    only = t_stmap.stmap_stack([tde.Passthrough()], fb, 640, 360, direction,
                               device="cuda")
    assert _launches() == (before[0] + 2, before[1] + 2 * layer)
    want = t_stmap.stmap_stack_torch(stack, fb, 640, 360, direction,
                                     device="cuda")
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (360, 640, 4)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)
    assert torch.equal(got, got2)
    assert torch.equal(only, t_stmap.stmap_torch(
        tde.Passthrough(), fb, 640, 360, direction, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", list(MODELS))
def test_stmap_layer_cuda_kernel_matches_plain_version(name, direction):
    """The layer variant, in place on an irregular map (a weaker lens's
    first layer, with values of its own in channels 2 and 3), against
    stmap_layer_torch."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model(name, device="cuda")
    names = list(MODELS)
    other, _ = torch_model(names[(names.index(name) + 1) % len(names)],
                           device="cuda")
    other = weaker(other, 0.3)
    for width, height in ((200, 100), (1001, 333), (1920, 1080)):
        source = t_stmap.stmap_cuda(other, fb, width, height, direction,
                                    device="cuda")
        source[..., 2:] = torch.as_tensor(
            np.random.RandomState(4).uniform(-1, 1, (height, width, 2)),
            dtype=torch.float32, device="cuda")
        work = source.clone()
        launches = counters["stmap_layer.launches"]
        got = t_stmap.stmap_layer_cuda(work, model, fb, direction)
        assert got is work
        assert counters["stmap_layer.launches"] == launches + 1
        want = t_stmap.stmap_layer_torch(source, model, fb, direction)
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), atol=ATOL,
            err_msg="%s/%s %dx%d" % (name, direction, width, height))
        assert torch.equal(got[..., 2:], source[..., 2:])


# A breathing 1.8x anamorphic's lens file on ALEXA LF open-gate plates
# (4448 x 3096 photosites on 36.70 x 25.54 mm), its last frame.
LF_ANAMORPHIC = """LD_3DE4_Anamorphic_Rescaled_Degree_4 {
 tde4_filmback_width_cm 3.67
 tde4_filmback_height_cm 2.554
 tde4_pixel_aspect 1.8
 Cx02_Degree_2 {{curve x1 -0.03 x2 -0.045 }}
 Cy02_Degree_2 {{curve x1 0.06 x2 0.08 }}
 Cx22_Degree_2 0.01
 Cy22_Degree_2 -0.015
 Cx04_Degree_4 0.004
 Cy04_Degree_4 0.008
 Cx24_Degree_4 -0.002
 Cy24_Degree_4 0.003
 Cx44_Degree_4 0.001
 Cy44_Degree_4 -0.001
 Lens_Rotation 0.15
 Squeeze_X 1
 Squeeze_Y 0.997
 Rescale 0.995
}
"""


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_stmap_cuda_anamorphic_core_at_alexa_lf_open_gate(direction):
    """The kernel's anamorphic core at 4448 x 3096 with pixel aspect 1.8,
    the rotation and the rescale, from a lens file's models_at (Python
    floats, the anamorphic cell's lens: one pack and one map launch, no
    host read), against the plain version of the same lens on the card
    in float32 and in float64; the same lens held in float64 tensors on
    the card gives the same map."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.io import lensfile

    layers = lensfile.parse_string(LF_ANAMORPHIC)
    models, fb = layers.models_at(2), layers.film_back()
    before = counters.copy()
    got = t_stmap.stmap(models, fb, 4448, 3096, direction, device="cuda")
    for key, n in (("host_reads", 0), ("stmap.launches", 1),
                   ("stmap.device_packs", 1)):
        assert counters[key] == before[key] + n, key
    assert got.shape == (3096, 4448, 4)
    for dtype in (torch.float32, torch.float64):
        want = t_stmap.stmap_torch(models[0], fb, 4448, 3096, direction,
                                   device="cuda", dtype=dtype)
        assert float((got - want).abs().max()) < ATOL, dtype
    identity = t_stmap.stmap_torch(models[0].__class__(), fb, 4448, 3096,
                                   direction, device="cuda")
    assert float((got - identity).abs().max()) > 1e-3
    on_card = [type(o)(**{k: torch.tensor(v, dtype=torch.float64,
                                          device="cuda")
                          for k, v in vars(o).items()})
               for o in (models[0], fb)]
    assert torch.equal(got, t_stmap.stmap_cuda(*on_card, 4448, 3096,
                                               direction, device="cuda"))


VENICE2_RADIAL = """LD_3DE4_Radial_Standard_Degree_4 {
 tde4_filmback_width_cm 3.59
 tde4_filmback_height_cm 2.4
 tde4_pixel_aspect 1
 Distortion_Degree_2 {{curve x1001 -0.03 x1002 -0.042 }}
 U_Degree_2 0.0008
 V_Degree_2 -0.0006
 Quartic_Distortion_Degree_4 {{curve x1001 0.004 x1002 0.006 }}
 U_Degree_4 0.0002
 V_Degree_4 -0.0002
 Phi_Cylindric_Direction 8
 B_Cylindric_Bending 0.003
}
"""


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_stmap_cuda_radial_core_at_venice2_full_frame(direction):
    """The kernel's radial core (with the cylindric extender) at 8640 x
    5760, from a lens file's models_at (Python floats: one pack and one
    map launch, no host read), against the plain version of the same
    lens on the card in float32 and in float64."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.io import lensfile

    layers = lensfile.parse_string(VENICE2_RADIAL)
    models, fb = layers.models_at(1002), layers.film_back()
    before = counters.copy()
    got = t_stmap.stmap(models, fb, 8640, 5760, direction, device="cuda")
    for key, n in (("host_reads", 0), ("stmap.launches", 1),
                   ("stmap.device_packs", 1)):
        assert counters[key] == before[key] + n, key
    assert got.shape == (5760, 8640, 4)
    for dtype in (torch.float32, torch.float64):
        want = t_stmap.stmap_torch(models[0], fb, 8640, 5760, direction,
                                   device="cuda", dtype=dtype)
        assert float((got - want).abs().max()) < ATOL, dtype
        del want
    identity = t_stmap.stmap_torch(models[0].__class__(), fb, 8640, 5760,
                                   direction, device="cuda")
    assert float((got - identity).abs().max()) > 1e-3


# The two-layer lens file of the benchmark's cell shot.stack_half_export:
# a static 3DE4 radial calibration under a breathing 3DE classic layer.
VENICE2_STACK = VENICE2_RADIAL.replace(
    "Distortion_Degree_2 {{curve x1001 -0.03 x1002 -0.042 }}",
    "Distortion_Degree_2 -0.036").replace(
    "Quartic_Distortion_Degree_4 {{curve x1001 0.004 x1002 0.006 }}",
    "Quartic_Distortion_Degree_4 0.005") + """LD_3DE_Classic_LD_Model {
 tde4_filmback_width_cm 3.59
 tde4_filmback_height_cm 2.4
 tde4_pixel_aspect 1
 Distortion {{curve x1001 -0.004 x1002 -0.012 }}
 Anamorphic_Squeeze 1
 Curvature_X 0
 Curvature_Y 0
 Quartic_Distortion 0.0006
}
"""


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_stmap_stack_of_radial_and_classic_layers_warps_half_plates(
        direction):
    """The stack cell's two layers from its lens file at 1080 x 720: one
    pack and one map launch from the pixel index a call, then one layer
    launch (distort) or none (undistort: the fused stack kernel), no host
    read; the map within 1e-6 of the CPU transcription of
    the kernels' arithmetic (_torch_stmap_emulation.emulated_stack) and
    within 2e-5 of the plain stack on the card; a half plate warped
    through it is one half launch, bit-equal to the eager warp."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.ops import warp as t_warp

    layers = lensfile.parse_string(VENICE2_STACK)
    assert [layer.model_type for layer in layers.layers] == [
        "tde_radial_std_deg4", "tde_classic"]
    fb = layers.film_back()
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    plate = torch.rand((720, 1080, 4), generator=g, device="cuda").half()
    for frame in (1001, 1002):
        models = layers.models_at(frame)
        before = counters.copy()
        got = t_stmap.stmap(models, fb, 1080, 720, direction, device="cuda")
        fused = int(direction == "undistort")
        for key, n in (("host_reads", 0), ("stmap.device_packs", 1),
                       ("stmap.launches", 1),
                       ("stmap_layer.launches", 1 - fused),
                       ("stmap.stack_launches", fused)):
            assert counters[key] == before[key] + n, (frame, key)
        plain = t_stmap.stmap_stack_torch(models, fb, 1080, 720, direction,
                                          device="cuda")
        emulated = emulation.emulated_stack(models, fb, 1080, 720,
                                            direction)
        warped = t_warp.warp_image(plate, got)
        assert counters["warp.half_launches"] == \
            before["warp.half_launches"] + 1
        eager = t_warp._bilinear_sample(plate, got[..., 0], got[..., 1])
        torch.cuda.synchronize()
        assert got.shape == (720, 1080, 4)
        assert float((got - plain).abs().max()) <= ATOL, frame
        assert float((got.cpu() - torch.as_tensor(emulated)).abs().max()) \
            <= 1e-6, frame
        assert warped.dtype == torch.float32
        assert torch.equal(warped, eager), frame
        radial_alone = t_stmap.stmap(models[:1], fb, 1080, 720, direction,
                                     device="cuda")
        assert float((got - radial_alone).abs().max()) > 1e-3


def _two_pass(layers, fb, width, height, start=None):
    """An undistort stack (layers in application order) a launch a layer
    through the single-layer entries: stmap_cuda for the first layer, or
    with `start` stmap_layer_cuda on a copy of that map, then
    stmap_layer_cuda for each further one."""
    if start is None:
        out = t_stmap.stmap_cuda(layers[0], fb, width, height, "undistort",
                                 device="cuda")
        layers = layers[1:]
    else:
        out = start.clone()
    for model in layers:
        t_stmap.stmap_layer_cuda(out, model, fb, "undistort")
    return out


def _fused(layers, fb, width, height, start=None):
    """The same stack in one call: from the pixel index by stmap_stack,
    from a copy of `start` by the wrapper's launch on that map; one pack
    and one fused launch, counted in stmap.stack_launches."""
    before = counters.copy()
    if start is None:
        out = t_stmap.stmap_stack(layers[::-1], fb, width, height,
                                  "undistort", device="cuda")
    else:
        out = start.clone()
        t_stmap._launch_packed(out, layers, fb, "undistort", False)
    assert counters["stmap.stack_launches"] == \
        before["stmap.stack_launches"] + 1
    assert counters["stmap.launches"] + counters["stmap_layer.launches"] \
        == before["stmap.launches"] + before["stmap_layer.launches"] + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [(a, b) for a in MODELS for b in MODELS])
def test_fused_undistort_stack_is_bit_equal_to_a_launch_a_layer(pair):
    """csrc/stmap.cu's stmap_stack_kernel for every ordered pair of the
    four models (and so every pair of cores) at a ragged 1921 x 1081,
    from the pixel index and from an irregular map whose channels 2 and
    3 hold other numbers: the map is the one the single-layer entries
    write a launch a layer, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    width, height = 1921, 1081
    layers = [weaker(torch_model(name, device="cuda")[0], 0.3)
              for name in pair]
    _, fb = torch_model("classic", device="cuda")
    start = t_stmap.stmap_cuda(weaker(torch_model("radial_deg4",
                                                  device="cuda")[0], 0.3),
                               fb, width, height, "undistort", device="cuda")
    start[..., 2:] = torch.rand((height, width, 2), device="cuda")
    for source in (None, start):
        got = _fused(layers, fb, width, height, source)
        want = _two_pass(layers, fb, width, height, source)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (pair, source is None)
        assert float((got - t_stmap.stmap_cuda(
            layers[0], fb, width, height, "undistort",
            device="cuda")).abs().max()) > 1e-4


@pytest.mark.cuda
def test_fused_undistort_stack_of_the_cell_is_bit_equal_at_size():
    """The stack cell's lens file at 8640 x 5760, undistort: the classic
    layer from the pixel index, then the radial one, in one fused launch,
    bit-equal to a launch a layer, at both frames of the file."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.io import lensfile

    layers = lensfile.parse_string(VENICE2_STACK)
    fb = layers.film_back()
    for frame in (1001, 1002):
        order = layers.models_at(frame)[::-1]
        got = _fused(order, fb, 8640, 5760)
        want = _two_pass(order, fb, 8640, 5760)
        torch.cuda.synchronize()
        assert torch.equal(got, want), frame
        del got, want


@pytest.mark.cuda
def test_stmap_layer_cuda_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model("classic", device="cuda")
    good = t_stmap.stmap_cuda(model, fb, 64, 32, device="cuda")
    launches = counters["stmap_layer.launches"]
    for bad, message in (
            (good.cpu(), "on a CUDA device"),
            (good.double(), "float32"),
            (good.transpose(0, 1), "contiguous"),
            (good[:, ::2], "contiguous"),
            (good[..., :3].contiguous(), r"\(H, W, 4\)"),
            (good.reshape(-1, 4), r"\(H, W, 4\)"),
            (good[:0], r"\(H, W, 4\)")):
        with pytest.raises(ValueError, match=message):
            t_stmap.stmap_layer_cuda(bad, model, fb)
    with pytest.raises(ValueError, match="direction"):
        t_stmap.stmap_layer_cuda(good, model, fb, "sideways")
    assert counters["stmap_layer.launches"] == launches
    kept = good.clone()
    t_stmap.stmap_layer_cuda(good, model, fb)
    torch.cuda.synchronize()
    assert counters["stmap_layer.launches"] == launches + 1
    assert not torch.equal(good, kept)


@pytest.mark.cuda
def test_stmap_spans_and_counters_on_cuda():
    """Under a capture with spans on, each CUDA call of the ST-map wrapper
    is a "stmap.call" holding its "stmap.launch": one counted pack a call,
    or a stack, whether the lens is held on the card or in CPU tensors
    (handed over by value), and no host read.  Each counts its map
    launches; a warp is one "warp.call" holding its "warp.launch"."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from mayamatchmovesolver_torch.ops import warp as t_warp
    from mayamatchmovesolver_torch.utils import profiler as t_profiler

    model, fb = torch_model("classic", device="cuda")
    radial, _ = torch_model("radial_deg4", device="cuda")
    host_model, host_fb = torch_model("classic")
    host_radial, _ = torch_model("radial_deg4")
    before = counters.copy()
    call = [("stmap.call", None), ("stmap.launch", "stmap.call")]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def captured(fn):
        with t_profiler.tracing(), profile(activities=activities) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, program_ranges(prof.events())

    def packs():
        return counters["stmap.device_packs"] - before["stmap.device_packs"]

    st_map, ranges = captured(lambda: t_stmap.stmap_cuda(
        model, fb, 64, 32, device="cuda"))
    assert ranges == call and packs() == 1
    _, ranges = captured(lambda: t_stmap.stmap_layer_cuda(
        st_map, radial, fb))
    assert ranges == call and packs() == 2
    _, ranges = captured(lambda: t_stmap.stmap_stack(
        [model, radial], fb, 64, 32, device="cuda"))
    assert ranges == call and packs() == 3
    _, ranges = captured(lambda: t_stmap.stmap_cuda(
        host_model, host_fb, 64, 32, device="cuda"))
    assert ranges == call and packs() == 4
    _, ranges = captured(lambda: t_stmap.stmap_layer_cuda(
        st_map, host_radial, host_fb))
    assert ranges == call and packs() == 5
    _, ranges = captured(lambda: t_stmap.stmap_stack(
        [host_model, host_radial], host_fb, 64, 32, device="cuda"))
    assert ranges == call and packs() == 6
    assert counters["host_reads"] == before["host_reads"]
    image = torch.rand(32, 64, 4, device="cuda")
    _, ranges = captured(lambda: t_warp.warp_image(image, st_map))
    assert ranges == [("warp.call", None), ("warp.launch", "warp.call")]
    assert counters["stmap.launches"] == before["stmap.launches"] + 4
    assert counters["stmap_layer.launches"] == (
        before["stmap_layer.launches"] + 4)


def _lens_fields(name, kind):
    """(model, film back) of MODELS[name] on the card with fields of one
    kind: "float32" or "float64" tensors, or "mixed": the model's fields
    in turn Python floats and float64 tensors, the film back Python
    floats but its width a float32 tensor."""
    if kind != "mixed":
        model, fb = torch_model(name, device="cuda")
        dtype = getattr(torch, kind)
        return tuple(type(o)(**{k: v.to(dtype) for k, v in vars(o).items()})
                     for o in (model, fb))
    model, fb = torch_model(name)
    model = type(model)(**{
        k: float(v) if i % 2 else v.to("cuda", torch.float64)
        for i, (k, v) in enumerate(vars(model).items())})
    fb = type(fb)(**{k: float(v) for k, v in vars(fb).items()})
    return model, dataclasses.replace(
        fb, film_back_width_cm=torch.tensor(
            fb.film_back_width_cm, dtype=torch.float32, device="cuda"))


def _within_one_ulp(got, want):
    """float32 arrays equal but for one unit in the last place."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    step = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return bool((np.abs(got - want) <= step).all())


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["pixels", "map"])
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", list(MODELS))
def test_device_pack_equals_the_host_pack(name, direction, source):
    """csrc/stmap.cu's pack kernel writes the 22 floats of its float64
    transcription on the host (_torch_stmap_emulation.pack_params), to
    within one float32 ulp, from float32, float64 and mixed fields, for
    the pixel index and the layer source."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    st_map = torch.zeros((1080, 1920, 4), device="cuda")
    size = (1920, 1080) if source == "pixels" else None
    for kind in ("float32", "float64", "mixed"):
        model, fb = _lens_fields(name, kind)
        _, want = emulation.kernel_params(model, fb, direction, size)
        params = torch.full((t_stmap._PARAM_COUNT,), float("nan"),
                            device="cuda")
        records = t_stmap._field_records(*t_stmap._lens_fields(fb, [model]),
                                         st_map.device, [])
        function, args = t_stmap._packed_launch_args(
            st_map, [model], direction, size is not None, records,
            params.data_ptr())
        assert function(*args) == 0
        got = params.cpu().numpy()
        assert _within_one_ulp(got, want), (kind, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", list(MODELS))
def test_device_packed_maps_match_plain_and_the_emulation(name, direction):
    """A lens held on the card: stmap_cuda and stmap_layer_cuda pack it
    there (one pack and one map launch a call, no host read) and give the
    plain version's map within 2e-5 and the CPU transcription of the
    kernels' arithmetic (_torch_stmap_emulation) within 1e-6, for
    float32, float64 and mixed fields, which hold the same numbers."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    names = list(MODELS)
    emulated = None
    for kind in ("float32", "float64", "mixed"):
        model, fb = _lens_fields(name, kind)
        other, _ = _lens_fields(names[(names.index(name) + 1) % 4], kind)
        other = weaker(other, 0.3)
        before = counters.copy()
        got = t_stmap.stmap_cuda(model, fb, 1001, 333, direction,
                                 device="cuda")
        work = t_stmap.stmap_cuda(other, fb, 1001, 333, direction,
                                  device="cuda")
        source = work.clone()
        assert t_stmap.stmap_layer_cuda(work, model, fb, direction) is work
        assert counters["host_reads"] == before["host_reads"]
        for key, n in (("stmap.device_packs", 3), ("stmap.launches", 2),
                       ("stmap_layer.launches", 1)):
            assert counters[key] == before[key] + n, (kind, key)
        # The plain version of the same numbers, as Python floats: it
        # takes no lens of mixed dtypes.
        fb_floats, floats = (type(o)(**{k: float(v) for k, v in
                                        vars(o).items()})
                             for o in (fb, model))
        plain = t_stmap.stmap_torch(floats, fb_floats, 1001, 333, direction,
                                    device="cuda")
        layer_plain = t_stmap.stmap_layer_torch(source, floats, fb_floats,
                                                direction)
        if emulated is None:
            emulated = (emulation.emulated_map(floats, fb_floats, 1001, 333,
                                               direction),
                        emulation.emulated_map(floats, fb_floats, 1001, 333,
                                               direction,
                                               source=source.cpu().numpy()))
        torch.cuda.synchronize()
        for a, b, tol in ((got, plain, ATOL), (work, layer_plain, ATOL),
                          (got.cpu(), emulated[0], 1e-6),
                          (work.cpu(), emulated[1], 1e-6)):
            assert float((a - torch.as_tensor(b, device=a.device))
                         .abs().max()) <= tol, (kind, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_stmap_stack_packs_once_for_its_layers(direction):
    """A stack is one pack launch for up to eight layers: two layers one,
    nine two; a distort stack one map launch a layer, an undistort one
    one for each pack (the fused stack kernel for eight layers, the
    ninth alone from the map); no host read; a stack held on the card
    gives the same map as the same stack in CPU tensors, handed over by
    value."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    lenses = [torch_model(n, device="cuda")[0] for n in MODELS]
    _, fb = torch_model("classic", device="cuda")
    _, host_fb = torch_model("classic")
    for layers, packs in ((lenses[:2], 1),
                          ([weaker(m, 0.1) for m in lenses * 2]
                           + [weaker(lenses[0], 0.1)], 2)):
        host = [type(m)(**{k: v.cpu() for k, v in vars(m).items()})
                for m in layers]
        for stack, film_back in ((layers, fb), (host, host_fb)):
            before = counters.copy()
            got = t_stmap.stmap_stack(stack, film_back, 640, 360, direction,
                                      device="cuda")
            layer_launches = (len(layers) - 1 if direction == "distort"
                              else packs - 1)
            for key, n in (("host_reads", 0), ("stmap.device_packs", packs),
                           ("stmap.launches", 1),
                           ("stmap_layer.launches", layer_launches)):
                assert counters[key] == before[key] + n, (len(layers), key)
            if stack is layers:
                want = got
        torch.cuda.synchronize()
        assert torch.equal(got, want), len(layers)


@pytest.mark.cuda
def test_device_pack_refuses_a_field_that_is_not_one_number():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    model, fb = torch_model("classic", device="cuda")
    bad = dataclasses.replace(model, distortion=torch.zeros(2, device="cuda"))
    good = t_stmap.stmap_cuda(model, fb, 64, 32, device="cuda")
    before = counters.copy()
    with pytest.raises(ValueError, match="2 numbers, not one"):
        t_stmap.stmap_cuda(bad, fb, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="2 numbers, not one"):
        t_stmap.stmap_layer_cuda(good, bad, fb)
    with pytest.raises(ValueError, match="2 numbers, not one"):
        t_stmap.stmap_stack([model, bad], fb, 64, 32, device="cuda")
    assert counters == before


# name: (image (H, W, C), map (H', W', channels), how the kernel is handed
# them, dtype).  "map_columns" reads every other column of a wider map,
# "map_channels" a map whose UV sit in channels 1 and 2 (4 bytes off),
# "image_rgb" the RGB of an RGBA image, at its strides.
WARP_CASES = {
    "rgba": ((45, 80, 4), (45, 80, 4), None, torch.float32),
    "gray": ((45, 80, 1), (45, 80, 4), None, torch.float32),
    "rgb": ((45, 80, 3), (45, 80, 4), None, torch.float32),
    "other_size": ((45, 80, 4), (61, 123, 4), None, torch.float32),
    "uv_only": ((45, 80, 4), (45, 80, 2), None, torch.float32),
    "map_columns": ((45, 80, 4), (45, 160, 4), "map_columns", torch.float32),
    "map_channels": ((45, 80, 3), (45, 80, 4), "map_channels",
                     torch.float32),
    "image_rgb": ((45, 80, 4), (45, 80, 4), "image_rgb", torch.float32),
    "float64": ((45, 80, 4), (61, 123, 3), None, torch.float64),
}


def _warp_inputs(case, image_dtype=None):
    """The case's image and map on the card: UVs that reach 1.5 px past
    every edge of the image (where the clamped taps jump at every whole
    pixel beyond the left and top edges) and one NaN UV.  The image is
    made in `image_dtype` where it is given, before the case's view."""
    image_shape, map_shape, view, dtype = WARP_CASES[case]
    rng = np.random.RandomState(sorted(WARP_CASES).index(case))
    height, width = image_shape[:2]
    image = rng.uniform(0.0, 1.0, image_shape)
    st_map = rng.uniform(0.0, 1.0, map_shape)
    st_map[..., 0] = rng.uniform(-1.5 / width, 1 + 1.5 / width,
                                 map_shape[:2])
    st_map[..., 1] = rng.uniform(-1.5 / height, 1 + 1.5 / height,
                                 map_shape[:2])
    image = torch.as_tensor(image, dtype=image_dtype or dtype, device="cuda")
    st_map = torch.as_tensor(st_map, dtype=dtype, device="cuda")
    if view == "map_columns":
        st_map = st_map[:, ::2]
    elif view == "map_channels":
        st_map = torch.cat([st_map[..., 3:], st_map[..., :3]], -1)[..., 1:]
    elif view == "image_rgb":
        image = image[..., :3]
    st_map[3, 5, :2] = float("nan")
    return image, st_map


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_kernel_matches_eager_and_float64(case):
    """warp_image on the card is one launch of csrc/warp.cu: it equals the
    eager _bilinear_sample on the same CUDA tensors, bit for bit (the
    same sample positions, the same roundings), and the float64 warp on
    the CPU within float32's rounding of the blend."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.ops import warp as t_warp

    image, st_map = _warp_inputs(case)
    launches = counters["warp.launches"]
    got = t_warp.warp_image(image, st_map)
    assert counters["warp.launches"] == launches + 1
    eager = t_warp._bilinear_sample(image, st_map[..., 0], st_map[..., 1])
    wide = t_warp._bilinear_sample(image.cpu().double(),
                                   st_map[..., 0].cpu(),
                                   st_map[..., 1].cpu())
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == image.dtype and got.is_contiguous()
    assert got.shape == st_map.shape[:2] + image.shape[2:]
    assert bool(got[3, 5].isnan().all())
    torch.testing.assert_close(got, eager, rtol=0, atol=1e-6,
                               equal_nan=True)
    assert torch.equal(got.isnan(), eager.isnan())
    assert torch.equal(got.nan_to_num(), eager.nan_to_num())
    torch.testing.assert_close(got.cpu().double(), wide, rtol=0, atol=1e-6,
                               equal_nan=True)


# The half instantiation's cases (a float16 image through a float32 map):
# "rgba", "other_size", "uv_only" and "map_columns" take its packed path
# (8-byte taps, a float2 UV), the others its strided one.
HALF_WARP_CASES = [case for case, (_, _, _, dtype) in WARP_CASES.items()
                   if dtype == torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("case", HALF_WARP_CASES)
def test_warp_kernel_on_a_half_image_is_the_eager_warp(case):
    """A float16 image through a float32 map is one launch of the half
    instantiation, counted in warp.half_launches: a float32 output equal,
    bit for bit, to the eager _bilinear_sample of the same CUDA tensors
    (each tap widened exactly, then the same roundings) and to the float32
    instantiation on the image widened to float32; the float64 warp on
    the CPU within float32's rounding of the blend."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.ops import warp as t_warp

    image, st_map = _warp_inputs(case, torch.float16)
    before = counters.copy()
    got = t_warp.warp_image(image, st_map)
    assert counters["warp.launches"] == before["warp.launches"] + 1
    assert counters["warp.half_launches"] == before["warp.half_launches"] + 1
    wide = t_warp.warp_image(image.float(), st_map)
    assert counters["warp.half_launches"] == before["warp.half_launches"] + 1
    eager = t_warp._bilinear_sample(image, st_map[..., 0], st_map[..., 1])
    plain = t_warp._bilinear_sample(image.cpu().double(),
                                    st_map[..., 0].cpu(),
                                    st_map[..., 1].cpu())
    torch.cuda.synchronize()
    assert eager.dtype == got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == st_map.shape[:2] + image.shape[2:]
    assert bool(got[3, 5].isnan().all())
    for other in (eager, wide):
        assert torch.equal(got.isnan(), other.isnan())
        assert torch.equal(got.nan_to_num(), other.nan_to_num())
    torch.testing.assert_close(got.cpu().double(), plain, rtol=0, atol=1e-6,
                               equal_nan=True)


@pytest.mark.cuda
def test_warp_kernel_refuses_every_other_dtype_mix():
    """Only float32 with float32, float64 with float64 and a float16
    image with a float32 map reach the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.ops import warp as t_warp

    image, st_map = _warp_inputs("rgba")
    before = counters.copy()
    for image_dtype, map_dtype in (
            (torch.float16, torch.float16), (torch.float16, torch.float64),
            (torch.float32, torch.float16), (torch.float64, torch.float32),
            (torch.float32, torch.float64), (torch.bfloat16, torch.float32),
            (torch.bfloat16, torch.bfloat16), (torch.float16, torch.bfloat16)):
        with pytest.raises(ValueError, match="a float16 image and a float32"):
            t_warp.warp_image(image.to(image_dtype), st_map.to(map_dtype))
    for key in ("warp.launches", "warp.half_launches"):
        assert counters[key] == before[key], key


@pytest.mark.cuda
def test_warp_kernel_time_lies_under_the_callers_range():
    """Under a capture the launch is the operator record "warp.launch"
    inside "warp.call" (utils/profiler.py::span), so the kernel's device
    time counts in the caller's record_function around warp_image, as an
    eager op's would."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mayamatchmovesolver_torch.ops import warp as t_warp

    image, st_map = _warp_inputs("rgba")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        # A capture's first launch also lends its kernel to the
        # profiler's own "Activity Buffer Request" event inside the op:
        # one launch before the range.
        t_warp.warp_image(image, st_map)
        with record_function("caller"):
            t_warp.warp_image(image, st_map)
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    (caller,) = [e for e in host if e.name == "caller"]
    ops = [e for e in host if e.name == "mmsolver.warp.launch"]
    kernels = [e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA
               and "warp_kernel" in e.name]
    assert len(ops) == len(kernels) == 2
    call = ops[1].cpu_parent
    assert call.name == "mmsolver.warp.call" and not call.is_user_annotation
    assert call.cpu_parent.id == caller.id and caller.device_time_total > 0
    assert caller.device_time_total == pytest.approx(kernels[1])


@pytest.mark.cuda
def test_program_spans_have_no_device_copy_and_hold_their_kernels():
    """Under a capture with tracing() off, a frame of the export (a lens
    stack's map, a single lens's map, a half-plate warp) leaves no CUDA
    event named "mmsolver.*": the spans are operator records, not user
    ranges.  Every ST-map and pack kernel is put down to "stmap.launch",
    every warp kernel to "warp.launch"."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mayamatchmovesolver_torch.ops import warp as t_warp

    model, fb = torch_model("classic")
    radial, _ = torch_model("radial_deg4")
    image = torch.rand(32, 64, 4, device="cuda").half()
    t_warp.warp_image(image, t_stmap.stmap(model, fb, 64, 32,
                                           device="cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for direction in ("undistort", "distort"):
            st_map = t_stmap.stmap([model, radial], fb, 64, 32, direction,
                                   device="cuda")
            t_warp.warp_image(image, st_map)
        t_warp.warp_image(image, t_stmap.stmap(model, fb, 64, 32,
                                               device="cuda"))
        torch.cuda.synchronize()
    events = prof.events()
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert not [n for n in device if n.startswith("mmsolver.")]
    ours = [n for n in device if "stmap" in n or "pack_params" in n
            or "warp_kernel" in n]
    held = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        # The innermost span around the event the kernel is put down to
        # (an op, its runtime call, or the profiler's own event that a
        # capture's first launch lends its kernel to).
        span = e
        while span is not None and not span.name.startswith("mmsolver."):
            span = span.cpu_parent
        name = span.name if span is not None else e.name
        held.setdefault(name, set()).update(k.name for k in e.kernels)
    assert sorted(held) == ["mmsolver.stmap.launch", "mmsolver.warp.launch"]
    assert all("warp_kernel" in n for n in held["mmsolver.warp.launch"])
    assert not [n for n in held["mmsolver.stmap.launch"]
                if "warp_kernel" in n]
    # The pack kernel, the fused undistort stack, the distort layer from
    # the pixel and from the map, and one warp instantiation.
    assert len(held["mmsolver.stmap.launch"]) == 4
    assert set(ours) == held["mmsolver.stmap.launch"] | held[
        "mmsolver.warp.launch"]


@pytest.mark.cuda
def test_warp_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.ops import warp as t_warp

    image, st_map = _warp_inputs("rgba")
    launches = counters["warp.launches"]
    for bad_image, bad_map, message in (
            (image.cpu(), st_map, "one CUDA device"),
            (image, st_map.cpu(), "one CUDA device"),
            (image.half(), st_map.half(), "float32 or float64"),
            (image, st_map.double(), "same dtype"),
            (image.double(), st_map, "same dtype"),
            (image[..., 0], st_map, r"\(H, W, C\)"),
            (image[:0], st_map, r"\(H, W, C\)"),
            (image, st_map[..., :1], r"\(H', W', >=2\)"),
            (image, st_map[..., 0], r"\(H', W', >=2\)"),
            (image, st_map[:, :0], r"\(H', W', >=2\)")):
        with pytest.raises(ValueError, match=message):
            t_warp.warp_image(bad_image, bad_map)
    assert counters["warp.launches"] == launches


def _pose_shot(device, frames=6, bundles=8):
    """A float32 shot with exact tracks, its camera moved off the truth in
    every frame: (scene, attrs, solve_attrs, truth rows)."""
    import dataclasses

    from mayamatchmovesolver_torch.scene import SceneGraph, evaluate
    from mayamatchmovesolver_torch.scene.flatscene import (
        set_marker_screen_positions,
    )

    rng = np.random.RandomState(8)
    sg = SceneGraph(frame_range=(1, frames), dtype=np.float32)
    cam = sg.create_camera(
        "cam", tx=np.linspace(-2, 2, frames), ty=np.full(frames, 1.0),
        tz=np.full(frames, 12.0), rx=np.zeros(frames),
        ry=np.linspace(-6, 6, frames), rz=np.zeros(frames),
        focal_length_mm=35.0)
    for i in range(bundles):
        bnd = sg.create_bundle("b%d" % i, tx=rng.uniform(-4, 4),
                               ty=rng.uniform(-2, 3), tz=rng.uniform(-12, -5))
        sg.create_marker("m%d" % i, camera=cam, bundle=bnd,
                         tx=np.zeros(frames), ty=np.zeros(frames))
    scene, attrs = sg.bake(device=device)
    fi = torch.arange(frames, device=device)
    attrs = set_marker_screen_positions(
        scene, attrs, fi, evaluate(scene, attrs, fi).point_xy)
    channels = ("tx", "ty", "tz", "rx", "ry", "rz")
    rows = [cam.attr(ch).code // 2 for ch in channels]
    truth = attrs.anim_values[rows].cpu().numpy()
    anim = attrs.anim_values.clone()
    anim[rows] += torch.as_tensor(
        rng.normal(0.0, 0.05, (6, frames)), dtype=anim.dtype, device=device)
    attrs = dataclasses.replace(attrs, anim_values=anim)
    return scene, attrs, [cam.attr(ch) for ch in channels], rows, truth


@pytest.mark.cuda
@pytest.mark.parametrize("sequential", [False, True])
def test_solve_per_frame_on_cuda_matches_cpu(sequential):
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.solver import (
        SolverOptions, solve_per_frame)

    out = {}
    for device in ("cpu", "cuda"):
        scene, attrs, solve_attrs, rows, truth = _pose_shot(device)
        attrs_out, result = solve_per_frame(
            scene, attrs, np.arange(6), solve_attrs,
            SolverOptions(image_width=1920.0), sequential=sequential)
        assert attrs_out.anim_values.device.type == device
        assert attrs_out.anim_values.dtype == torch.float32
        assert result.success and not any(result.per_frame_reverted)
        out[device] = (attrs_out.anim_values[rows].cpu().numpy(), result)
        np.testing.assert_allclose(out[device][0], truth, atol=1e-3)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    assert out["cuda"][1].error_final < 1e-3 > out["cpu"][1].error_final


@pytest.mark.cuda
def test_checkpoint_saved_on_cuda_resumes_on_cpu(tmp_path):
    """An LM state of a batched solve saved from the card loads on the CPU
    and runs on to the end the card reaches."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    t = torch.linspace(0.0, 4.0, 15)
    rng = np.random.RandomState(1)
    truth = rng.uniform([1.0, 0.3, -1.0], [3.0, 1.5, 1.0], (5, 3))
    data = torch.as_tensor(
        truth[:, :1] * np.exp(-truth[:, 1:2] * t.numpy()) + truth[:, 2:],
        dtype=torch.float32)
    x0 = torch.as_tensor(truth * rng.uniform(0.7, 1.3, (5, 3)),
                         dtype=torch.float32)

    def residual(device):
        tt, dd = t.to(device), data.to(device)
        return lambda x: (x[..., 0:1] * torch.exp(-x[..., 1:2] * tt)
                          + x[..., 2:3]) - dd

    config = t_lm.LMConfig(max_iterations=25)
    fn = residual("cuda")
    init = t_lm.lm_init(fn, x0.cuda(), config)
    end = t_lm.lm_run_block(fn, init, config)
    path = tmp_path / "lm.npz"
    t_checkpoint.save_lm_state(path, t_lm.lm_run_block(fn, init, config, 2),
                               metadata={"from": "cuda"})
    state, meta = t_checkpoint.load_lm_state(path, device="cpu")
    assert meta == {"from": "cuda"} and state.x.device.type == "cpu"
    assert state.it.tolist() == [2] * 5 and state.it.dtype == torch.int32
    resumed = t_lm.lm_run_block(residual("cpu"), state, config)
    assert resumed.x.device.type == "cpu"
    np.testing.assert_allclose(resumed.x.numpy(), end.x.cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(resumed.x.numpy(), truth, atol=1e-3)
    back, _ = t_checkpoint.load_lm_state(path, device="cuda")
    assert back.x.is_cuda and back.jtj.shape == (5, 3, 3)


def _shot_module():
    """chip_smoke, whose shot builders these tests share (it lies at the
    repository's root, beside tests/)."""
    import importlib
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.cuda
def test_robust_relative_pose_on_cuda_matches_cpu():
    """The same minimal samples on both devices, float64: equal inliers,
    the pose within 1e-8 (the card's eigenvectors differ in sign and in
    the basis of the essential matrix's double singular value; what
    leaves the estimator does not depend on them)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.sfm import twoview

    rng = np.random.RandomState(3)
    n = 48
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], -1)
    angle = np.radians(-8.0)
    r = np.array([[np.cos(angle), 0.0, np.sin(angle)], [0.0, 1.0, 0.0],
                  [-np.sin(angle), 0.0, np.cos(angle)]])
    t = np.array([0.95, 0.1, 0.2])
    x2 = x @ r.T + t / np.linalg.norm(t)
    pts1, pts2 = x[:, :2] / x[:, 2:], x2[:, :2] / x2[:, 2:]
    pts2[:8] = rng.uniform(-0.5, 0.5, (8, 2))
    draws = twoview.draw_samples(n, 96, 8, torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", "cuda"):
        out[device] = twoview.robust_relative_pose(
            torch.as_tensor(pts1, device=device),
            torch.as_tensor(pts2, device=device), sample_indices=draws,
            num_hypotheses=96, inlier_threshold=1e-6)
    got, want = out["cuda"], out["cpu"]
    assert got.rotation.is_cuda and got.rotation.dtype == torch.float64
    assert torch.equal(got.inliers.cpu(), want.inliers)
    assert int(got.num_inliers) == 40
    np.testing.assert_allclose(got.rotation.cpu().numpy(),
                               want.rotation.numpy(), atol=1e-8)
    np.testing.assert_allclose(got.translation.cpu().numpy(),
                               want.translation.numpy(), atol=1e-8)
    np.testing.assert_allclose(got.rotation.cpu().numpy(), r, atol=1e-6)


@pytest.mark.cuda
def test_camera_solve_full_on_cuda_matches_cpu():
    """A 16 x 24 shot from its tracks alone, float64 with the default
    seeded draws on both devices: the same frames and points, the focal
    length within 1e-6 relative, and (the BA frees every camera and
    bundle, so up to scale) rotations and positions over the path's
    length at 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.sfm import camerasolve

    smoke = _shot_module()
    frames, bundles = 16, 24
    _, _, _, _, raw = smoke.shot_graph("cpu", frames, bundles, lens=False,
                                       dtype=np.float64)
    enable = np.ones((bundles, frames), bool)
    enable[0, 9:] = False
    enable[1, :6] = False
    out = {}
    for device in ("cpu", "cuda"):
        out[device] = camerasolve.camera_solve_full(
            raw, enable, focal_length_mm=34.0, image_width=1920.0,
            solve_focal=True, ba_iterations=30, device=device)
    (got, got_ba, got_focal), (want, _, want_focal) = out["cuda"], out["cpu"]
    assert got.rotations.is_cuda and got_ba.cam_params.is_cuda
    assert got.frame_solved.all() and got.point_valid.sum() >= bundles - 2
    np.testing.assert_array_equal(got.frame_solved, want.frame_solved)
    np.testing.assert_array_equal(got.point_valid, want.point_valid)
    assert abs(got_focal - want_focal) <= 1e-6 * want_focal
    assert abs(got_focal - smoke.FOCAL) < 1e-4
    np.testing.assert_allclose(got.rotations.cpu().numpy(),
                               want.rotations.numpy(), atol=1e-6)
    paths = [r.positions.cpu().numpy() for r in (got, want)]
    np.testing.assert_allclose(paths[0] / np.linalg.norm(paths[0][-1]),
                               paths[1] / np.linalg.norm(paths[1][-1]),
                               atol=1e-6)


@pytest.mark.cuda
def test_execute_of_solver_standard_on_cuda_matches_cpu():
    """One Collection (12 frames x 10 bundles of the smoke's lensed shot,
    float64) executed on both devices: SolverStandard's root pass,
    per-frame pass and global pass give the same number of results and
    the same attributes within 1e-6, and the lens is recovered."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    import mayamatchmovesolver_torch.api as mmapi

    smoke = _shot_module()
    col, cam, _ = smoke.shot_collection(
        "cpu", "standard", 12, 10, root_frame_indices=None,
        global_solve=True, root_frame_span=4)
    out = {device: mmapi.execute(col, device=device, dtype=np.float64)
           for device in ("cpu", "cuda")}
    (got, got_results), (want, want_results) = out["cuda"], out["cpu"]
    assert got.static_values.is_cuda
    assert got.static_values.dtype == torch.float64
    assert len(got_results) == len(want_results) == 3
    assert all(r.success for r in got_results)
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(getattr(got, field).cpu().numpy(),
                                   getattr(want, field).numpy(), atol=1e-6,
                                   err_msg=field)
    focal = float(got.static_values[cam.attr("focal_length_mm").code // 2])
    # The tracks were made in float32.
    assert abs(focal - smoke.FOCAL) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_cli_lensdistort_on_cuda_writes_the_kernels_map(tmp_path, direction):
    """cli lensdistort --device cuda: one kernel launch, and the EXR it
    writes equals the plain version of the same lens within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch import cli, models
    from mayamatchmovesolver_torch.io import exr

    out = str(tmp_path / "st.exr")
    launches = counters["stmap.launches"]
    assert cli.main(["lensdistort", "--distortion", "0.08", "--width", "640",
                     "--height", "360", "--direction", direction,
                     "--output", out, "--device", "cuda"]) == 0
    assert counters["stmap.launches"] == launches + 1
    f32 = dict(device="cuda", dtype=torch.float32)
    want = t_stmap.stmap_torch(
        models.TdeClassic.create(distortion=0.08, **f32),
        models.FilmBack.create(width_cm=3.6, height_cm=2.4, **f32),
        640, 360, direction, device="cuda").cpu().numpy()
    got, _ = exr.read_pixels(out)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.cuda
def test_cli_reproject_on_cuda_matches_cpu(tmp_path):
    """cli reproject --device cuda equals the CPU run at 1e-10 (float64
    on both)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    import json

    from mayamatchmovesolver_torch import cli

    rng = np.random.RandomState(4)
    cam = {"frames": list(range(1, 9)), "camera": {
        c: rng.uniform(-10, 10, 8).tolist() if c[0] == "r"
        else (rng.uniform(-1, 1, 8) + (10.0 if c == "tz" else 0.0)).tolist()
        for c in ("tx", "ty", "tz", "rx", "ry", "rz")}}
    with open(tmp_path / "cam.json", "w") as f:
        json.dump(cam, f)
    with open(tmp_path / "pts.json", "w") as f:
        json.dump(rng.uniform(-2, 2, (16, 3)).tolist(), f)
    results = {}
    for device in ("cpu", "cuda"):
        out = str(tmp_path / ("%s.json" % device))
        assert cli.main(["reproject", "--camera", str(tmp_path / "cam.json"),
                         "--points", str(tmp_path / "pts.json"), "--space",
                         "pixels", "--output", out, "--device", device]) == 0
        with open(out) as f:
            results[device] = np.asarray(json.load(f)["points"])
    assert results["cuda"].shape == (16, 8, 2)
    np.testing.assert_allclose(results["cuda"], results["cpu"], rtol=0,
                               atol=1e-10)


def _tools_scene(device_frames=6):
    """A float64 port scene for the tools: an animated camera, an
    animated group, a static group and seeded bundles with markers."""
    from mayamatchmovesolver_torch.scene import SceneGraph

    rng = np.random.RandomState(7)
    n = device_frames
    ramp = np.linspace(0.0, 1.0, n)
    sg = SceneGraph(frame_range=(1, n))
    nodes = {"grp": sg.create_transform("grp", tx=2.0 * ramp,
                                        ry=30.0 * ramp),
             "newp": sg.create_transform("newp", tx=-1.0, rz=20.0)}
    nodes["cam"] = sg.create_camera(
        "cam", tx=-1.0 + 2.0 * ramp, ty=0.3 * ramp, tz=10.0 + ramp,
        rx=rng.uniform(-2, 2, n), ry=-4.0 + 8.0 * ramp, rz=np.zeros(n),
        render_width=1920, render_height=1080)
    nodes["bundles"] = [sg.create_bundle(
        "b%d" % i, tx=rng.uniform(-3, 3), ty=rng.uniform(-2, 2),
        tz=rng.uniform(-8, -4)) for i in range(5)]
    for i, b in enumerate(nodes["bundles"]):
        sg.create_marker("m%d" % i, camera=nodes["cam"], bundle=b,
                         tx=rng.uniform(-0.3, 0.3, n),
                         ty=rng.uniform(-0.2, 0.2, n))
    return sg, nodes


@pytest.mark.cuda
def test_intersect_rays_mesh_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.utils import raytrace

    rng = np.random.RandomState(3)
    vertices = rng.uniform(-2, 2, (60, 3)) * [1, 1, 0.1] - [0, 0, 4]
    triangles = rng.randint(0, 60, (80, 3))
    origins = rng.uniform(-1, 1, (64, 3)) * [1, 1, 0] + [0, 0, 3]
    directions = rng.normal(0, 0.2, (64, 3)) - [0, 0, 1]
    results = {}
    for device in ("cpu", "cuda"):
        for both in (False, True):
            out = raytrace.intersect_rays_mesh(
                torch.as_tensor(origins, device=device),
                torch.as_tensor(directions, device=device), vertices,
                triangles, test_both_directions=both)
            assert out[0].device.type == device
            results[device, both] = [t.cpu().numpy() for t in out]
    for both in (False, True):
        want, got = results["cpu", both], results["cuda", both]
        np.testing.assert_array_equal(got[3], want[3])
        assert want[3].any()
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g[want[3]], w[want[3]], rtol=0,
                                       atol=1e-10)


@pytest.mark.cuda
def test_screen_space_rig_bake_on_cuda_round_trips():
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.scene import evaluate
    from mayamatchmovesolver_torch.tools import screenspace

    sg, nodes = _tools_scene()
    scene, attrs = sg.bake(device="cuda")
    frames = torch.arange(sg.num_frames, device="cuda")
    for b in nodes["bundles"]:
        rig = screenspace.screen_space_rig_bake(scene, attrs, frames,
                                                b.index)
        assert rig["depth"].is_cuda and bool((rig["depth"] > 0).all())
        world = screenspace.screen_space_rig_unbake(
            scene, attrs, frames, rig["screen_x"], rig["screen_y"],
            rig["depth"])
        want = evaluate(scene, attrs, frames).tfm_world[b.index, :, :3, 3]
        np.testing.assert_allclose(world.cpu().numpy(),
                                   want.cpu().numpy(), rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_reparent_on_cuda_writes_the_cpu_values():
    """reparent(device="cuda") writes the builder values of the CPU run
    at 1e-10 (float64 on both)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    from mayamatchmovesolver_torch.tools import reparent

    baked = {}
    for device in ("cpu", "cuda"):
        sg, nodes = _tools_scene()
        reparent.reparent(sg, nodes["cam"], nodes["grp"], device=device)
        for b in nodes["bundles"]:
            reparent.reparent(sg, b, nodes["newp"], device=device)
        reparent.reparent(sg, nodes["cam"], None, device=device)
        attrs = sg._attr_builder.bake(device="cpu")
        baked[device] = (attrs.static_values.numpy(),
                         attrs.anim_values.numpy())
    for got, want in zip(baked["cuda"], baked["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.fixture
def frame_mesh(request):
    """The frame mesh of the sharded solvers on the card: world size 1
    with no process group, or under a one-rank NCCL group (made here and
    destroyed after the test)."""
    if not torch.cuda.is_available():
        pytest.skip("the card run needs an NVIDIA GPU")
    import socket

    import torch.distributed as dist

    from mayamatchmovesolver_torch.parallel import make_frame_mesh, multihost

    if request.param == "no group":
        yield make_frame_mesh("cuda")
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert multihost.initialize("localhost:%d" % port, 1, 0, local_rank=0,
                                device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = multihost.frame_mesh()
        assert mesh.size == 1 and mesh.group is not None
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("frame_mesh", ["no group", "nccl group"],
                         indirect=True)
def test_sharded_ba_on_cuda_matches_cpu(frame_mesh):
    """The frame-sharded BA at world size 1 on the card repeats its CPU
    run, float32 on both, with the tolerances of solve_ba's card test."""
    from mayamatchmovesolver_torch.parallel import ba_sharded, make_frame_mesh

    kw = dict(max_iterations=4, tau=0.1, eps1=0.0, eps2=0.0, eps3=0.0,
              cg_iterations=40)
    want = ba_sharded.sharded_solve_ba(_ba_problem("cpu"),
                                       make_frame_mesh("cpu"), **kw)
    got = ba_sharded.sharded_solve_ba(
        ba_sharded.shard_ba_problem(_ba_problem("cpu"), frame_mesh),
        frame_mesh, **kw)
    assert got.cam_params.is_cuda and got.cam_params.dtype == torch.float32
    for name in ("iterations", "stop_reason", "func_evals",
                 "jacobian_evals"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    for name in ("cam_params", "bnd_params", "shared_params"):
        a, b = getattr(got, name).cpu().numpy(), getattr(want, name).numpy()
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_mesh", ["no group", "nccl group"],
                         indirect=True)
def test_sharded_lm_on_cuda_matches_cpu(frame_mesh):
    """The frame-sharded LM at world size 1 on the card: the CPU run's
    iterations, stop reason and counters, parameters at 1e-10 (float64
    on both), and the truth."""
    from _torch_sharded_cases import static_lm_problem
    from mayamatchmovesolver_torch.parallel import (
        make_frame_mesh, shard_problem_arrays, sharded_levenberg_marquardt)
    from mayamatchmovesolver_torch.solver import problem as problem_mod

    states = []
    for device, mesh in (("cpu", make_frame_mesh("cpu")),
                         ("cuda", frame_mesh)):
        prob = shard_problem_arrays(static_lm_problem("torch", 8, device),
                                    mesh)
        states.append(sharded_levenberg_marquardt(
            prob, problem_mod.initial_parameters(prob), mesh,
            max_iterations=30))
    want, got = states
    assert got.params.is_cuda
    for name in ("it", "stop", "nfev", "njev"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    np.testing.assert_allclose(got.params.cpu().numpy(), want.params.numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(got.params[0]), 0.5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_mesh", ["nccl group"], indirect=True)
def test_sharded_dryrun_ba_on_cuda_meets_its_thresholds(frame_mesh):
    """__graft_entry__.py's dryrun_multichip BA (64 frames, 96 bundles,
    focal and classic distortion in the border, float32, 10 iterations,
    CG 25) under a one-rank NCCL group, held to its thresholds
    (chip_smoke.sharded_dryrun raises when one is missed)."""
    from chip_smoke import sharded_dryrun

    result = sharded_dryrun(frame_mesh.device, frame_mesh)
    assert result.cam_params.is_cuda and result.cam_params.shape == (64, 6)
    assert int(result.iterations) == 10
