"""The torch port's ST-map export against the JAX package's TPU kernel.

On the CPU the port's plain version, stmap_torch, runs in float32 and is
held against the JAX Pallas kernel itself (stmap_pallas in TPU interpret
mode) and against its XLA oracle, for the four 3DE models in both
directions at a ragged 200x100, at the 2e-5 of
tests/test_ops/test_stmap.py.  The CUDA kernels cannot run here: their
arithmetic (the pack kernel folding the lens's fields into two affine
maps and the division-free anamorphic coefficients, then the map
kernel) is checked by transcriptions of csrc/stmap.cu
(_torch_stmap_emulation.py), fed the fields as the wrapper hands them,
for the variant that starts from the pixel index and the one that
starts from a map, and the kernels themselves against their plain
versions and the transcription by tests/test_torch/test_torch_cuda.py,
on the card.
"""

import dataclasses
import itertools
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.stmap as t_stmap
from mayamatchmovesolver_torch.utils.profiler import counters
import mayamatchmovesolver_tpu.models as j_models
import mayamatchmovesolver_tpu.ops.stmap as j_stmap
from _torch_port_cases import to_numpy
import _torch_stmap_emulation as emulation
from _torch_stmap_emulation import emulated_map
from _torch_stmap_models import (
    FILM_BACK, MODELS, NEUTRAL, torch_model, weaker,
)

ATOL = 2e-5
WIDTH, HEIGHT = 200, 100
NAMES = tuple(MODELS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_model(name):
    cls_name, params = MODELS[name]
    return (getattr(j_models, cls_name).create(**params),
            j_models.FilmBack.create(**FILM_BACK))


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", NAMES)
def test_stmap_torch_matches_pallas_kernel_and_xla(name, direction):
    model, fb = torch_model(name)
    got = to_numpy(t_stmap.stmap_torch(model, fb, WIDTH, HEIGHT, direction,
                                       device="cpu"))
    assert got.shape == (HEIGHT, WIDTH, 4) and got.dtype == np.float32
    j_model, j_fb = jax_model(name)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_stmap.stmap_pallas(
            j_model, j_fb, WIDTH, HEIGHT, direction=direction))
    xla = np.asarray(jax.jit(
        j_stmap.stmap_xla, static_argnums=(2, 3, 4))(
            j_model, j_fb, WIDTH, HEIGHT, direction))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, xla, atol=ATOL)
    np.testing.assert_array_equal(got[..., 2:], [0.0, 1.0] * np.ones_like(
        got[..., 2:]))


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_parameters_reproduce_plain_version(name, direction):
    """The pack kernel's fold: the pre/post matrices equal the JAX
    package's _model_kernel_config, and the 22 packed floats, run
    through the map kernel's arithmetic, give the plain version's map
    (float32 on both sides, another operation order: 2e-5)."""
    model, fb = torch_model(name)
    kind, values, fb_values = emulation.layer_fields(model, fb)
    _, _, pre, post = emulation.kernel_config(kind, values, fb_values)
    j_model, j_fb = jax_model(name)
    _, _, j_pre, j_post = j_stmap._model_kernel_config(j_model, j_fb)
    np.testing.assert_allclose(pre, j_pre, atol=1e-6)
    np.testing.assert_allclose(post, j_post, atol=1e-6)

    emulated = emulated_map(model, fb, WIDTH, HEIGHT, direction)
    plain = to_numpy(t_stmap.stmap_torch(model, fb, WIDTH, HEIGHT,
                                         direction, device="cpu"))
    np.testing.assert_allclose(emulated, plain, atol=ATOL)


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", NAMES)
def test_layer_kernel_arithmetic_reproduces_plain_layer(name, direction):
    """The layer variant on an irregular map (another model's first
    layer) against stmap_layer_torch, and against the JAX package's
    point-wise lens map of the same points; channels 2 and 3 carry
    through whatever they hold.  2e-5: float32, another operation
    order."""
    model, fb = torch_model(name)
    other, _ = torch_model(NAMES[(NAMES.index(name) + 1) % len(NAMES)])
    other = weaker(other, 0.3)
    source = t_stmap.stmap_torch(other, fb, WIDTH, HEIGHT, direction,
                                 device="cpu")
    rng = np.random.RandomState(4)
    source[..., 2:] = torch.as_tensor(
        rng.uniform(-1, 1, (HEIGHT, WIDTH, 2)).astype(np.float32))
    emulated = emulated_map(model, fb, WIDTH, HEIGHT, direction,
                             source=to_numpy(source))
    plain = to_numpy(t_stmap.stmap_layer_torch(source, model, fb, direction))
    np.testing.assert_allclose(emulated, plain, atol=ATOL)
    np.testing.assert_array_equal(emulated[..., 2:],
                                  to_numpy(source)[..., 2:])
    j_model, j_fb = jax_model(name)
    lens_map = j_models.distort if direction == "distort" \
        else j_models.undistort
    want = np.asarray(lens_map(
        j_model, j_fb, np.asarray(to_numpy(source)[..., :2], np.float64)
        - 0.5)) + 0.5
    np.testing.assert_allclose(emulated[..., :2], want, atol=ATOL)


# Undistort stacks that csrc/stmap.cu maps in one stmap_stack_kernel
# launch: every ordered pair of the four models, three layers, eight
# (one pack) and nine (the ninth layer a second pack's one launch, from
# the map).
FUSED_STACKS = dict(
    {"%s,%s" % pair: pair for pair in itertools.product(NAMES, repeat=2)},
    three=("anamorphic_deg4", "classic", "radial_deg4"),
    eight=NAMES * 2, nine=NAMES * 2 + NAMES[:1])


@pytest.mark.parametrize("source", ["pixels", "map"])
@pytest.mark.parametrize("stack", list(FUSED_STACKS))
def test_fused_undistort_stack_is_a_launch_a_layer(stack, source):
    """The fused stack kernel's arithmetic as the launcher hands it the
    layers (_torch_stmap_emulation.emulated_launches: the packed core
    ids and each layer's floats) is the map of a launch a layer
    (emulated_stack) bit for bit in float32, from the pixel index and
    from an irregular map whose channels 2 and 3 carry through; and
    within 2e-5 of the plain stack (float32, another operation
    order)."""
    names = FUSED_STACKS[stack]
    models = [weaker(torch_model(n)[0], 0.3 if len(names) < 8 else 0.1)
              for n in names]
    _, fb = torch_model("classic")
    start = None
    if source == "map":
        start = t_stmap.stmap_torch(weaker(torch_model("radial_deg4")[0],
                                           0.3), fb, WIDTH, HEIGHT,
                                    "undistort", device="cpu")
        start[..., 2:] = torch.as_tensor(np.random.RandomState(5).uniform(
            -1, 1, (HEIGHT, WIDTH, 2)).astype(np.float32))
    got = emulation.emulated_launches(
        models, fb, WIDTH, HEIGHT, "undistort",
        source=None if start is None else to_numpy(start))
    assert got.shape == (HEIGHT, WIDTH, 4) and got.dtype == np.float32
    if start is None:
        want = emulation.emulated_stack(models, fb, WIDTH, HEIGHT,
                                        "undistort")
        plain = t_stmap.stmap_stack_torch(models, fb, WIDTH, HEIGHT,
                                          "undistort", device="cpu")
    else:
        want = plain = start
        for model in models[::-1]:
            want = emulated_map(model, fb, WIDTH, HEIGHT, "undistort",
                                source=want)
            plain = t_stmap.stmap_layer_torch(plain, model, fb, "undistort")
        want = np.asarray(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, to_numpy(plain), atol=ATOL)
    assert float(np.abs(got - emulated_map(
        models[-1], fb, WIDTH, HEIGHT, "undistort",
        source=None if start is None else to_numpy(start))).max()) > 1e-4


def test_stack_cores_pack_each_layers_core_in_two_bits():
    """csrc/stmap.cu's `cores`: CORE_BITS a layer, the first lowest, as
    the fused kernel's transcription reads them back; eight anamorphic
    layers fill sixteen bits."""
    assert emulation.stack_cores([0, 1, 2]) == 0b100100
    assert emulation.stack_cores([2] * 8) == 0xAAAA
    assert emulation.stack_cores([]) == 0


def _guarded_anamorphic_factors(c, x, y):
    """The reference's polar form with its guarded division: fx, fy."""
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    r4 = r2 * r2
    cos2 = (x2 - y2) / np.maximum(r2, x.dtype.type(1e-30))
    cos4 = 2 * cos2 * cos2 - 1
    return [1 + c[i] * r2 + c[4 + i] * r4
            + cos2 * (c[2 + i] * r2 + c[6 + i] * r4) + cos4 * c[8 + i] * r4
            for i in (0, 1)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_anamorphic_polynomial_needs_no_division(dtype):
    """The kernel's division-free anamorphic polynomial equals the
    guarded division form: exactly 1 at the point (0, 0), where the guard
    acted, within rounding at |r| ~ 1e-20 (r^2 underflows float32) and
    over the image."""
    rng = np.random.RandomState(9)
    c = rng.uniform(-0.1, 0.1, 10).astype(dtype)
    folded = c.copy()
    folded[4:6] = c[4:6] - c[8:10]
    folded[8:10] = 2 * c[8:10]
    pts = np.concatenate([
        [[0.0, 0.0], [1e-20, 0.0], [0.0, -1e-20], [7e-21, 7e-21]],
        rng.uniform(-1.2, 1.2, (200, 2))]).astype(dtype)
    x, y = pts[:, 0], pts[:, 1]
    x2, y2 = x * x, y * y
    r2, d = x2 + y2, x2 - y2
    want = _guarded_anamorphic_factors(c, x, y)
    for i in (0, 1):
        got = 1 + (r2 * (folded[i] + folded[4 + i] * r2 + folded[6 + i] * d)
                   + d * (folded[2 + i] + folded[8 + i] * d))
        assert got[0] == 1.0 == want[i][0]
        np.testing.assert_allclose(got[:4], 1.0, rtol=0, atol=1e-30)
        np.testing.assert_allclose(
            got, want[i], rtol=0, atol=8 * np.finfo(dtype).eps)


# The knobs of the benchmark's spherical lens file
# (mmbench/configs/venice2_radial_half.json) and each one's field in
# TdeRadialStdDeg4; an animated knob runs from its first value to its last.
VENICE2_CONFIG = (pathlib.Path(__file__).resolve().parents[2] / "mmbench"
                  / "configs" / "venice2_radial_half.json")
RADIAL_KNOBS = {"Distortion_Degree_2": "degree2_distortion",
                "U_Degree_2": "degree2_u", "V_Degree_2": "degree2_v",
                "Quartic_Distortion_Degree_4": "degree4_distortion",
                "U_Degree_4": "degree4_u", "V_Degree_4": "degree4_v",
                "Phi_Cylindric_Direction": "cylindric_direction",
                "B_Cylindric_Bending": "cylindric_bending"}


def _venice2_radial(frame):
    """(radial model, film back) of the VENICE 2 lens file at its first
    (0) or last (-1) frame, as Python floats."""
    config = json.loads(VENICE2_CONFIG.read_text())
    model = t_models.TdeRadialStdDeg4(**{
        field: float(value[frame] if isinstance(value, list) else value)
        for knob, field in RADIAL_KNOBS.items()
        for value in [config["lens"]["knobs"][knob]]})
    width_mm, height_mm = config["film_back_mm"]
    return model, t_models.FilmBack(width_mm / 10, height_mm / 10, 0.0, 0.0,
                                    config["pixel_aspect"])


@pytest.mark.parametrize("lens", ["venice2_first", "venice2_last",
                                  "radial_deg4"])
def test_radial_fixed_point_rounds_like_float64(lens):
    """The radial core's distort arithmetic, 1 + DISTORT_INVERSE_ITERATIONS
    float32 steps of the kernel's transcription, over the core's input of
    the whole dn frame (corners included) of the benchmark's lens file at
    its first and last frame and of MODELS' radial lens: within 2e-7 dn of
    the same steps of the same polynomial, written term by term, in
    float64 from the same float32 coefficients and points."""
    if lens == "radial_deg4":
        model, fb = torch_model(lens)
    else:
        model, fb = _venice2_radial(0 if lens.endswith("first") else -1)
    kind, values, fb_values = emulation.layer_fields(model, fb)
    core, params = emulation.pack_params(kind, values, fb_values, True, None)
    _, _, _, post = emulation.kernel_config(kind, values, fb_values)
    # The whole frame in dn, through the cylindric extender's inverse: the
    # points the fixed point starts from.
    fbw, fbh, lcox, lcoy = fb_values[:4]
    radius = np.hypot(fbw, fbh) / 2
    s, t = np.meshgrid(np.linspace(0.0, 1.0, 161), np.linspace(0.0, 1.0, 107))
    dn = np.stack([((s - 0.5) * fbw - lcox) / radius,
                   ((t - 0.5) * fbh - lcoy) / radius])
    start = np.einsum("ij,jhw->hwi", emulation.inverse2(post), dn).astype(
        np.float32)
    # With both affine frames the identity, the kernel maps the point as is.
    identity = np.array([1, 0, 0, 1, 0, 0] * 2, np.float32)
    emulated = emulation._emulate_kernel(
        core, np.concatenate([params[:10], identity]), True,
        t_models.base.DISTORT_INVERSE_ITERATIONS,
        source=np.concatenate([start, np.zeros_like(start)], axis=-1))

    c = params[:6].astype(np.float64)
    x0, y0 = (start[..., i].astype(np.float64) for i in (0, 1))
    x, y = x0, y0
    for _ in range(1 + t_models.base.DISTORT_INVERSE_ITERATIONS):
        r2 = x * x + y * y
        u, v = c[1] + c[4] * r2, c[2] + c[5] * r2
        radial = c[0] * r2 + c[3] * r2 * r2
        x, y = (x0 - (x * radial + (r2 + 2 * x * x) * u + 2 * x * y * v),
                y0 - (y * radial + 2 * x * y * u + (r2 + 2 * y * y) * v))
    assert core == emulation.RADIAL_DEG4
    assert np.hypot(*dn).max() >= 1.0 - 1e-12  # the corners
    err = np.abs(emulated[..., :2] - np.stack([x, y], axis=-1)).max()
    assert err <= 2e-7, err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_matrix_helpers_match_tde(seed):
    """The float64 extender matrices of the pack kernel's transcription
    against the torch functions the plain version uses."""
    rng = np.random.RandomState(seed)
    t64 = lambda v: torch.as_tensor(v, dtype=torch.float64)
    phi, bend = rng.uniform(-90, 90), rng.uniform(-0.3, 0.3)
    np.testing.assert_allclose(
        emulation.cylindric_matrix(phi, bend),
        t_models.tde._cylindric_matrix(t64(phi), t64(bend)).numpy(),
        rtol=0, atol=1e-12)
    rot, sq_x, sq_y, pa, rescale = (
        rng.uniform(-20, 20), rng.uniform(0.8, 1.3), rng.uniform(0.8, 1.3),
        rng.uniform(0.9, 2.1), rng.uniform(0.8, 1.2))
    model = t_models.TdeAnamorphicStdDeg4Rescaled.create(
        lens_rotation=rot, squeeze_x=sq_x, squeeze_y=sq_y, rescale=rescale,
        device="cpu", dtype=torch.float64)
    fb = t_models.FilmBack.create(pixel_aspect=pa, device="cpu",
                                  dtype=torch.float64)
    for use_rescale in (None, rescale):
        plain = model if use_rescale else t_models.TdeAnamorphicStdDeg4(
            *[getattr(model, f.name) for f in dataclasses.fields(
                t_models.TdeAnamorphicStdDeg4)])
        t_pa, t_rescale = t_models.tde._pixel_aspect_and_rescale(plain, fb)
        assert (t_rescale is None) == (use_rescale is None)
        want = t_models.tde._anamorphic_matrices(model, t_pa, t_rescale)
        got = emulation.anamorphic_matrices(rot, sq_x, sq_y, pa, use_rescale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(emulation.inverse2(g),
                                       np.linalg.inv(g), rtol=0, atol=1e-12)
        # kernel_config takes the rescale from the model's kind.
        _, _, pre, post = emulation.kernel_config(
            *emulation.layer_fields(plain, fb))
        np.testing.assert_allclose(post, got[0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(pre, np.linalg.inv(got[1]), rtol=0,
                                   atol=1e-12)


def test_host_values_fetches_every_field_once():
    """One stacked transfer for the fields it is handed: float32 tensors,
    float64 ones and a one-element vector come back as their floats, in
    order; a field that is not one number raises."""
    model, fb = torch_model("radial_deg4")
    tensors = [getattr(model, f.name) for f in dataclasses.fields(model)]
    values = t_stmap._host_values(tensors)
    assert values == [float(t) for t in tensors]
    assert values[6] == 25.0  # cylindric_direction
    assert values[0] == float(np.float32(0.12))
    mixed = [fb.film_back_width_cm,
             torch.tensor(-0.02, dtype=torch.float64), torch.tensor([0.5])]
    assert t_stmap._host_values(mixed) == [float(np.float32(3.6)), -0.02,
                                           0.5]
    with pytest.raises(RuntimeError):
        t_stmap._host_values([model.degree2_u, torch.zeros(2)])


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(scales=st.lists(st.floats(0.0, 2.0), min_size=10, max_size=10))
@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_arithmetic_holds_over_coefficients(name, direction, scales):
    """Every distortion coefficient anywhere between nothing and twice
    its value in MODELS (the models the card run uses; the fixed point
    still converges there): the kernel's arithmetic stays within 2e-5 of
    the plain version."""
    cls_name, params = MODELS[name]
    scaled = dict(params)
    for scale, key in zip(scales, [k for k in params if k not in NEUTRAL]):
        scaled[key] = params[key] * scale
    model = getattr(t_models, cls_name).create(
        **scaled, device="cpu", dtype=torch.float32)
    _, fb = torch_model(name)
    emulated = emulated_map(model, fb, 48, 27, direction)
    plain = to_numpy(t_stmap.stmap_torch(model, fb, 48, 27, direction,
                                         device="cpu"))
    np.testing.assert_allclose(emulated, plain, atol=ATOL)


def test_stmap_on_cpu_is_the_plain_version():
    model, fb = torch_model("classic")
    launches = counters["stmap.launches"]
    got = t_stmap.stmap(model, fb, 64, 32, "undistort", device="cpu")
    want = t_stmap.stmap_torch(model, fb, 64, 32, "undistort", device="cpu")
    assert torch.equal(got, want)
    ident = t_stmap.stmap(t_models.Passthrough(), fb, 64, 32, device="cpu")
    xs = (np.arange(64) + 0.5) / 64
    np.testing.assert_allclose(to_numpy(ident)[5, :, 0], xs, atol=1e-6)
    assert counters["stmap.launches"] == launches


def test_stmap_refuses_what_it_does_not_port():
    model, fb = torch_model("classic")
    # A lens stack is ported: a list goes to stmap_stack.
    stack = t_stmap.stmap([model, model], fb, 8, 8, device="cpu")
    assert stack.shape == (8, 8, 4) and not torch.equal(
        stack, t_stmap.stmap(model, fb, 8, 8, device="cpu"))
    with pytest.raises(ValueError, match="cpu' or 'cuda"):
        t_stmap.stmap([model, model], fb, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cpu' or 'cuda"):
        t_stmap.stmap(model, fb, 8, 8, device="meta")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        t_stmap.stmap_cuda(model, fb, 8, 8, device="cpu")
    # The layer kernel takes a map on the card only, and counts nothing
    # for a refusal.
    launches = counters["stmap_layer.launches"]
    with pytest.raises(ValueError, match="on a CUDA device"):
        t_stmap.stmap_layer_cuda(stack, model, fb)
    assert counters["stmap_layer.launches"] == launches
