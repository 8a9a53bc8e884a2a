"""Agreement of the torch port's lens-stack ST map, image warp and lens
deformer with the JAX package.

stmap_stack: float32 maps of two- and three-layer stacks in both
directions at a ragged 200x100 against the JAX stmap_stack without
Pallas, and with the first layer through the Pallas kernel in TPU
interpret mode, at the 2e-5 of the single-layer tests (the port's later
layers run in float32 here, the film back's dtype; JAX's in float64).
warp_image: float64 gathers and two lerps in the same order, so 1e-12,
on in-range, edge and out-of-range UVs; on the CPU it is the eager warp
bit for bit and never reaches the CUDA kernel (csrc/warp.cu).
deform_points: 1e-12, with a non-finite input and an envelope.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.lensdeform as t_deform
import mayamatchmovesolver_torch.ops.stmap as t_stmap
import mayamatchmovesolver_torch.ops.warp as t_warp
from mayamatchmovesolver_torch.utils.profiler import counters
import mayamatchmovesolver_tpu.models as j_models
import mayamatchmovesolver_tpu.ops.lensdeform as j_deform
import mayamatchmovesolver_tpu.ops.stmap as j_stmap
import mayamatchmovesolver_tpu.ops.warp as j_warp
from _torch_port_cases import to_numpy
from _torch_stmap_emulation import emulated_launches
from _torch_stmap_models import FILM_BACK, MODELS

ATOL = 2e-5
WARP_TOL = 1e-12
WIDTH, HEIGHT = 200, 100
STACKS = {
    "two": ("classic", "radial_deg4"),
    "three": ("anamorphic_deg4", "classic", "anamorphic_deg4_rescaled"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(pkg, names, scale=0.3, dtype=torch.float32):
    """The stack's models with their distortion terms scaled down (a
    stack of full-strength lenses folds the image over); float64 in JAX
    and, unless `dtype` says otherwise, float32 in the port, whose
    first layer takes float32 models as its kernel does."""
    out = []
    for name in names:
        cls_name, params = MODELS[name]
        neutral = ("anamorphic_squeeze", "squeeze_x", "squeeze_y", "rescale",
                   "lens_rotation", "cylindric_direction")
        params = {k: (v if k in neutral else v * scale)
                  for k, v in params.items()}
        if pkg == "jax":
            out.append(getattr(j_models, cls_name).create(**params))
        else:
            out.append(getattr(t_models, cls_name).create(
                **params, device="cpu", dtype=dtype))
    if pkg == "jax":
        return out, j_models.FilmBack.create(**FILM_BACK)
    return out, t_models.FilmBack.create(**FILM_BACK, device="cpu",
                                         dtype=dtype)


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("stack", list(STACKS))
def test_stmap_stack_matches(stack, direction):
    t_stack, t_fb = _models("torch", STACKS[stack])
    j_stack, j_fb = _models("jax", STACKS[stack])
    got = t_stmap.stmap(t_stack, t_fb, WIDTH, HEIGHT, direction,
                        device="cpu")
    assert got.shape == (HEIGHT, WIDTH, 4) and got.dtype == torch.float32
    assert torch.equal(got, t_stmap.stmap_stack(
        tuple(t_stack), t_fb, WIDTH, HEIGHT, direction, device="cpu"))
    xla = np.asarray(j_stmap.stmap_stack(j_stack, j_fb, WIDTH, HEIGHT,
                                         direction, use_pallas=False))
    np.testing.assert_allclose(to_numpy(got), xla, atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_stmap.stmap(j_stack, j_fb, WIDTH, HEIGHT,
                                          direction))
    np.testing.assert_allclose(to_numpy(got), pallas, atol=ATOL)
    # A stack is not its first layer, and the order matters.
    first = t_stmap.stmap(t_stack[0], t_fb, WIDTH, HEIGHT, direction,
                          device="cpu")
    assert float((got - first).abs().max()) > 1e-3
    swapped = t_stmap.stmap(t_stack[::-1], t_fb, WIDTH, HEIGHT, direction,
                            device="cpu")
    assert float((got - swapped).abs().max()) > 1e-5
    np.testing.assert_array_equal(to_numpy(got[..., 2]), 0.0)
    np.testing.assert_array_equal(to_numpy(got[..., 3]), 1.0)


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("stack", list(STACKS))
def test_stack_through_the_layer_kernel_arithmetic_matches(stack, direction):
    """The CUDA route of stmap_stack, emulated: a distort stack's first
    layer by the kernel's arithmetic from the pixel index, every further
    layer by its layer variant from the map before it, an undistort
    stack by the fused kernel's layers in registers, against the
    all-plain stack and
    the JAX stack (its first layer through the Pallas kernel in interpret
    mode, and all in XLA).  2e-5: float32 against float32 and float64,
    another operation order in every layer."""
    t_stack, t_fb = _models("torch", STACKS[stack])
    j_stack, j_fb = _models("jax", STACKS[stack])
    got = emulated_launches(t_stack, t_fb, WIDTH, HEIGHT, direction)
    assert got.shape == (HEIGHT, WIDTH, 4) and got.dtype == np.float32
    plain = t_stmap.stmap_stack_torch(t_stack, t_fb, WIDTH, HEIGHT,
                                      direction, device="cpu")
    np.testing.assert_allclose(got, to_numpy(plain), atol=ATOL)
    xla = np.asarray(j_stmap.stmap_stack(j_stack, j_fb, WIDTH, HEIGHT,
                                         direction, use_pallas=False))
    np.testing.assert_allclose(got, xla, atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_stmap.stmap_stack(j_stack, j_fb, WIDTH, HEIGHT,
                                                direction))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_array_equal(got[..., 2:], to_numpy(plain[..., 2:]))


def test_stmap_stack_torch_is_the_layers_in_order():
    """stmap_stack_torch is stmap_torch then stmap_layer_torch a layer,
    which leaves its input alone; a Passthrough layer changes the map by
    float32 round-off only; on the CPU stmap_stack is this function."""
    t_stack, fb = _models("torch", STACKS["three"])
    for direction in ("distort", "undistort"):
        order = t_stack if direction == "distort" else t_stack[::-1]
        first = t_stmap.stmap_torch(order[0], fb, 40, 20, direction,
                                    device="cpu")
        want, kept = first, first.clone()
        for model in order[1:]:
            want = t_stmap.stmap_layer_torch(want, model, fb, direction)
        assert torch.equal(first, kept) and want is not first
        got = t_stmap.stmap_stack_torch(t_stack, fb, 40, 20, direction,
                                        device="cpu")
        assert torch.equal(got, want)
        assert torch.equal(got, t_stmap.stmap_stack(
            t_stack, fb, 40, 20, direction, device="cpu"))
        padded = [t_stack[0], t_models.Passthrough(), *t_stack[1:]]
        np.testing.assert_allclose(
            to_numpy(t_stmap.stmap_stack_torch(padded, fb, 40, 20, direction,
                                               device="cpu")),
            to_numpy(got), atol=1e-6)


def test_stmap_stack_edge_cases():
    (model, _), fb = _models("torch", STACKS["two"])
    empty = t_stmap.stmap([], fb, 16, 8, device="cpu")
    ident = t_stmap.stmap(t_models.Passthrough(), fb, 16, 8, device="cpu")
    assert torch.equal(empty, ident)
    one = t_stmap.stmap([model], fb, 16, 8, "undistort", device="cpu")
    assert torch.equal(one, t_stmap.stmap(model, fb, 16, 8, "undistort",
                                          device="cpu"))
    # Undistorting through the stack undoes distorting through it.
    stack, fb = _models("torch", STACKS["two"], dtype=torch.float64)
    pts = torch.as_tensor([[0.2, 0.1], [-0.3, 0.25]], dtype=torch.float64)
    there = t_models.distort(stack[1], fb, t_models.distort(stack[0], fb, pts))
    back = t_models.undistort(stack[0], fb,
                              t_models.undistort(stack[1], fb, there))
    np.testing.assert_allclose(to_numpy(back), to_numpy(pts), atol=1e-8)
    launches = counters["stmap.launches"]
    t_stmap.stmap([model, model], _models("torch", ())[1], 16, 8,
                  device="cpu")
    assert counters["stmap.launches"] == launches


def _image_and_uv(seed=0):
    rng = np.random.RandomState(seed)
    image = rng.uniform(0.0, 1.0, (7, 9, 3))
    uv = rng.uniform(-0.3, 1.3, (5, 6, 2))  # a third out of range
    # Pixel centres (a hair inside: at the centre itself the floor
    # turns on the last bit), the four corners and the edges' outsides.
    uv[0, :, 0] = (np.arange(6) + 0.5) / 9 + 1e-9
    uv[0, :, 1] = 1.0 - (np.arange(6) + 0.5) / 7 - 1e-9
    uv[1, :4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]]
    uv[2, :4] = [[-5.0, 0.5], [5.0, 0.5], [0.5, -5.0], [0.5, 5.0]]
    return image, uv


def test_warp_image_matches():
    image, uv = _image_and_uv()
    want = np.asarray(j_warp.warp_image(jnp.asarray(image), jnp.asarray(uv)))
    got = t_warp.warp_image(torch.as_tensor(image), torch.as_tensor(uv))
    assert got.shape == (5, 6, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=WARP_TOL)
    # Pixel centres return the pixels.  Outside the image the indices
    # are clamped, the weights are not (the reference's arithmetic): far
    # left at weight 0.5 blends columns 0 and 1, far below holds row 6.
    np.testing.assert_allclose(to_numpy(got[0]), image[np.arange(6),
                                                       np.arange(6)],
                               atol=1e-7)
    np.testing.assert_allclose(to_numpy(got[2, 0]),
                               0.5 * (image[3, 0] + image[3, 1]), atol=1e-12)
    np.testing.assert_allclose(to_numpy(got[2, 2]), image[6, 4], atol=1e-12)
    # u and v of any broadcastable shape, as the reference's sampler.
    u = torch.as_tensor(uv[0, :, 0])
    v = torch.as_tensor(uv[:, 0, 1])[:, None]
    want = np.asarray(j_warp._bilinear_sample(
        jnp.asarray(image), jnp.asarray(u.numpy()), jnp.asarray(v.numpy())))
    np.testing.assert_allclose(
        to_numpy(t_warp._bilinear_sample(torch.as_tensor(image), u, v)),
        want, rtol=0, atol=WARP_TOL)


def test_warp_through_the_identity_map():
    """v is up in warp_image and the exported map's rows run the other
    way, so the Passthrough map returns the image with its rows
    reversed, in both packages; a v-up identity returns the image.  The
    map samples pixel centres, where the floor turns on float32's last
    bit; that shows only in the first column and the source's first row
    (their clamped neighbour is another pixel), which are left out."""
    image = torch.as_tensor(_image_and_uv(1)[0], dtype=torch.float32)
    fb = t_models.FilmBack.create(**FILM_BACK, device="cpu",
                                  dtype=torch.float32)
    ident = t_stmap.stmap(t_models.Passthrough(), fb, 9, 7, device="cpu")
    got = to_numpy(t_warp.warp_image(image, ident))
    np.testing.assert_allclose(got[:-1, 1:], to_numpy(image.flip(0))[:-1, 1:],
                               atol=1e-6)
    j_ident = j_stmap.stmap_xla(j_models.Passthrough(),
                                j_models.FilmBack.create(**FILM_BACK), 9, 7)
    want = np.asarray(j_warp.warp_image(jnp.asarray(image.numpy()), j_ident))
    np.testing.assert_allclose(got[:-1, 1:], want[:-1, 1:], atol=1e-6)
    v_up = ident.clone()
    v_up[..., 1] = 1.0 - ident[..., 1]
    np.testing.assert_allclose(
        to_numpy(t_warp.warp_image(image, v_up))[1:, 1:],
        to_numpy(image)[1:, 1:], atol=1e-6)


def _eager_warp(image, u, v):
    """ops/warp.py::_bilinear_sample as it stands, written out again: the
    CPU's warp_image has to give exactly this."""
    h, w = image.shape[:2]
    x, y = u * w - 0.5, (1.0 - v) * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    xa = torch.clamp(x0.to(torch.int64), 0, w - 1)
    xb = torch.clamp(xa + 1, 0, w - 1)
    ya = torch.clamp(y0.to(torch.int64), 0, h - 1)
    yb = torch.clamp(ya + 1, 0, h - 1)
    top = image[ya, xa] * (1.0 - fx) + image[ya, xb] * fx
    bottom = image[yb, xa] * (1.0 - fx) + image[yb, xb] * fx
    return top * (1.0 - fy) + bottom * fy


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_image_on_cpu_is_the_eager_warp(channels, dtype):
    """On the CPU warp_image is the eager warp, bit for bit: for a map of
    another size, with 2 or 4 channels, contiguous or a slice, and UVs
    1.5 px past every edge."""
    rng = np.random.RandomState(channels)
    image = torch.as_tensor(rng.uniform(0.0, 1.0, (7, 9, channels)),
                            dtype=dtype)
    uv = np.stack([rng.uniform(-1.5 / 9, 1 + 1.5 / 9, (5, 12)),
                   rng.uniform(-1.5 / 7, 1 + 1.5 / 7, (5, 12))], -1)
    uv[2, 3] = np.nan
    two = torch.as_tensor(uv, dtype=dtype)
    four = torch.cat([two, torch.zeros_like(two[..., :1]),
                      torch.ones_like(two[..., :1])], -1)
    for st_map in (two, four, four[:, ::2], two.transpose(0, 1)):
        got = t_warp.warp_image(image, st_map)
        want = _eager_warp(image, st_map[..., 0], st_map[..., 1])
        assert got.dtype == dtype
        assert got.shape == st_map.shape[:2] + (channels,)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_warp_image_on_cpu_builds_no_kernel(monkeypatch):
    """The CPU's warp neither builds nor loads csrc/warp.cu, and counts
    no launch."""
    from mayamatchmovesolver_torch import _kernels

    def refuse(*args):
        raise AssertionError("the CPU warp reached the CUDA kernels")

    monkeypatch.setattr(_kernels, "build", refuse)
    monkeypatch.setattr(_kernels, "load", refuse)
    monkeypatch.setattr(_kernels, "warp_function", refuse)
    launches = counters["warp.launches"]
    image, uv = _image_and_uv(3)
    for dtype in (torch.float32, torch.float64):
        got = t_warp.warp_image(torch.as_tensor(image, dtype=dtype),
                                torch.as_tensor(uv, dtype=dtype))
        assert got.shape == (5, 6, 3) and got.dtype == dtype
    (model, _), fb = _models("torch", STACKS["two"], scale=1.0)
    t_warp.warp_image_with_lens(torch.as_tensor(image, dtype=torch.float32),
                                model, fb, "undistort")
    assert counters["warp.launches"] == launches


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_warp_image_with_lens_matches(direction):
    image, _ = _image_and_uv(2)
    (t_model, _), t_fb = _models("torch", STACKS["two"], scale=1.0)
    (j_model, _), j_fb = _models("jax", STACKS["two"], scale=1.0)
    want = np.asarray(j_warp.warp_image_with_lens(
        jnp.asarray(image), j_model, j_fb, direction, out_width=12,
        out_height=10))
    got = t_warp.warp_image_with_lens(
        torch.as_tensor(image), t_model, t_fb, direction, out_width=12,
        out_height=10)
    assert got.shape == (10, 12, 3)
    # The map is float32 in both packages: 2e-5 of a 9-pixel-wide image
    # under gradients of at most 1 per pixel.
    np.testing.assert_allclose(to_numpy(got), want, atol=9 * ATOL)
    same_size = t_warp.warp_image_with_lens(torch.as_tensor(image), t_model,
                                            t_fb, direction)
    assert same_size.shape == image.shape


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_deform_points_matches(direction):
    rng = np.random.RandomState(3)
    points = rng.uniform(-0.45, 0.45, (11, 3))
    points[4, 0] = np.nan
    points[7, 1] = np.inf
    (t_model, _), t_fb = _models("torch", STACKS["two"], scale=1.0,
                                 dtype=torch.float64)
    (j_model, _), j_fb = _models("jax", STACKS["two"], scale=1.0)
    for envelope in (1.0, 0.35):
        want = np.asarray(j_deform.deform_points(
            j_model, j_fb, jnp.asarray(points), envelope, direction))
        got = to_numpy(t_deform.deform_points(
            t_model, t_fb, torch.as_tensor(points), envelope, direction))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   equal_nan=True)
        np.testing.assert_array_equal(got[:, 2], points[:, 2])
        # A non-finite coordinate falls back to the input and poisons
        # no other point.
        assert not np.isfinite(got[4, 0]) and not np.isfinite(got[7, 1])
        assert np.isfinite(np.delete(got, [4, 7], axis=0)).all()
    xy = torch.as_tensor(points[:4, :2])
    np.testing.assert_allclose(
        to_numpy(t_deform.evaluate_lens(t_model, t_fb, xy, direction)),
        np.asarray(j_deform.evaluate_lens(j_model, j_fb,
                                          jnp.asarray(points[:4, :2]),
                                          direction)),
        rtol=0, atol=1e-12)
