"""The torch port's ST-map export against the JAX package's TPU kernel.

On the CPU the port's plain version, stmap_torch, runs in float32 and is
held against the JAX Pallas kernel itself (stmap_pallas in TPU interpret
mode) and against its XLA oracle, for the four 3DE models in both
directions at a ragged 200x100, at the 2e-5 of
tests/test_ops/test_stmap.py.  The CUDA kernel cannot run here: its
host-side parameter packing is checked by a float32 numpy transcription
of csrc/stmap.cu's arithmetic, and the kernel itself against the plain
version by tests/test_torch/test_torch_cuda.py, on the card.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.stmap as t_stmap
import mayamatchmovesolver_tpu.models as j_models
import mayamatchmovesolver_tpu.ops.stmap as j_stmap
from _torch_port_cases import to_numpy
from _torch_stmap_models import FILM_BACK, MODELS, torch_model

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


def _emulate_kernel(core_id, params, width, height, distort, iterations):
    """csrc/stmap.cu's per-pixel arithmetic, transcribed to float32 numpy
    over the whole image, reading the same 27 host parameters."""
    f = np.float32
    p = params.astype(np.float32)
    c, m_in, m_out = p[:10], p[10:14], p[14:18]
    fbw, fbh, lcox, lcoy, radius = p[18:23]

    def core(x, y):
        x2, y2 = x * x, y * y
        if core_id == t_stmap._CORE_CLASSIC:
            x4, y4, xy2 = x2 * x2, y2 * y2, x2 * y2
            return (x * (f(1) + c[0] * x2 + c[1] * y2 + c[4] * x4
                         + f(2) * c[4] * xy2 + c[4] * y4),
                    y * (f(1) + c[2] * x2 + c[3] * y2 + c[5] * x4
                         + f(2) * c[5] * xy2 + c[5] * y4))
        r2 = x2 + y2
        r4 = r2 * r2
        if core_id == t_stmap._CORE_RADIAL_DEG4:
            radial = f(1) + c[0] * r2 + c[3] * r4
            u, v = c[1] + c[4] * r2, c[2] + c[5] * r2
            return (x * radial + (r2 + f(2) * x2) * u + f(2) * x * y * v,
                    y * radial + (r2 + f(2) * y2) * v + f(2) * x * y * u)
        cos2 = (x2 - y2) / np.maximum(r2, f(1e-30))
        cos4 = f(2) * cos2 * cos2 - f(1)
        fx = (f(1) + c[0] * r2 + c[4] * r4 + cos2 * (c[2] * r2 + c[6] * r4)
              + cos4 * c[8] * r4)
        fy = (f(1) + c[1] * r2 + c[5] * r4 + cos2 * (c[3] * r2 + c[7] * r4)
              + cos4 * c[9] * r4)
        return x * fx, y * fy

    rows, cols = np.meshgrid(np.arange(height, dtype=f),
                             np.arange(width, dtype=f), indexing="ij")
    x_dn = (((cols + f(0.5)) / f(width) - f(0.5)) * fbw - lcox) / radius
    y_dn = (((rows + f(0.5)) / f(height) - f(0.5)) * fbh - lcoy) / radius
    tx = m_in[0] * x_dn + m_in[1] * y_dn
    ty = m_in[2] * x_dn + m_in[3] * y_dn
    qx, qy = core(tx, ty)
    if distort:
        qx, qy = tx - (qx - tx), ty - (qy - ty)
        for _ in range(iterations):
            fx, fy = core(qx, qy)
            qx, qy = qx + (tx - fx), qy + (ty - fy)
    ox = m_out[0] * qx + m_out[1] * qy
    oy = m_out[2] * qx + m_out[3] * qy
    s = (ox * radius + fbw * f(0.5) + lcox) / fbw
    t = (oy * radius + fbh * f(0.5) + lcoy) / fbh
    return np.stack([s, t, np.zeros_like(s), np.ones_like(s)], axis=-1)


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_parameters_reproduce_plain_version(name, direction):
    """The host half of stmap_cuda: the pre/post matrices equal the JAX
    package's _model_kernel_config, and the 27 packed floats, run
    through the kernel's arithmetic, give the plain version's map."""
    model, fb = torch_model(name)
    _, _, pre, post = t_stmap._model_kernel_config(
        t_stmap._to_host(model), t_stmap._to_host(fb))
    j_model, j_fb = jax_model(name)
    _, _, j_pre, j_post = j_stmap._model_kernel_config(j_model, j_fb)
    np.testing.assert_allclose(pre, j_pre, atol=1e-6)
    np.testing.assert_allclose(post, j_post, atol=1e-6)

    core_id, params = t_stmap._kernel_params(model, fb, direction)
    assert params.shape == (27,) and params.dtype == np.float32
    emulated = _emulate_kernel(
        core_id, params, WIDTH, HEIGHT, direction == "distort",
        t_models.base.DISTORT_INVERSE_ITERATIONS)
    plain = to_numpy(t_stmap.stmap_torch(model, fb, WIDTH, HEIGHT,
                                         direction, device="cpu"))
    np.testing.assert_allclose(emulated, plain, atol=ATOL)


def test_stmap_on_cpu_is_the_plain_version():
    model, fb = torch_model("classic")
    launches = t_stmap.stmap_cuda.launches
    got = t_stmap.stmap(model, fb, 64, 32, "undistort", device="cpu")
    want = t_stmap.stmap_torch(model, fb, 64, 32, "undistort", device="cpu")
    assert torch.equal(got, want)
    ident = t_stmap.stmap(t_models.Passthrough(), fb, 64, 32, device="cpu")
    xs = (np.arange(64) + 0.5) / 64
    np.testing.assert_allclose(to_numpy(ident)[5, :, 0], xs, atol=1e-6)
    assert t_stmap.stmap_cuda.launches == launches


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
