"""Agreement of the port's Euler extraction, matrix decomposition and
single-attribute reads and writes with the JAX package.

matrix_to_euler and decompose_matrix for all six rotate orders at 1e-10
(float64) and as round trips; gather_attr_values_static and
set_attr_values for static and animated codes, with and without
frame_indices, and the refusal of ATTR_NONE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.core.transform as t_tfm
import mayamatchmovesolver_torch.scene.attrblock as t_attr
import mayamatchmovesolver_tpu.core.transform as j_tfm
import mayamatchmovesolver_tpu.scene.attrblock as j_attr
from _torch_port_cases import rich_scene, to_numpy

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _angles(seed, n=7):
    """Angles away from gimbal lock (|middle angle| < 80 degrees)."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n),
            rng.uniform(-170, 170, n))


def _middle_axis_bounded(order, angles):
    """The angles with the bounded one on the order's middle axis."""
    from mayamatchmovesolver_tpu.core.constants import ROTATE_ORDER_PERMS

    i, j, k = ROTATE_ORDER_PERMS[order]
    by_axis = [None] * 3
    by_axis[i], by_axis[j], by_axis[k] = angles[0], angles[1], angles[2]
    return by_axis


@pytest.mark.parametrize("order", range(6))
def test_matrix_to_euler_matches_and_round_trips(order):
    rx, ry, rz = _middle_axis_bounded(order, _angles(order))
    j_r = j_tfm.euler_to_rotation_matrix(
        jnp.asarray(rx), jnp.asarray(ry), jnp.asarray(rz), order)
    t_r = t_tfm.euler_to_rotation_matrix(
        torch.as_tensor(rx), torch.as_tensor(ry), torch.as_tensor(rz),
        torch.tensor(order))
    np.testing.assert_allclose(to_numpy(t_r), np.asarray(j_r), atol=TOL)
    want = np.asarray(j_tfm.matrix_to_euler(j_r, order))
    got = to_numpy(t_tfm.matrix_to_euler(t_r, order))
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, np.stack([rx, ry, rz], -1), atol=1e-9)


def test_matrix_to_euler_takes_an_order_per_matrix():
    orders = np.arange(6)
    rx, ry, rz = (np.full(6, 10.0), np.full(6, -20.0), np.full(6, 30.0))
    j_r = j_tfm.euler_to_rotation_matrix(
        jnp.asarray(rx), jnp.asarray(ry), jnp.asarray(rz),
        jnp.asarray(orders))
    want = np.asarray(j_tfm.matrix_to_euler(j_r, jnp.asarray(orders)))
    got = to_numpy(t_tfm.matrix_to_euler(
        torch.as_tensor(np.array(j_r)), torch.as_tensor(orders)))
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, np.stack([rx, ry, rz], -1), atol=1e-9)


@pytest.mark.parametrize("order", range(6))
def test_decompose_matrix_matches_and_round_trips(order):
    rng = np.random.RandomState(10 + order)
    n = 5
    t = rng.uniform(-5, 5, (n, 3))
    s = rng.uniform(0.5, 2.0, (n, 3))
    rx, ry, rz = _middle_axis_bounded(order, _angles(20 + order, n))
    args = [t[:, 0], t[:, 1], t[:, 2], rx, ry, rz, s[:, 0], s[:, 1], s[:, 2]]
    j_m = j_tfm.trs_matrix(*[jnp.asarray(a) for a in args], order)
    t_m = t_tfm.trs_matrix(*[torch.as_tensor(a) for a in args],
                           torch.tensor(order))
    np.testing.assert_allclose(to_numpy(t_m), np.asarray(j_m), atol=TOL)
    want = j_tfm.decompose_matrix(j_m, order)
    got = t_tfm.decompose_matrix(t_m, order)
    for g, w, truth in zip(got, want, (t, np.stack([rx, ry, rz], -1), s)):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=TOL)
        np.testing.assert_allclose(to_numpy(g), truth, atol=1e-9)


@pytest.fixture(scope="module")
def blocks():
    _, _, j_at, _, j_h = rich_scene("jax")
    _, _, t_at, _, t_h = rich_scene("torch")
    return j_at, t_at, j_h, t_h


@pytest.mark.parametrize("frame", [0, 3])
def test_gather_attr_values_static_matches(blocks, frame):
    j_at, t_at, j_h, _ = blocks
    cam = j_h["cams"][0]
    codes = np.array([cam.attr("tx").code, cam.attr("ty").code,
                      cam.attr("focal_length_mm").code, j_attr.ATTR_NONE,
                      j_h["chain"][1].attr("ty").code])
    want = np.asarray(j_attr.gather_attr_values_static(
        j_at, jnp.asarray(codes), frame))
    got = t_attr.gather_attr_values_static(t_at, torch.as_tensor(codes),
                                           frame)
    assert got.shape == (5,) and float(got[3]) == 0.0
    np.testing.assert_allclose(to_numpy(got), want, atol=TOL)


@pytest.mark.parametrize("case", ["static", "animated", "animated_frames"])
def test_set_attr_values_matches(blocks, case):
    j_at, t_at, j_h, _ = blocks
    cam = j_h["cams"][0]
    if case == "static":
        code, values, frames = cam.attr("ty").code, 2.5, None
    elif case == "animated":
        code, values, frames = (cam.attr("tx").code,
                                np.array([1.0, 2.0, 3.0, 4.0]), None)
    else:
        code, values, frames = (cam.attr("tx").code, np.array([9.0, 8.0]),
                                [3, 1])
    j_out = j_attr.set_attr_values(j_at, code, values, frames)
    t_out = t_attr.set_attr_values(t_at, code, values, frames)
    for field in ("static_values", "anim_values"):
        np.testing.assert_allclose(to_numpy(getattr(t_out, field)),
                                   np.asarray(getattr(j_out, field)),
                                   atol=TOL)
    # Out of place: the input block keeps its values.
    assert not torch.equal(
        torch.cat([t_out.static_values, t_out.anim_values.reshape(-1)]),
        torch.cat([t_at.static_values, t_at.anim_values.reshape(-1)]))
    assert t_out.static_values.dtype == t_at.static_values.dtype


def test_set_attr_values_takes_a_tensor_and_refuses_attr_none(blocks):
    _, t_at, _, t_h = blocks
    code = t_h["cams"][0].attr("tx").code
    out = t_attr.set_attr_values(t_at, code, torch.tensor([5.0, 6.0]), [0, 2])
    row = out.anim_values[code // 2]
    assert float(row[0]) == 5.0 and float(row[2]) == 6.0
    assert float(row[1]) == float(t_at.anim_values[code // 2, 1])
    with pytest.raises(ValueError, match="ATTR_NONE"):
        t_attr.set_attr_values(t_at, t_attr.ATTR_NONE, 1.0)
