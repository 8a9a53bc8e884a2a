"""Half-float plates and a spherical 3DE4 lens file in the port, on the
CPU, against plain references that import nothing of the port.

ops/warp.py::warp_image on a float16 image through a float32 map: a
float32 result, the JAX package's promotion of the same inputs, and the
benchmark's plain float64 warp (mmbench/reference/stmap.py) to float32's
rounding of the blend (1e-6), at UVs 1.5 px past every edge.

A lens file of LD_3DE4_Radial_Standard_Degree_4 nodes with seeded random
knobs, every coefficient a curve with a key a frame, the lens centre off
the film back's centre, through io/lensfile.py's models_at and
ops/stmap.py::stmap, in both directions, against the plain float64
radial lens (mmbench/reference/radial.py): the dispatcher's CPU path (a
float32 grid) within 2e-6 in UV, the plain version on a float64 grid
within 1e-7 (the map is float32); a two-layer stack; and the reference's
lens against models/tde.py's radial model point for point.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_tpu.ops.warp as j_warp
from mayamatchmovesolver_torch.io import lensfile
from mayamatchmovesolver_torch.models import tde
from mayamatchmovesolver_torch.ops import stmap, warp
from mmbench.reference import radial as plain
from mmbench.reference import stmap as plain_stmap

WIDTH, HEIGHT = 64, 44
FRAMES = (1, 5)
NODE = "LD_3DE4_Radial_Standard_Degree_4"
# Each knob's field in models/tde.py's TdeRadialStdDeg4 and the
# half-width of its seeded draw.
SPREAD = {"Distortion_Degree_2": ("degree2_distortion", 0.08),
          "U_Degree_2": ("degree2_u", 0.01),
          "V_Degree_2": ("degree2_v", 0.01),
          "Quartic_Distortion_Degree_4": ("degree4_distortion", 0.02),
          "U_Degree_4": ("degree4_u", 0.004),
          "V_Degree_4": ("degree4_v", 0.004),
          "Phi_Cylindric_Direction": ("cylindric_direction", 60.0),
          "B_Cylindric_Bending": ("cylindric_bending", 0.05)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _half_image_and_map(channels, seed):
    """A float16 (7, 9, channels) image and a float32 (5, 12, 4) map
    whose UVs reach 1.5 px past every edge."""
    rng = np.random.RandomState(seed)
    image = rng.uniform(0.0, 1.0, (7, 9, channels)).astype(np.float16)
    uv = np.stack([rng.uniform(-1.5 / 9, 1 + 1.5 / 9, (5, 12)),
                   rng.uniform(-1.5 / 7, 1 + 1.5 / 7, (5, 12)),
                   np.zeros((5, 12)), np.ones((5, 12))], -1)
    return image, uv.astype(np.float32)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_half_image_warps_to_float32_as_the_reference_promotes(channels):
    image, st_map = _half_image_and_map(channels, 40 + channels)
    got = warp.warp_image(torch.as_tensor(image), torch.as_tensor(st_map))
    assert got.dtype == torch.float32 and got.shape == (5, 12, channels)
    want = np.asarray(j_warp.warp_image(jnp.asarray(image),
                                        jnp.asarray(st_map)))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    wide = plain_stmap.warp(torch.as_tensor(image), torch.as_tensor(st_map),
                            torch.float64)
    assert float((got.double() - wide).abs().max()) < 1e-6
    # The half image is read as it is: the float32 copy of its values
    # warps to the same output.
    again = warp.warp_image(torch.as_tensor(image).float(),
                            torch.as_tensor(st_map))
    assert torch.equal(got, again)


def _random_knobs(seed):
    """{knob: {frame: value}}: every knob a curve with a key a frame."""
    rng = np.random.RandomState(seed)
    return {name: {f: float(rng.uniform(-spread, spread))
                   if name != "B_Cylindric_Bending"
                   else float(rng.uniform(0.0, spread))
                   for f in range(FRAMES[0], FRAMES[1] + 1)}
            for name, (_, spread) in SPREAD.items()}


def _nuke(nodes, film_back_cm=(3.59, 2.4), offset_cm=(0.015, -0.01)):
    """A Nuke script of radial lens nodes (each a dict of knobs), every
    number written to its last digit."""
    lines = []
    for knobs in nodes:
        lines += ["%s {" % NODE,
                  " tde4_filmback_width_cm %r" % film_back_cm[0],
                  " tde4_filmback_height_cm %r" % film_back_cm[1],
                  " tde4_lens_center_offset_x_cm %r" % offset_cm[0],
                  " tde4_lens_center_offset_y_cm %r" % offset_cm[1],
                  " tde4_pixel_aspect 1.0"]
        for name, curve in knobs.items():
            keys = " ".join("x%d %r" % kv for kv in sorted(curve.items()))
            lines.append(" %s {{curve %s }}" % (name, keys))
        lines.append("}")
    return "\n".join(lines) + "\n"


def _plain_map(text, frame, direction):
    nodes = [plain.at_frame(knobs, frame)
             for _, knobs in plain.read_nuke(text)]
    return plain.stmap(nodes, plain.camera_of(nodes[0]), WIDTH, HEIGHT,
                       direction)


def _max_diff(got, want):
    return float((got.double() - want).abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_models_at_to_stmap_matches_the_plain_radial_lens(direction, seed):
    knobs = _random_knobs(200 + seed)
    text = _nuke([knobs])
    layers = lensfile.parse_string(text)
    fb = layers.film_back()
    for frame in (FRAMES[0], 3, FRAMES[1]):
        (model,) = layers.models_at(frame)
        assert isinstance(model, tde.TdeRadialStdDeg4)
        assert {field: getattr(model, field)
                for field, _ in SPREAD.values()} == {
            field: knobs[name][frame]
            for name, (field, _) in SPREAD.items()}
        want = _plain_map(text, frame, direction)
        got = stmap.stmap([model], fb, WIDTH, HEIGHT, direction,
                          device="cpu")
        assert got.dtype == torch.float32 and got.shape == (HEIGHT, WIDTH, 4)
        assert _max_diff(got, want) < 2e-6
        fine = stmap.stmap_torch(model, fb, WIDTH, HEIGHT, direction,
                                 device="cpu", dtype=torch.float64)
        assert _max_diff(fine, want) < 1e-7
        # The lens moves the map, and its cylindric extender moves it too.
        identity = plain.stmap([{}], plain.camera_of(plain.at_frame(
            plain.read_nuke(text)[0][1], frame)), WIDTH, HEIGHT, direction)
        assert _max_diff(got, identity) > 1e-3
        flat = dataclasses.replace(model, cylindric_direction=0.0,
                                   cylindric_bending=0.0)
        assert _max_diff(stmap.stmap([flat], fb, WIDTH, HEIGHT, direction,
                                     device="cpu"), want) > 1e-4


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_two_layer_radial_stack_matches_the_plain_stack(direction):
    """Distortion through the layers in order, undistortion through them
    in reverse: the stack differs from either layer alone."""
    text = _nuke([_random_knobs(7), _random_knobs(8)])
    layers = lensfile.parse_string(text)
    models = layers.models_at(4)
    want = _plain_map(text, 4, direction)
    got = stmap.stmap(models, layers.film_back(), WIDTH, HEIGHT, direction,
                      device="cpu")
    assert _max_diff(got, want) < 2e-6
    for one in models:
        alone = stmap.stmap([one], layers.film_back(), WIDTH, HEIGHT,
                            direction, device="cpu")
        assert _max_diff(alone, want) > 1e-4


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_the_plain_radial_lens_is_the_ports_model(direction):
    """reference/radial.py's lens in diagonally normalised coordinates
    against models/tde.py's TdeRadialStdDeg4 in float64 (the port's
    distort is its fixed point, the reference's Newton's method)."""
    knobs = {name: curve[2] for name, curve in _random_knobs(5).items()}
    model = tde.TdeRadialStdDeg4.create(
        device="cpu", dtype=torch.float64,
        **{field: knobs[name] for name, (field, _) in SPREAD.items()})
    rng = np.random.RandomState(6)
    points = torch.as_tensor(rng.uniform(-0.9, 0.9, (500, 2)))
    port = (tde.distort_dn if direction == "distort"
            else tde.undistort_dn)(model, points)
    ours = (plain.distort_dn if direction == "distort"
            else plain.undistort_dn)(points, knobs)
    assert float((port - ours).abs().max()) < 1e-12
    assert float((ours - points).abs().max()) > 1e-3
