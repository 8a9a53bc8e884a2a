"""A lens file of two layers of different kinds in the port, on the CPU,
against the benchmark's plain stack (mmbench/reference/stack.py), which
imports nothing of the port.

A Nuke script of an LD_3DE4_Radial_Standard_Degree_4 node and an
LD_3DE_Classic_LD_Model node with seeded random knobs, every knob a curve
with a key a frame, the camera knobs on both nodes and the lens centre
off the film back's centre: io/lensfile.py's parse_string keeps the two
layers in file order, and models_at hands out both a frame; through
ops/stmap.py::stmap of the list (the CPU path, a float32 grid) the map
matches the plain float64 stack within 2e-6 in UV in both directions,
and the stack with its layers swapped or with either layer alone does
not, by 1e-4; the plain classic lens is models/tde.py's TdeClassic point
for point.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mayamatchmovesolver_torch.io import lensfile
from mayamatchmovesolver_torch.models import tde
from mayamatchmovesolver_torch.ops import stmap
from mayamatchmovesolver_torch.utils.profiler import counters
from mmbench.reference import stack as plain

REPO = pathlib.Path(__file__).resolve().parents[2]
WIDTH, HEIGHT = 64, 44
FRAMES = (1, 5)
FILM_BACK_CM, OFFSET_CM = (3.59, 2.4), (0.015, -0.01)
# Each node's knobs: the port's field and the centre and half-width of
# its seeded draw.
KNOBS = {
    plain.RADIAL: {
        "Distortion_Degree_2": ("degree2_distortion", 0.0, 0.06),
        "U_Degree_2": ("degree2_u", 0.0, 0.008),
        "V_Degree_2": ("degree2_v", 0.0, 0.008),
        "Quartic_Distortion_Degree_4": ("degree4_distortion", 0.0, 0.015),
        "U_Degree_4": ("degree4_u", 0.0, 0.003),
        "V_Degree_4": ("degree4_v", 0.0, 0.003),
        "Phi_Cylindric_Direction": ("cylindric_direction", 0.0, 60.0),
        "B_Cylindric_Bending": ("cylindric_bending", 0.02, 0.02)},
    plain.CLASSIC: {
        "Distortion": ("distortion", 0.0, 0.06),
        "Anamorphic_Squeeze": ("anamorphic_squeeze", 1.0, 0.08),
        "Curvature_X": ("curvature_x", 0.0, 0.02),
        "Curvature_Y": ("curvature_y", 0.0, 0.02),
        "Quartic_Distortion": ("quartic_distortion", 0.0, 0.015)},
}
STACK = (plain.RADIAL, plain.CLASSIC)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_knobs(node, seed):
    """{knob: {frame: value}}: every knob of `node` a curve with a key a
    frame."""
    rng = np.random.RandomState(seed)
    return {name: {f: float(centre + rng.uniform(-spread, spread))
                   for f in range(FRAMES[0], FRAMES[1] + 1)}
            for name, (_, centre, spread) in KNOBS[node].items()}


def _nuke(nodes):
    """A Nuke script of (node class, knobs) nodes, each with the camera
    knobs, every number written to its last digit."""
    lines = []
    for node, knobs in nodes:
        lines += ["%s {" % node,
                  " tde4_filmback_width_cm %r" % FILM_BACK_CM[0],
                  " tde4_filmback_height_cm %r" % FILM_BACK_CM[1],
                  " tde4_lens_center_offset_x_cm %r" % OFFSET_CM[0],
                  " tde4_lens_center_offset_y_cm %r" % OFFSET_CM[1],
                  " tde4_pixel_aspect 1.0"]
        for name, curve in knobs.items():
            keys = " ".join("x%d %r" % kv for kv in sorted(curve.items()))
            lines.append(" %s {{curve %s }}" % (name, keys))
        lines.append("}")
    return "\n".join(lines) + "\n"


def _stack(seed):
    return [(node, _random_knobs(node, seed + n))
            for n, node in enumerate(STACK)]


def _at(nodes, frame):
    return [(node, {name: curve[frame] for name, curve in knobs.items()})
            for node, knobs in nodes]


def _plain_map(nodes, frame, direction):
    camera = plain.Camera(FILM_BACK_CM, 1.0, OFFSET_CM)
    return plain.stmap(_at(nodes, frame), camera, WIDTH, HEIGHT, direction)


def _max_diff(got, want):
    return float((got.double() - want).abs().max())


def test_two_node_script_is_two_layers_in_file_order():
    nodes = _stack(300)
    layers = lensfile.parse_string(_nuke(nodes))
    assert [layer.model_type for layer in layers.layers] == [
        lensfile.NODE_TYPE_MAP[node] for node in STACK]
    fb = layers.film_back()
    assert (fb.film_back_width_cm, fb.film_back_height_cm,
            fb.lens_center_offset_x_cm, fb.lens_center_offset_y_cm,
            fb.pixel_aspect) == FILM_BACK_CM + OFFSET_CM + (1.0,)
    for frame in range(FRAMES[0], FRAMES[1] + 1):
        before = counters.copy()
        models = layers.models_at(frame)
        assert counters["lensfile.models_at"] == \
            before["lensfile.models_at"] + 1
        assert counters["lensfile.layers"] == before["lensfile.layers"] + 2
        assert [type(m) for m in models] == [tde.TdeRadialStdDeg4,
                                             tde.TdeClassic]
        for model, (node, knobs) in zip(models, _at(nodes, frame)):
            assert {field: getattr(model, field)
                    for field, _, _ in KNOBS[node].values()} == {
                field: knobs[name]
                for name, (field, _, _) in KNOBS[node].items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_models_at_to_stmap_matches_the_plain_stack(direction, seed):
    """Distortion through the layers in file order, undistortion through
    them in reverse: the dispatcher's CPU path against the plain float64
    stack; swapped, or either layer alone, it is another map."""
    nodes = _stack(310 + 10 * seed)
    layers = lensfile.parse_string(_nuke(nodes))
    fb = layers.film_back()
    for frame in (FRAMES[0], FRAMES[1]):
        models = layers.models_at(frame)
        want = _plain_map(nodes, frame, direction)
        got = stmap.stmap(models, fb, WIDTH, HEIGHT, direction, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (HEIGHT, WIDTH, 4)
        assert _max_diff(got, want) < 2e-6
        for wrong in (models[::-1], models[:1], models[1:]):
            other = stmap.stmap(wrong, fb, WIDTH, HEIGHT, direction,
                                device="cpu")
            assert _max_diff(other, want) > 1e-4


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_the_plain_classic_lens_is_the_ports_model(direction):
    """reference/stack.py's classic layer in diagonally normalised
    coordinates against models/tde.py's TdeClassic in float64 (the port's
    distort is its fixed point, the reference's Newton's method)."""
    knobs = {name: curve[2] for name, curve in
             _random_knobs(plain.CLASSIC, 5).items()}
    model = tde.TdeClassic.create(
        device="cpu", dtype=torch.float64,
        **{field: knobs[name]
           for name, (field, _, _) in KNOBS[plain.CLASSIC].items()})
    rng = np.random.RandomState(6)
    points = torch.as_tensor(rng.uniform(-0.9, 0.9, (500, 2)))
    port = (tde.distort_dn if direction == "distort"
            else tde.undistort_dn)(model, points)
    ours = (plain.distort_dn if direction == "distort"
            else plain.undistort_dn)(points, plain.CLASSIC, knobs)
    assert float((port - ours).abs().max()) < 1e-12
    assert float((ours - points).abs().max()) > 1e-3


def test_the_plain_stack_imports_nothing_of_the_port():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mmbench.reference.stack\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.startswith(('jax', 'mayamatchmovesolver'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
