"""A lens file's path to ST maps in the port: io/lensfile.py's
LensLayers.models_at and film_back, with Python float fields, through
ops/stmap.py::stmap on the CPU, against the plain float64 reference
plain_anamorphic.py (which imports nothing of the port).

Seeded random 3DE4 anamorphic lenses of degree 4, standard and rescaled,
animated and static knobs, at pixel aspect 1.0 and 1.8, in both
directions, at 64 x 44: the dispatcher's CPU path (a float32 grid)
within 2e-6 in UV, the plain version on a float64 grid within 1e-7 (the
map is float32).  Also a two-layer stack, the write -> parse round trip
of animated knobs (every digit), what a frame outside the curves gives,
the span and counters of models_at and no host read, the CLI's
lensdistort and image-warp verbs on a lens file, and that the
benchmark's copy of the reference is this one.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import plain_anamorphic as plain
from mayamatchmovesolver_torch import cli
from mayamatchmovesolver_torch.io import exr, lensfile
from mayamatchmovesolver_torch.ops import stmap, warp
from mayamatchmovesolver_torch.utils import profiler
from _torch_stmap_models import program_ranges

WIDTH, HEIGHT = 64, 44
FRAMES = (1, 5)
ROOT = pathlib.Path(__file__).resolve().parents[2]

# Each coefficient's knob and the half-width of its seeded draw.
SPREAD = dict(zip(plain.X_KNOBS + plain.Y_KNOBS,
                  (0.05, 0.02, 0.01, 0.005, 0.003) * 2))
NODES = {"standard": "LD_3DE4_Anamorphic_Standard_Degree_4",
         "rescaled": "LD_3DE4_Anamorphic_Rescaled_Degree_4"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_knobs(kind, seed):
    """{knob: value or {frame: value}}: every coefficient and the
    rotation a curve with a key a frame, the squeezes and the rescale
    static."""
    rng = np.random.RandomState(seed)

    def curve(spread):
        return {f: float(rng.uniform(-spread, spread))
                for f in range(FRAMES[0], FRAMES[1] + 1)}

    knobs = {name: curve(spread) for name, spread in SPREAD.items()}
    knobs["Lens_Rotation"] = curve(5.0)
    knobs["Squeeze_X"] = float(rng.uniform(0.95, 1.05))
    knobs["Squeeze_Y"] = float(rng.uniform(0.95, 1.05))
    if kind == "rescaled":
        knobs["Rescale"] = float(rng.uniform(0.95, 1.05))
    return knobs


def _nuke(nodes, pixel_aspect, film_back_cm=(3.67, 2.554),
          offset_cm=(0.01, -0.02)):
    """A Nuke script of lens nodes [(class, knobs)], every number written
    to its last digit."""
    lines = []
    for node, knobs in nodes:
        lines += ["%s {" % node,
                  " tde4_filmback_width_cm %r" % film_back_cm[0],
                  " tde4_filmback_height_cm %r" % film_back_cm[1],
                  " tde4_lens_center_offset_x_cm %r" % offset_cm[0],
                  " tde4_lens_center_offset_y_cm %r" % offset_cm[1],
                  " tde4_pixel_aspect %r" % pixel_aspect]
        for name, value in knobs.items():
            if isinstance(value, dict):
                keys = " ".join("x%d %r" % kv for kv in sorted(value.items()))
                lines.append(" %s {{curve %s }}" % (name, keys))
            else:
                lines.append(" %s %r" % (name, value))
        lines.append("}")
    return "\n".join(lines) + "\n"


def _plain_map(text, frame, direction, width=WIDTH, height=HEIGHT):
    nodes = [plain.at_frame(knobs, frame)
             for _, knobs in plain.read_nuke(text)]
    return plain.stmap(nodes, plain.camera_of(nodes[0]), width, height,
                       direction)


def _max_diff(got, want):
    return float((got.double() - want).abs().max())


CASES = [(kind, pa, direction, seed)
         for seed, (kind, pa) in enumerate(
             [(k, pa) for k in NODES for pa in (1.0, 1.8)])
         for direction in ("distort", "undistort")]


@pytest.mark.parametrize("kind,pixel_aspect,direction,seed", CASES)
def test_models_at_to_stmap_matches_the_plain_lens(kind, pixel_aspect,
                                                   direction, seed):
    text = _nuke([(NODES[kind], _random_knobs(kind, 100 + seed))],
                 pixel_aspect)
    layers = lensfile.parse_string(text)
    fb = layers.film_back()
    assert fb.pixel_aspect == pixel_aspect
    for frame in (FRAMES[0], 3, FRAMES[1]):
        models = layers.models_at(frame)
        assert [type(m).__name__ for m in models] == [
            "TdeAnamorphicStdDeg4Rescaled" if kind == "rescaled"
            else "TdeAnamorphicStdDeg4"]
        assert all(isinstance(getattr(models[0], f.name), float)
                   for f in dataclasses.fields(models[0]))
        want = _plain_map(text, frame, direction)
        got = stmap.stmap(models, fb, WIDTH, HEIGHT, direction, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (HEIGHT, WIDTH, 4)
        assert _max_diff(got, want) < 2e-6
        fine = stmap.stmap_torch(models[0], fb, WIDTH, HEIGHT, direction,
                                 device="cpu", dtype=torch.float64)
        assert _max_diff(fine, want) < 1e-7
        # The lens moves the map: a comparison with the identity fails.
        assert _max_diff(got, plain.stmap([{}], plain.camera_of(
            plain.at_frame(plain.read_nuke(text)[0][1], frame)), WIDTH,
            HEIGHT, direction)) > 1e-3


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_two_layer_stack_matches_the_plain_stack(direction):
    """Distortion through the layers in order, undistortion through them
    in reverse: the stack differs from either layer alone."""
    text = _nuke([(NODES["rescaled"], _random_knobs("rescaled", 7)),
                  (NODES["standard"], _random_knobs("standard", 8))], 1.8)
    layers = lensfile.parse_string(text)
    counted = profiler.counters["lensfile.layers"]
    models = layers.models_at(4)
    assert profiler.counters["lensfile.layers"] == counted + 2
    want = _plain_map(text, 4, direction)
    got = stmap.stmap(models, layers.film_back(), WIDTH, HEIGHT, direction,
                      device="cpu")
    assert _max_diff(got, want) < 2e-6
    for one in models:
        alone = stmap.stmap([one], layers.film_back(), WIDTH, HEIGHT,
                            direction, device="cpu")
        assert _max_diff(alone, want) > 1e-4


def test_animated_knobs_round_trip_through_write_and_parse():
    """write_string(parse_string(text)) parses to the same layers, every
    key to its last bit, and the plain reader reads the written text as
    the original."""
    text = _nuke([(NODES["rescaled"], _random_knobs("rescaled", 11)),
                  (NODES["standard"], _random_knobs("standard", 12))], 1.8)
    layers = lensfile.parse_string(text)
    written = lensfile.write_string(layers)
    again = lensfile.parse_string(written)
    assert dataclasses.asdict(again) == dataclasses.asdict(layers)
    assert lensfile.write_string(again) == written
    for (_, want), (_, got) in zip(plain.read_nuke(text),
                                   plain.read_nuke(written)):
        assert {k: v for k, v in got.items() if k in want} == want
    for frame in range(FRAMES[0], FRAMES[1] + 1):
        assert again.models_at(frame) == layers.models_at(frame)


def test_a_frame_outside_the_curves_holds_the_nearest_end():
    """A frame before the first key takes the first key's values, one
    after the last the last key's (the plain reader has no key there);
    a static knob is the same at every frame."""
    knobs = _random_knobs("rescaled", 21)
    text = _nuke([(NODES["rescaled"], knobs)], 1.8)
    layers = lensfile.parse_string(text)
    assert layers.models_at(FRAMES[0] - 1) == layers.models_at(FRAMES[0])
    assert layers.models_at(FRAMES[0] - 40) == layers.models_at(FRAMES[0])
    assert layers.models_at(FRAMES[1] + 1) == layers.models_at(FRAMES[1])
    assert layers.models_at(FRAMES[1]) != layers.models_at(FRAMES[0])
    (before,), (after,) = (layers.models_at(0), layers.models_at(99))
    assert before.degree2_cx02 == knobs["Cx02_Degree_2"][FRAMES[0]]
    assert after.degree2_cx02 == knobs["Cx02_Degree_2"][FRAMES[1]]
    assert before.rescale == after.rescale == knobs["Rescale"]
    with pytest.raises(KeyError):
        plain.at_frame(plain.read_nuke(text)[0][1], 0)
    got = stmap.stmap(layers.models_at(0), layers.film_back(), WIDTH,
                      HEIGHT, "distort", device="cpu")
    assert _max_diff(got, _plain_map(text, FRAMES[0], "distort")) < 2e-6


def test_models_at_is_a_span_counts_and_reads_nothing():
    layers = lensfile.parse_string(
        _nuke([(NODES["rescaled"], _random_knobs("rescaled", 31))], 1.8))
    counters = profiler.counters
    before = {k: counters[k] for k in ("lensfile.models_at",
                                       "lensfile.layers", "host_reads")}
    with profiler.tracing():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            models = layers.models_at(2)
    assert program_ranges(prof.events()) == [("lensfile.models_at", None)]
    fb = layers.film_back()
    # The ST-map wrapper hands every field to the pack kernel by value,
    # reading nothing.
    values, devices = stmap._lens_fields(fb, models)
    assert values[4] == 1.8 and devices == [None] * len(values)
    records = stmap._field_records(values, devices, torch.device("cuda", 0),
                                   [])
    assert records == [x for v in values for x in (float(v), 0, 0, 0)]
    assert stmap._model_kind(models[0]) == 3
    assert counters["lensfile.models_at"] == before["lensfile.models_at"] + 1
    assert counters["lensfile.layers"] == before["lensfile.layers"] + 1
    assert counters["host_reads"] == before["host_reads"]
    # Spans off (no capture, no tracing()): nothing logged, the counters
    # still count.
    logged = profiler.span_log()
    layers.models_at(3)
    assert profiler.span_log() == logged
    assert counters["lensfile.models_at"] == before["lensfile.models_at"] + 2


@pytest.fixture
def lens_file(tmp_path):
    text = _nuke([(NODES["rescaled"], _random_knobs("rescaled", 41))], 1.8)
    path = tmp_path / "lens.nk"
    path.write_text(text)
    return path, text


@pytest.mark.parametrize("direction", ["distort", "undistort"])
def test_cli_lensdistort_writes_the_lens_files_map(lens_file, tmp_path,
                                                   direction, capsys):
    path, text = lens_file
    out = str(tmp_path / "st.exr")
    assert cli.main(["lensdistort", "--lens-file", str(path), "--frame", "3",
                     "--width", str(WIDTH), "--height", str(HEIGHT),
                     "--direction", direction, "--output", out,
                     "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    got, _ = exr.read_pixels(out)
    assert _max_diff(torch.as_tensor(got),
                     _plain_map(text, 3, direction)) < 2e-6


def test_cli_image_warp_warps_through_the_lens_files_map(lens_file, tmp_path):
    path, text = lens_file
    image = np.random.RandomState(5).rand(HEIGHT, WIDTH, 4).astype(
        np.float32)
    plate = str(tmp_path / "plate.exr")
    exr.write_pixels(plate, image)
    out = str(tmp_path / "w.exr")
    assert cli.main(["image-warp", plate, "--lens-file", str(path),
                     "--frame", "2", "--direction", "undistort", "--output",
                     out, "--device", "cpu"]) == 0
    got, _ = exr.read_pixels(out)
    layers = lensfile.parse(path)
    st = stmap.stmap(layers.models_at(2), layers.film_back(), WIDTH, HEIGHT,
                     "undistort", device="cpu")
    want = warp.warp_image(torch.as_tensor(image), st).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got - image).max()) > 0.1


def test_the_benchmarks_reference_is_this_one():
    mine = pathlib.Path(plain.__file__).read_text()
    assert (ROOT / "mmbench" / "reference" / "anamorphic.py").read_text() \
        == mine
    imports = [alias.name for node in ast.walk(ast.parse(mine))
               if isinstance(node, (ast.Import, ast.ImportFrom))
               for alias in node.names]
    assert imports == ["math", "torch"]
