"""The cell shot.anamorphic_export on the CPU at a small size, float64:
its files load; the lens file the client writes parses to the
configuration's own numbers; the plain reference is the program's lens;
a sound run is correct, and runs with a planted fault are not (the map
one frame behind, the Rescale knob dropped, the pixel aspect ignored);
the control fails the limits; lens_eval_ms.export reads the lens spans.
On the card (-m cuda) the control fails where the program passes."""

import dataclasses
import time

import pytest
import torch

from mmbench import control
from mmbench.common import harness
from mmbench.common.records import Records
from mmbench.reference import anamorphic as ref_lens
from mmbench.tests._small import SEED, small_root

CELL = "shot.anamorphic_export"
SMALL = {CELL: {"config": {"frames": 8, "plate": [64, 44],
                           "dtype": "float64"},
                "traffic": {"trace_requests": 3}}}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"), SMALL)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _client(root=harness.ROOT):
    return harness.resolve(CELL, root)


def _run(root, trace=0):
    return harness.run(CELL, SEED, 1, trace, CPU, time.perf_counter(),
                       root=root)


def test_new_files_load():
    man, cell, config, traffic, client = _client()
    assert cell["chips"] == 1 and cell["config"] == "lf_anamorphic_breathing"
    entry = [c for c in man["configs"] if c["name"] == cell["config"]][0]
    assert config["source"] == entry["source"] and config["reduced"] == []
    assert config["plate"] == [4448, 3096] and config["pixel_aspect"] == 1.8
    assert set(config["lens"]["knobs"]) <= set(config["assumed"])
    assert traffic["client"] == "lens_file_export"
    for fn in ("setup", "request", "release", "check", "control"):
        assert callable(getattr(client, fn)), fn
    reader = harness.load_module(harness.BENCH / "metrics" /
                                 "lens_eval_ms.export.py")
    assert callable(reader.read)


def test_the_written_lens_file_parses_to_the_configurations_numbers():
    from mayamatchmovesolver_torch.io import lensfile

    _, _, config, traffic, client = _client()
    text = client.nuke_script(config, traffic["first_frame"])
    layers = lensfile.parse_string(text)
    fb = layers.film_back()
    width_cm, height_cm = (mm / 10.0 for mm in config["film_back_mm"])
    assert (fb.film_back_width_cm, fb.film_back_height_cm,
            fb.pixel_aspect) == (width_cm, height_cm, 1.8)
    assert layers.frame_range() == (1, 120)
    (node, knobs), = ref_lens.read_nuke(text)
    assert node == config["lens"]["node"]
    for f in (0, 37, 119):
        want = client.knobs_at(config, f)
        assert ref_lens.at_frame(knobs, f + 1) == dict(
            want, tde4_filmback_width_cm=width_cm,
            tde4_filmback_height_cm=height_cm, tde4_pixel_aspect=1.8)
        (model,) = layers.models_at(f + 1)
        assert (model.degree2_cx02, model.degree2_cy02, model.rescale,
                model.lens_rotation) == (
            want["Cx02_Degree_2"], want["Cy02_Degree_2"], want["Rescale"],
            want["Lens_Rotation"])


def test_the_reference_is_the_programs_lens():
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.ops import stmap

    _, _, config, traffic, client = _client()
    layers = lensfile.parse_string(client.nuke_script(config, 1))
    for f in (0, 119):
        for direction in ("distort", "undistort"):
            want = ref_lens.stmap([client.knobs_at(config, f)],
                                  client.camera(config), 89, 62, direction)
            got = stmap.stmap_torch(layers.models_at(f + 1)[0],
                                    layers.film_back(), 89, 62, direction,
                                    device=CPU, dtype=torch.float64)
            assert float((got.double() - want).abs().max()) < 1e-7
            identity = ref_lens.stmap([{}], client.camera(config), 89, 62,
                                      direction)
            assert float((identity - want).abs().max()) > 0.01


def test_sound_run_is_correct(small):
    for trace in (0, 1):
        result = _run(small, trace)
        assert result["correct"], result["checks"]
        assert result["failed"] == 0 and result["attempted"] >= 1
        if trace:
            assert "lens_eval_ms.export" in result["metrics"]
            assert "stmap_wrapper_ms.export" in result["metrics"]
        else:
            assert {"setup_s", "export_fps", "frame_p95_ms"} <= set(
                result["metrics"])


def _one_frame_behind(lensfile):
    real = lensfile.LensLayers.models_at
    return "models_at", lambda self, frame: real(self, frame - 1)


def _rescale_dropped(lensfile):
    real = lensfile.LensLayers.models_at

    def dropped(self, frame):
        return [dataclasses.replace(m, rescale=1.0)
                for m in real(self, frame)]
    return "models_at", dropped


def _pixel_aspect_ignored(lensfile):
    real = lensfile.LensLayers.film_back

    def ignored(self, **kwargs):
        return dataclasses.replace(real(self, **kwargs), pixel_aspect=1.0)
    return "film_back", ignored


FAULTS = {"the map one frame behind": _one_frame_behind,
          "Rescale dropped": _rescale_dropped,
          "pixel aspect ignored": _pixel_aspect_ignored}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_export_is_not_correct(fault, monkeypatch, small):
    from mayamatchmovesolver_torch.io import lensfile

    name, broken = FAULTS[fault](lensfile)
    monkeypatch.setattr(lensfile.LensLayers, name, broken)
    result = _run(small)
    assert not result["correct"], result["checks"]
    assert result["checks"]["map_uv"]["value"] > \
        result["checks"]["map_uv"]["limit"]


def test_control_is_not_correct_where_it_can_run_here(small):
    limits = _client(small)[3]["limits"]
    program, ctl = control.run(CELL, [SEED], 12, {SEED}, CPU, root=small)
    assert all(program["checks"][k] <= v for k, v in limits.items())
    assert any(ctl["checks"][k] > v for k, v in limits.items())


def test_lens_eval_ms_reads_the_lens_spans():
    reader = harness.load_module(harness.BENCH / "metrics" /
                                 "lens_eval_ms.export.py")
    records = Records(requests=[], window_s=1.0,
                      spans={"lens": [3e-5, 1e-5, 2e-5], "stmap": [1.0]})
    assert reader.read(records) == pytest.approx(0.02)
    assert reader.read(Records(requests=[], window_s=1.0)) is None


@pytest.mark.cuda
def test_control_fails_where_the_program_passes_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = small_root(tmp_path, {CELL: {"config": {"frames": 8},
                                        "traffic": {"trace_requests": 8}}})
    limits = _client(root)[3]["limits"]
    program, ctl = control.run(CELL, [SEED], 3, {SEED},
                               torch.device("cuda", 0), root=root)
    assert all(program["checks"][k] <= v for k, v in limits.items())
    assert any(ctl["checks"][k] > v for k, v in limits.items())
