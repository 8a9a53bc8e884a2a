"""The cell shot.aces_half_export on the CPU at a small size, its plates
and CG layers still half floats: its files load; the lens file the
client writes parses to the configuration's numbers; the plain radial
reference is the program's lens; a sound run is correct, and runs with a
planted fault are not (the map one frame behind, the cylindric extender
dropped, the image rounded to bfloat16 before the warp, the output
rounded to half); the control fails the limits; warp_roofline_pct.export
reads a float16 and a float32 trace to the hand-worked bound.  On the
card (-m cuda) the control fails where the program passes."""

import dataclasses
import time

import pytest
import torch

from mmbench import control
from mmbench.common import harness, peaks
from mmbench.common.records import Records
from mmbench.common.trace import Trace
from mmbench.reference import radial as ref_lens
from mmbench.tests._small import SEED, small_root

CELL = "shot.aces_half_export"
SMALL = {CELL: {"config": {"frames": 8, "plate": [64, 44]},
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


def _reader():
    return harness.load_module(harness.BENCH / "metrics" /
                               "warp_roofline_pct.export.py")


def test_new_files_load():
    man, cell, config, traffic, client = _client()
    assert cell["chips"] == 1 and cell["config"] == "venice2_radial_half"
    entry = [c for c in man["configs"] if c["name"] == cell["config"]][0]
    assert config["source"] == entry["source"] and config["reduced"] == []
    assert config["plate"] == [8640, 5760] and config["dtype"] == "float16"
    assert config["film_back_mm"] == [35.9, 24.0]
    assert set(config["lens"]["knobs"]) <= set(config["assumed"])
    assert traffic["client"] == "radial_lens_file_export"
    assert traffic["first_frame"] == 1001
    for fn in ("setup", "request", "release", "check", "control"):
        assert callable(getattr(client, fn)), fn
    assert callable(_reader().read)


def test_the_written_lens_file_parses_to_the_configurations_numbers():
    from mayamatchmovesolver_torch.io import lensfile

    _, _, config, traffic, client = _client()
    first = traffic["first_frame"]
    text = client.nuke_script(config, first)
    layers = lensfile.parse_string(text)
    fb = layers.film_back()
    width_cm, height_cm = (mm / 10.0 for mm in config["film_back_mm"])
    assert (fb.film_back_width_cm, fb.film_back_height_cm,
            fb.pixel_aspect) == (width_cm, height_cm, 1.0)
    assert layers.frame_range() == (first, first + 119)
    (node, knobs), = ref_lens.read_nuke(text)
    assert node == config["lens"]["node"]
    for f in (0, 37, 119):
        want = client.knobs_at(config, f)
        assert ref_lens.at_frame(knobs, first + f) == dict(
            want, tde4_filmback_width_cm=width_cm,
            tde4_filmback_height_cm=height_cm, tde4_pixel_aspect=1.0)
        (model,) = layers.models_at(first + f)
        assert type(model).__name__ == "TdeRadialStdDeg4"
        assert (model.degree2_distortion, model.degree4_distortion,
                model.degree2_u, model.degree4_v, model.cylindric_direction,
                model.cylindric_bending) == (
            want["Distortion_Degree_2"], want["Quartic_Distortion_Degree_4"],
            want["U_Degree_2"], want["V_Degree_4"],
            want["Phi_Cylindric_Direction"], want["B_Cylindric_Bending"])


def test_the_reference_is_the_programs_lens():
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.ops import stmap

    _, _, config, _, client = _client()
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


def _one_frame_behind(lensfile, warp):
    real = lensfile.LensLayers.models_at
    return lensfile.LensLayers, "models_at", \
        lambda self, frame: real(self, frame - 1)


def _cylindric_dropped(lensfile, warp):
    real = lensfile.LensLayers.models_at

    def dropped(self, frame):
        return [dataclasses.replace(m, cylindric_direction=0.0,
                                    cylindric_bending=0.0)
                for m in real(self, frame)]
    return lensfile.LensLayers, "models_at", dropped


def _image_in_bfloat16(lensfile, warp):
    real = warp.warp_image

    def rounded(image, st_map):
        return real(image.to(torch.bfloat16).to(image.dtype), st_map)
    return warp, "warp_image", rounded


def _output_in_half(lensfile, warp):
    real = warp.warp_image

    def rounded(image, st_map):
        return real(image, st_map).half().float()
    return warp, "warp_image", rounded


# Each fault and the check that must catch it.
FAULTS = {"the map one frame behind": (_one_frame_behind, "map_uv"),
          "Phi and B dropped": (_cylindric_dropped, "map_uv"),
          "the image in bfloat16": (_image_in_bfloat16, "warp"),
          "the output in half": (_output_in_half, "warp")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_export_is_not_correct(fault, monkeypatch, small):
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.ops import warp

    plant, caught_by = FAULTS[fault]
    monkeypatch.setattr(*plant(lensfile, warp))
    result = _run(small)
    assert not result["correct"], result["checks"]
    reading = result["checks"][caught_by]
    assert reading["value"] > reading["limit"], result["checks"]


def test_control_is_not_correct_where_it_can_run_here(small):
    limits = _client(small)[3]["limits"]
    program, ctl = control.run(CELL, [SEED], 12, {SEED}, CPU, root=small)
    assert all(program["checks"][k] <= v for k, v in limits.items())
    assert any(ctl["checks"][k] > v for k, v in limits.items())


def _trace(kernels):
    return Trace(window_s=1.0, busy_s=1.0, kernels=kernels, ranges={},
                 device_ops=[], idle_gaps=[])


@pytest.mark.parametrize("dtype,kernel,per_pixel", [
    ("float16", "void (anonymous namespace)::warp_kernel<__half, true>"
                "(__half const*, int, int, int)", 16 + 8 + 16),
    ("float32", "void (anonymous namespace)::warp_kernel<float, true, true>"
                "(float const*, int, int, int)", 16 + 16 + 16)])
def test_warp_roofline_reads_the_warp_launches(dtype, kernel, per_pixel):
    """Two warps of 0.8 ms and 1.2 ms at 8640 x 5760 RGBA: their bytes
    (map 16, image 4 x itemsize, float32 output 16 a pixel) over the
    memory rate, twice, over the 2 ms they took; other kernels ignored."""
    config = {"plate": [8640, 5760], "channels": 4, "dtype": dtype}
    records = Records(requests=[], window_s=1.0, config=config,
                      trace=_trace([(kernel, 0.8e-3), ("stmap_kernel<1, "
                                    "true, false>", 5e-3),
                                    (kernel, 1.2e-3)]))
    bound = 8640 * 5760 * per_pixel / peaks.H100_HBM_BYTES_PER_S
    assert _reader().read(records) == pytest.approx(
        100.0 * 2 * bound / 2e-3, rel=1e-12)
    if dtype == "float16":
        assert bound == pytest.approx(0.594e-3, rel=1e-3)
    nothing = Records(requests=[], window_s=1.0, config=config,
                      trace=_trace([("stmap_kernel<1, true, false>", 1.0)]))
    assert _reader().read(nothing) is None
    assert _reader().read(Records(requests=[], window_s=1.0,
                                  config=config)) is None


@pytest.mark.cuda
def test_control_fails_where_the_program_passes_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = small_root(tmp_path, {CELL: {"config": {"frames": 8,
                                                   "plate": [1024, 683]},
                                        "traffic": {"trace_requests": 8}}})
    limits = _client(root)[3]["limits"]
    program, ctl = control.run(CELL, [SEED], 3, {SEED},
                               torch.device("cuda", 0), root=root)
    assert all(program["checks"][k] <= v for k, v in limits.items())
    assert any(ctl["checks"][k] > v for k, v in limits.items())
