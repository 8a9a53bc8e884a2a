"""The cell shot.stack_half_export on the CPU at a small size, its plates
and CG layers still half floats: its new entries resolve to their files;
the two-node lens file the client writes parses to the configuration's
numbers, in file order; the plain stack is the program's stack; a sound
run is correct, and runs with a planted fault are not (the two layers
swapped, the classic layer dropped, the classic layer a frame behind,
the radial layer's B_Cylindric_Bending dropped, the map held in half
precision); the control fails the limits; stmap_layer_roofline_pct.export
reads only the layer variant's launches, at 32 bytes a pixel.  On the
card (-m cuda) the control fails where the program passes."""

import dataclasses
import time

import pytest
import torch

from mmbench import control
from mmbench.common import harness, peaks
from mmbench.common.records import Records
from mmbench.common.trace import Trace
from mmbench.reference import stack as ref_lens
from mmbench.tests._small import SEED, small_root

CELL = "shot.stack_half_export"
CONFIG = "venice2_radial_classic_stack"
METRIC = "stmap_layer_roofline_pct.export"
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
    return harness.load_module(harness.BENCH / "metrics" / (METRIC + ".py"))


def test_new_entries_resolve_to_their_files():
    man, cell, config, traffic, client = _client()
    assert cell["chips"] == 1 and cell["config"] == CONFIG
    assert cell["traffic"] == "stack_half_export"
    entry = [c for c in man["configs"] if c["name"] == CONFIG][0]
    assert entry["file"] == "mmbench/configs/%s.json" % CONFIG
    assert config["source"] == entry["source"] and config["reduced"] == []
    assert config["plate"] == [8640, 5760] and config["dtype"] == "float16"
    assert config["film_back_mm"] == [35.9, 24.0]
    assert [layer["node"] for layer in config["lenses"]] == [
        ref_lens.RADIAL, ref_lens.CLASSIC]
    for layer in config["lenses"]:
        assert set(layer["knobs"]) <= set(config["assumed"])
    assert traffic["client"] == "stack_lens_file_export"
    assert traffic["first_frame"] == 1001
    for fn in ("setup", "request", "release", "check", "control"):
        assert callable(getattr(client, fn)), fn
    metric = [m for m in man["per_layer"] if m["name"] == METRIC][0]
    assert metric["workloads"] == [CELL] and metric["unit"] == "%"
    assert callable(_reader().read)
    for m in man["end_to_end"][1:] + man["per_layer"]:
        if m["name"] in ("export_fps", "frame_p95_ms",
                         "stmap_roofline_pct.export",
                         "stmap_wrapper_ms.export", "warp_device_ms.export",
                         "device_idle_pct.export", "lens_eval_ms.export",
                         "warp_roofline_pct.export", METRIC):
            assert m["workloads"][-1] == CELL, m["name"]


def test_the_written_lens_file_parses_to_the_configurations_numbers():
    from mayamatchmovesolver_torch.io import lensfile

    _, _, config, traffic, client = _client()
    first = traffic["first_frame"]
    layers = lensfile.parse_string(client.nuke_script(config, first))
    fb = layers.film_back()
    width_cm, height_cm = (mm / 10.0 for mm in config["film_back_mm"])
    assert (fb.film_back_width_cm, fb.film_back_height_cm,
            fb.pixel_aspect) == (width_cm, height_cm, 1.0)
    # The grid calibration is static, the breathing layer keyed a frame.
    assert [layer.frame_range for layer in layers.layers] == [
        (1, 1), (first, first + 119)]
    for f in (0, 37, 119):
        radial, classic = client.knobs_at(config, f)
        got = layers.models_at(first + f)
        assert [type(m).__name__ for m in got] == ["TdeRadialStdDeg4",
                                                   "TdeClassic"]
        assert (got[0].degree2_distortion, got[0].degree4_distortion,
                got[0].degree2_u, got[0].degree4_v,
                got[0].cylindric_direction, got[0].cylindric_bending) == (
            radial["Distortion_Degree_2"],
            radial["Quartic_Distortion_Degree_4"], radial["U_Degree_2"],
            radial["V_Degree_4"], radial["Phi_Cylindric_Direction"],
            radial["B_Cylindric_Bending"])
        assert (got[1].distortion, got[1].anamorphic_squeeze,
                got[1].quartic_distortion) == (
            classic["Distortion"], classic["Anamorphic_Squeeze"],
            classic["Quartic_Distortion"])
    assert client.knobs_at(config, 0)[1]["Distortion"] == -0.004
    assert client.knobs_at(config, 119)[1]["Distortion"] == -0.012


def test_the_plain_stack_is_the_programs_stack():
    """The program's plain layers in float64, in application order (the
    map between them float32), against the plain stack of the
    configuration's knobs, at the first and the last frame, in both
    directions; the stack moves the frame's edges by 1.5-3%."""
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.models import base
    from mayamatchmovesolver_torch.ops import stmap

    _, _, config, _, client = _client()
    layers = lensfile.parse_string(client.nuke_script(config, 1))
    fb = base.as_tensors(layers.film_back(), device=CPU, dtype=torch.float64)
    nodes = [layer["node"] for layer in config["lenses"]]
    order = {"distort": 1, "undistort": -1}
    for f in (0, 119):
        for direction in ("distort", "undistort"):
            lenses = list(zip(nodes, client.knobs_at(config, f)))
            want = ref_lens.stmap(lenses, client.camera(config), 89, 62,
                                  direction)
            first, second = layers.models_at(f + 1)[::order[direction]]
            got = stmap.stmap_layer_torch(
                stmap.stmap_torch(first, fb, 89, 62, direction, device=CPU,
                                  dtype=torch.float64),
                second, fb, direction)
            # Two float32 roundings of UVs up to 1.03: half an ulp, 1.2e-7,
            # each.
            assert float((got.double() - want).abs().max()) < 2.5e-7
            identity = ref_lens.stmap([], client.camera(config), 89, 62,
                                      direction)
            move = float((identity - want).abs().max())
            assert 0.015 < move < 0.03, move


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


def _patched_models(lensfile, change):
    real = lensfile.LensLayers.models_at
    return lensfile.LensLayers, "models_at", \
        lambda self, frame: change(self, frame, real)


def _layers_swapped(lensfile, stmap):
    return _patched_models(
        lensfile, lambda self, frame, real: real(self, frame)[::-1])


def _classic_dropped(lensfile, stmap):
    return _patched_models(
        lensfile, lambda self, frame, real: real(self, frame)[:1])


def _classic_a_frame_behind(lensfile, stmap):
    return _patched_models(
        lensfile, lambda self, frame, real: (real(self, frame)[:1]
                                             + real(self, frame - 1)[1:]))


def _bending_dropped(lensfile, stmap):
    def change(self, frame, real):
        radial, classic = real(self, frame)
        return [dataclasses.replace(radial, cylindric_bending=0.0), classic]
    return _patched_models(lensfile, change)


def _map_in_half(lensfile, stmap):
    real = stmap.stmap

    def rounded(*args, **kwargs):
        return real(*args, **kwargs).half().float()
    return stmap, "stmap", rounded


# Each fault and the check that must catch it.
FAULTS = {"the layers swapped": (_layers_swapped, "map_uv"),
          "the classic layer dropped": (_classic_dropped, "map_uv"),
          "the classic layer a frame behind": (_classic_a_frame_behind,
                                               "map_uv"),
          "B_Cylindric_Bending dropped": (_bending_dropped, "map_uv"),
          "the map in half": (_map_in_half, "map_uv")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_export_is_not_correct(fault, monkeypatch, small):
    from mayamatchmovesolver_torch.io import lensfile
    from mayamatchmovesolver_torch.ops import stmap

    plant, caught_by = FAULTS[fault]
    monkeypatch.setattr(*plant(lensfile, stmap))
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


def _kernel(core, distort, from_map):
    return ("void (anonymous namespace)::stmap_kernel<%d, %s, %s>"
            "(float4*, int, int, (anonymous namespace)::StmapParams "
            "const*)" % (core, distort, from_map))


def test_layer_roofline_reads_only_the_layer_launches():
    """Two layer launches at 8640 x 5760 (classic distort and radial
    undistort from a map, 0.6 ms and 0.55 ms): 32 bytes a pixel over the
    memory rate each, over the 1.15 ms they took; the launches from the
    pixel index, the pack kernel and the warps are not counted; None
    without a layer launch or a trace."""
    config = {"plate": [8640, 5760], "channels": 4, "dtype": "float16"}
    kernels = [(_kernel(1, "true", "false"), 0.56e-3),
               (_kernel(0, "true", "true"), 0.6e-3),
               (_kernel(0, "false", "false"), 0.24e-3),
               (_kernel(1, "false", "true"), 0.55e-3),
               ("void (anonymous namespace)::pack_params_kernel"
                "((anonymous namespace)::PackArgs, "
                "(anonymous namespace)::StmapParams*)", 5e-6),
               ("void (anonymous namespace)::warp_kernel<__half, true>"
                "(__half const*, int, int, int)", 0.65e-3)]
    records = Records(requests=[], window_s=1.0, config=config,
                      trace=_trace(kernels))
    bound = 8640 * 5760 * 32 / peaks.H100_HBM_BYTES_PER_S
    assert bound == pytest.approx(0.475e-3, rel=1e-3)
    assert _reader().read(records) == pytest.approx(
        100.0 * 2 * bound / 1.15e-3, rel=1e-12)
    without = Records(requests=[], window_s=1.0, config=config,
                      trace=_trace([kernels[i] for i in (0, 2, 4, 5)]))
    assert _reader().read(without) is None
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
