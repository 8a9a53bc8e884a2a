"""Whole runs of the cells on the CPU at small sizes (the harness's look
for a card skipped): sound, they come out correct; with the timed path
broken underneath, correct comes out false.  And what a run refuses: no
card, a JAX module in the process."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from mmbench.common import harness
from mmbench.tests._small import SEED, SMALL, small_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"))


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(cell, root, trace=0):
    return harness.run(cell, SEED, 1, trace, CPU, time.perf_counter(),
                       root=root)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell, small):
    for trace in (0, 1):
        result = _run(cell, small, trace)
        assert result["correct"], result["checks"]
        assert result["failed"] == 0 and result["attempted"] >= 1
        assert list(result)[-1] == "checks"
        if trace:
            assert "breakdown" in result
        else:
            assert "setup_s" in result["metrics"]


def _warp_half(warp):
    real = warp.warp_image

    def half(image, st_map):
        out = real(image, st_map)
        out[out.shape[0] // 2:] = 0.0
        return out
    return half


def _warp_altered(warp):
    real = warp.warp_image

    def altered(image, st_map):
        out = real(image, st_map)
        out[3, 5, 0] += 0.25
        return out
    return altered


def _map_altered(stmap):
    real = stmap.stmap

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out[7, 11, 1] += 1e-3
        return out
    return altered


def _map_unchanged(stmap):
    """Each direction's first map returned for every later frame: the
    lens's state left as it was."""
    real = stmap.stmap
    first = {}

    def unchanged(lens, film_back, width, height, direction, **kwargs):
        if direction not in first:
            first[direction] = real(lens, film_back, width, height,
                                    direction, **kwargs)
        return first[direction].clone()
    return unchanged


EXPORT_FAULTS = {"half of each frame left out": ("warp", _warp_half),
                 "the map left as the first frame's": ("stmap",
                                                       _map_unchanged),
                 "a warped pixel altered": ("warp", _warp_altered),
                 "a map texel altered": ("stmap", _map_altered)}


# A static lens's map is rightly the first frame's: that fault is the
# breathing lens's alone.
BROKEN_EXPORTS = [(cell, fault) for cell in sorted(SMALL)
                  for fault in sorted(EXPORT_FAULTS)
                  if cell == "shot.lens_export" or "first frame" not in fault]


@pytest.mark.parametrize("cell,fault", BROKEN_EXPORTS)
def test_broken_export_is_not_correct(cell, fault, monkeypatch, small):
    from mayamatchmovesolver_torch.ops import stmap, warp

    module, make = EXPORT_FAULTS[fault]
    target = {"warp": (warp, "warp_image"), "stmap": (stmap, "stmap")}[module]
    monkeypatch.setattr(target[0], target[1], make(target[0]))
    assert not _run(cell, small)["correct"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_where_it_can_run_here(cell, small):
    """The export's control (the plain map and warp in bfloat16) runs on
    the CPU too, and fails its limits."""
    from mmbench import control

    lines = control.run(cell, [SEED], 12, {SEED}, CPU, root=small)
    traffic = harness.read_json(harness.BENCH / "traffic" /
                                "plate_export.json")
    program, ctl = lines
    assert all(program["checks"][k] <= v
               for k, v in traffic["limits"].items())
    assert any(ctl["checks"][k] > v for k, v in traffic["limits"].items())


def test_new_files_are_found_without_editing(tmp_path):
    """A metric, a traffic mix and a cell added as new files of a copy of
    the benchmark run with no existing file changed."""
    small_root(tmp_path, {"shot.lens_export": SMALL["shot.lens_export"]})
    man = harness.manifest()
    (tmp_path / "mmbench" / "metrics" / "frames_done.tiny.py").write_text(
        "def read(records):\n"
        "    return float(sum(r.units for r in records.requests))\n")
    folder = tmp_path / "mmbench"
    config = harness.read_json(folder / "configs" /
                               "hd_classic_breathing.json")
    config["lens"]["distortion"] = [0.02, 0.04]
    (folder / "configs" / "hd_gentle.json").write_text(json.dumps(config))
    traffic = harness.read_json(folder / "traffic" / "plate_export.json")
    traffic["check_sample"] = 2
    (folder / "traffic" / "two_kept.json").write_text(json.dumps(traffic))
    man["workloads"].append({"name": "shot.gentle", "config": "hd_gentle",
                             "traffic": "two_kept",
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "frames_done.tiny", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "warp", "moves": "export_fps",
                             "workloads": ["shot.gentle"]})
    for m in man["end_to_end"]:
        if "shot.lens_export" in m.get("workloads", []):
            m["workloads"].append("shot.gentle")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    result = _run("shot.gentle", tmp_path, trace=1)
    assert result["correct"]
    assert result["metrics"]["frames_done.tiny"]["value"] == 9.0  # 3 passes


def test_forbidden_modules_are_named(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "mayamatchmovesolver_tpu.solver",
                        types.ModuleType("mayamatchmovesolver_tpu.solver"))
    assert harness.forbidden_modules() == ["jax", "mayamatchmovesolver_tpu"]


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "shot.lens_export", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=str(harness.ROOT), timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
