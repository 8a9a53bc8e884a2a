"""The readers of the program's span log (common/program_log.py and the
four metrics that read it) on a hand-built log and request list, and on
shot.lens_export whole on the CPU at a small size."""

import math
import time

import pytest
import torch

from mmbench.common import harness, program_log
from mmbench.common.records import Records, Request
from mmbench.tests._small import SEED, small_root

READERS = ("stmap_host_ms.export", "warp_host_ms.export",
           "lens_host_ms.export", "outside_program_ms.export")

# Three profiled requests of a second, the last failed.  In the first: a
# lens evaluation, a wrapper call holding its launch and read, a warp
# holding its launch, a second wrapper call and warp; in the second one
# warp.  A warp across the first two requests, a wrapper call in the
# failed one and one after every request are read by no frame.
REQUESTS = [Request(0.0, 1.0, 1, True), Request(1.0, 2.0, 1, True),
            Request(2.0, 3.0, 1, False)]
LOG = [
    ("lensfile.models_at", 0.10, 0.15),
    ("stmap.host_read", 0.30, 0.32),
    ("stmap.launch", 0.25, 0.35),
    ("stmap.call", 0.20, 0.40),
    ("warp.launch", 0.55, 0.58),
    ("warp.call", 0.50, 0.60),
    ("stmap.call", 0.65, 0.70),
    ("warp.call", 0.75, 0.80),
    ("warp.call", 0.95, 1.05),
    ("warp.launch", 1.15, 1.25),
    ("warp.call", 1.10, 1.30),
    ("stmap.call", 2.10, 2.50),
    ("stmap.call", 5.00, 5.10),
]
# Per frame: the layers' top-level sums and the rest, in ms.
FRAMES = [{"lensfile.models_at": 50.0, "stmap.call": 250.0,
           "warp.call": 150.0, program_log.OUTSIDE: 350.0},
          {"warp.call": 200.0, program_log.OUTSIDE: 100.0}]
MEDIANS = {"stmap_host_ms.export": 250.0, "warp_host_ms.export": 175.0,
           "lens_host_ms.export": 50.0, "outside_program_ms.export": 225.0}


def _records(requests=REQUESTS):
    return Records(requests=requests, window_s=3.0, profiled=requests)


def _read(name, records):
    return harness.load_module(
        harness.BENCH / "metrics" / (name + ".py")).read(records)


def test_frames_of_a_hand_built_log():
    frames = program_log.frame_ms(_records(), LOG)
    assert len(frames) == len(FRAMES)
    for got, want in zip(frames, FRAMES):
        assert got == pytest.approx(want, rel=1e-12)
    # The layers and the rest add up to the request's start to its last
    # top-level span's end.
    for got, last in zip(frames, (0.80, 0.30)):
        assert sum(got.values()) == pytest.approx(last * 1e3, rel=1e-12)
    assert program_log.frame_ms(_records([]), LOG) == []
    assert program_log.median_ms(_records(), "stmap.launch", LOG) is None


def test_readers_of_a_hand_built_log(monkeypatch):
    monkeypatch.setattr(program_log, "program_log", lambda: list(LOG))
    for name, want in MEDIANS.items():
        assert _read(name, _records()) == pytest.approx(want), name
    monkeypatch.setattr(program_log, "program_log", lambda: [])
    assert all(_read(name, _records()) is None for name in READERS)


def test_readers_of_a_program_without_a_log(monkeypatch):
    """A program that keeps no span log (before it had one) gives None,
    and nothing raises."""
    from mayamatchmovesolver_torch.utils import profiler

    monkeypatch.delattr(profiler, "span_log")
    assert program_log.program_log() is None
    assert all(_read(name, _records()) is None for name in READERS)


def test_readers_on_the_lens_cell_on_the_cpu(tmp_path):
    """shot.lens_export at the small size, traced: the CPU map path has
    no "stmap.call", so its reader finds nothing; the warp and the rest
    read, finite and above 0; the lens file's reader is not the cell's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = harness.run("shot.lens_export", SEED, 1, 1,
                             torch.device("cpu"), time.perf_counter(),
                             root=small_root(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("warp_host_ms.export", "outside_program_ms.export"):
        value = metrics[name]["value"]
        assert metrics[name]["unit"] == "ms"
        assert math.isfinite(value) and value > 0.0, name
    assert "stmap_host_ms.export" not in metrics
    assert "lens_host_ms.export" not in metrics
