"""Each cell cut to a size the CPU runs in seconds, in float64 (the CPU
has no float32 path worth checking; the card runs the cells as they
are), written into a copy of the benchmark."""

import json
import shutil

from mmbench.common import harness

SMALL = {
    "shot.lens_export": {"config": {"frames": 8, "plate": [64, 36],
                                    "dtype": "float64"},
                         "traffic": {"trace_requests": 3}},
    "shot.static_export": {"config": {"frames": 8, "plate": [64, 36],
                                      "dtype": "float64"},
                           "traffic": {"trace_requests": 3}},
}
SEED = 2**31 + 977


def small_root(tmp, cases=SMALL):
    """A checkout root in `tmp`: a copy of BENCHMARK.json and mmbench/
    whose cells' configuration and traffic files take the values of
    `cases` ({cell: {"config": {...}, "traffic": {...}}})."""
    shutil.copytree(harness.BENCH, tmp / "mmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    man = harness.manifest(tmp)
    for name, small in cases.items():
        cell = harness.find_cell(man, name)
        for kind, folder in (("config", "configs"), ("traffic", "traffic")):
            path = tmp / "mmbench" / folder / (cell[kind] + ".json")
            data = harness.read_json(path)
            data.update(small.get(kind, {}))
            path.write_text(json.dumps(data))
    return tmp
