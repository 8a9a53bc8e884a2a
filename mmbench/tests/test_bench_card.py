"""On the card: each cell's control (the precision below the
configuration's, in the program's place) fails the cell's limits where
the program passes them, at sizes a test run holds.  Skips without a
CUDA device.

    python -m pytest mmbench/tests/test_bench_card.py -m cuda -n 0
"""

import pytest
import torch

from mmbench import control
from mmbench.common import harness
from mmbench.tests._small import SEED, small_root

CASES = {
    "shot.lens_export": ({"frames": 8}, {"trace_requests": 8}, 16),
    "shot.static_export": ({"frames": 8}, {"trace_requests": 8}, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CASES))
def test_control_fails_where_the_program_passes(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config, traffic, requests = CASES[cell]
    root = small_root(tmp_path, {cell: {"config": config,
                                        "traffic": traffic}})
    limits = harness.resolve(cell, root)[3]["limits"]
    program, ctl = control.run(cell, [SEED], requests, {SEED},
                               torch.device("cuda", 0), root=root)
    assert all(program["checks"][k] <= v for k, v in limits.items())
    assert any(ctl["checks"][k] > v for k, v in limits.items())
