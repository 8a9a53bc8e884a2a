#!/usr/bin/env python3
"""Run one cell of the benchmark of mayamatchmovesolver_torch, once:

    python3 mmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA device (exits 2 without one, printing no result).  The last
line of standard output is the result as one JSON object; the last lines
of standard error give each compared number beside its limit.
"""

import time

BEGAN = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from mmbench.common import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], BEGAN))
