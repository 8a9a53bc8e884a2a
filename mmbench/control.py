#!/usr/bin/env python3
"""Readings of a cell's comparison for its limits: the program's, and its
control's (the precision below the configuration's, in the program's
place), seed after seed in one process on the card:

    python3 mmbench/control.py --workload <cell> --seeds 1,2,3 --requests 2 \
        [--control-seeds 1,2,3]

Prints one JSON line a seed and side: the compared numbers, and each
request's units and seconds.  The benchmark's own runs never run this.
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mmbench.common import harness  # noqa: E402
from mmbench.common.records import Recorder  # noqa: E402


def readings(client, state, requests, start):
    times, units = [], []
    for i in range(start, start + requests):
        t0 = time.perf_counter()
        done, ok = client.request(state, i, Recorder())
        times.append(time.perf_counter() - t0)
        units.append(int(done) if ok else -1)
    checks = {name: value for name, value, _ in client.check(state)}
    state["outputs"].clear()
    return dict(checks=checks, units=units, seconds=times)


def run(cell, seeds, requests, control_seeds, device, root=harness.ROOT):
    _, cell_entry, config, traffic, client = harness.resolve(cell, root)
    out = []
    for seed in seeds:
        ctx = harness.Context(cell_entry, config, traffic, seed, device, True)
        state = client.setup(ctx)
        line = dict(seed=seed, side="program",
                    **readings(client, state, requests, 0))
        out.append(line)
        print(json.dumps(line), flush=True)
        if seed in control_seeds:
            with client.control(state):
                line = dict(seed=seed, side="control",
                            **readings(client, state, requests, 0))
            out.append(line)
            print(json.dumps(line), flush=True)
        client.release(state)
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--requests", type=int, default=2)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    run(args.workload, ints(args.seeds), args.requests,
        set(ints(args.control_seeds)), torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
