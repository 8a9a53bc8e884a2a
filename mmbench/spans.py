#!/usr/bin/env python3
"""Where a cell's time goes by the program's own spans and counters, and
what turning the spans on costs, in one process on the card:

    python3 mmbench/spans.py --workload <cell> --seed <n> \
        [--requests 40] [--seconds 10] [--runs 3]

After set-up: `runs` pairs of closed loops of `seconds` each, spans off
and on in turns, no profiler (units a second); then the traced run's
plain pass and its profiled pass, the latter with the spans on
(utils/profiler.py::tracing) and at the same request numbers as the
benchmark's.  Prints one JSON line: each counter's increase a unit of
work over the profiled pass; each span's device idle and busy
milliseconds a unit and its launches a range (program.reduce); the
device's busy milliseconds a unit, the requests' wall milliseconds a
unit and the idle gaps by what the host ran (trace.reduce), all
profiled; and the plain pass's wall milliseconds a unit.  The profiler
slows the host, not the device: a span's idle time is the profiled
host's.  The benchmark's own runs never run this.
"""

import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mmbench.common import harness, program, readers  # noqa: E402
from mmbench.common import trace as trace_mod  # noqa: E402
from mmbench.common.records import Recorder  # noqa: E402


def rates(client, state, seconds, runs):
    """Units a second of closed loops with the spans off and on, in
    turns, the first of each pair alternating."""
    from mayamatchmovesolver_torch.utils import profiler

    out = {"off": [], "on": []}
    for run in range(runs):
        for on in ((False, True) if run % 2 == 0 else (True, False)):
            if on:
                with profiler.tracing():
                    requests, window = harness.measure(client, state, seconds)
            else:
                requests, window = harness.measure(client, state, seconds)
            out["on" if on else "off"].append(
                readers.units(requests) / window)
    return out


def profiled(client, state, count, device):
    """The plain pass, then the profiled pass with the spans on; returns
    (plain requests, profiled requests, counters' increases, events,
    profiled window in seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from mayamatchmovesolver_torch.utils import profiler

    sync = harness._synchronize(device)
    plain = [harness._issue(client, state, i, Recorder())
             for i in range(count)]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    ranges = Recorder(active=True)
    before = profiler.counters.copy()
    sync()
    with profiler.tracing(), profile(activities=activities) as prof:
        start = time.perf_counter()
        done = [harness._issue(client, state, 2 * count + i, ranges)
                for i in range(count)]
        sync()
        window = time.perf_counter() - start
    counted = {k: v - before[k] for k, v in profiler.counters.items()}
    return plain, done, counted, prof.events(), window


def _wall_ms(requests, units):
    return sum(r.end - r.start for r in requests) * 1e3 / units


def run(cell, seed, count, seconds, runs, device, root=harness.ROOT):
    _, entry, config, traffic, client = harness.resolve(cell, root)
    ctx = harness.Context(entry, config, traffic, seed, device, True)
    state = client.setup(ctx)
    fps = rates(client, state, seconds, runs)
    plain, done, counted, events, window = profiled(client, state, count,
                                                    device)
    client.release(state)
    units, plain_units = readers.units(done), readers.units(plain)
    tr = trace_mod.reduce(program.without_program_ranges(events), window)
    per_unit_ms = 1e3 / units
    spans = {name: {"idle_ms": s["idle_s"] * per_unit_ms,
                    "busy_ms": s["busy_s"] * per_unit_ms,
                    "ranges": len(s["launches"]),
                    "launches_median": statistics.median(s["launches"]),
                    "launches_range": [min(s["launches"]),
                                       max(s["launches"])]}
             for name, s in program.reduce(events).items()}
    return dict(
        workload=cell, seed=seed,
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else device.type),
        units=units, fps=fps,
        counters={k: v / units for k, v in sorted(counted.items())},
        spans=spans, busy_ms=tr.busy_s * per_unit_ms,
        profiled_ms=_wall_ms(done, units),
        wall_ms=_wall_ms(plain, plain_units),
        idle_gaps_ms=[[n, s * per_unit_ms] for n, s in tr.idle_gaps])


def main(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--requests", type=int, default=40)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.requests, args.seconds,
               args.runs, torch.device("cuda", 0))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
