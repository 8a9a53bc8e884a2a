"""The benchmark's runner: one cell, once, in this process.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json names its configuration (configs/<config>.json) and its
traffic mix (traffic/<traffic>.json); the mix names the client that
issues its requests (clients/<client>.py); each metric is read by
metrics/<metric>.py.  Nothing here is specific to one cell.

A client module provides
    setup(ctx) -> state         inputs on the device from the seed, warmed up
    request(state, i, rec)      request i, synchronised; returns (units, ok)
    release(state)              drop the program's state, keep its outputs
    check(state) -> [(name, value, limit)]   the outputs against the reference
    control(state)              context: requests run the control instead
"""

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from mmbench.common import trace as trace_mod
from mmbench.common.records import Records, Recorder, Request

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "mmbench"
# Top-level module names that may not be loaded in a run's process: the
# JAX stack and the JAX package the port was made from (whose name the
# port's shares as a prefix, so names are compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mayamatchmovesolver_tpu")


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    trace: bool = False

    def generator(self, stream=0):
        """A generator on the device, seeded by the run's seed and a
        stream number, so that each kind of input has its own stream."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1000003 + stream) % 2**63)
        return g


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A Python file by path (names may hold dots)."""
    path = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(
        "mmbench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(root=ROOT):
    return read_json(pathlib.Path(root) / "BENCHMARK.json")


def find_cell(man, name):
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit("no workload named %r in BENCHMARK.json" % name)


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def resolve(cell_name, root=ROOT):
    """(manifest, cell, config, traffic, client module) of a cell."""
    bench = pathlib.Path(root) / "mmbench"
    man = manifest(root)
    cell = find_cell(man, cell_name)
    config = read_json(bench / "configs" / (cell["config"] + ".json"))
    traffic = read_json(bench / "traffic" / (cell["traffic"] + ".json"))
    client = load_module(bench / "clients" / (traffic["client"] + ".py"))
    return man, cell, config, traffic, client


def forbidden_modules():
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def _synchronize(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _peak(device):
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def _issue(client, state, i, rec):
    start = time.perf_counter()
    with rec.span("request"):
        units, ok = client.request(state, i, rec)
    return Request(start, time.perf_counter(), int(units), bool(ok))


def measure(client, state, seconds):
    """Closed loop for `seconds`: requests one after another; the window
    closes when the last request begun inside it ends."""
    rec = Recorder()
    requests = []
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while time.perf_counter() < deadline:
        requests.append(_issue(client, state, i, rec))
        i += 1
    return requests, requests[-1].end - start


def traced(client, state, traffic, device):
    """The traced run's three passes of traffic['trace_requests']
    requests each: plain, as in the window; with the benchmark's host
    spans, the device idle at each span's start; under the profiler.
    Returns (plain, spanned, profiled requests, spans, trace)."""
    sync = _synchronize(device)
    count = int(traffic["trace_requests"])
    plain = [_issue(client, state, i, Recorder()) for i in range(count)]
    spans = Recorder(active=True, synchronize=sync)
    spanned = [_issue(client, state, count + i, spans) for i in range(count)]
    ranges = Recorder(active=True)
    profiled, trace = trace_mod.profiled(
        lambda: [_issue(client, state, 2 * count + i, ranges)
                 for i in range(count)], sync, device.type == "cuda")
    return plain, spanned, profiled, dict(spans.spans), trace


def read_metrics(entries, records, cell_name, setup_s, bench=BENCH):
    out = {}
    for m in entries:
        if not applies(m, cell_name):
            continue
        if m["name"] == "setup_s":
            value = setup_s
        else:
            reader = load_module(bench / "metrics" / (m["name"] + ".py"))
            value = reader.read(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell_name, seed, seconds, trace, device, began, root=ROOT):
    """One run of a cell; returns the result's dict.  `began` is the
    host clock when the process started its work."""
    man, cell, config, traffic, client = resolve(cell_name, root)
    ctx = Context(cell, config, traffic, int(seed), device, bool(trace))
    state = client.setup(ctx)
    sync = _synchronize(device)
    sync()
    setup_s = time.perf_counter() - began
    cuda = device.type == "cuda"
    setup_peak = _peak(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    if trace:
        plain, spanned, profiled, spans, tr = traced(
            client, state, traffic, device)
        requests = plain + spanned + profiled
        window_s = sum(r.end - r.start for r in requests)
    else:
        requests, window_s = measure(client, state, seconds)
        plain, profiled, spans, tr = [], [], {}, None
    run_peak = max(setup_peak, _peak(device))  # before the reference runs
    records = Records(requests=requests, window_s=window_s, spans=spans,
                      trace=tr, plain=plain, profiled=profiled,
                      config=config, traffic=traffic)

    client.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = client.check(state)
    failed = sum(1 for r in requests if not r.ok)
    correct = failed == 0 and all(
        math.isfinite(v) and v <= limit for _, v, limit in checks)

    entries = man["per_layer"] if trace else man["end_to_end"]
    metrics = read_metrics(entries, records, cell_name, setup_s,
                           pathlib.Path(root) / "mmbench")
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(run_peak)}
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    return result


def main(argv, began):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=int, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _, cell, _, _, _ = resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print("the cell needs %d CUDA devices, %d found"
              % (cell["chips"], torch.cuda.device_count()), file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, args.trace,
                 torch.device("cuda", 0), began)
    found = forbidden_modules()
    if found:
        print("forbidden modules loaded in the run's process: %s"
              % ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print("check %s %r (limit %r)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
