"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of mmbench/."""

import json
import re

import pytest

from mmbench.common import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MAN = harness.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_paths_command():
    assert set(MAN) == KEYS
    assert MAN["paths"] == ["mmbench"]
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])
    assert (harness.ROOT / MAN["command"][1]).is_file()
    assert len(json.dumps(MAN)) < 64 * 1024


def test_run_seconds_fit_the_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    entries = MAN[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_found_by_name():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = harness.BENCH / "configs" / (c["name"] + ".json")
        assert c["file"] == "mmbench/configs/%s.json" % c["name"]
        data = harness.read_json(path)
        assert data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_cells_found_by_name():
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = harness.read_json(
            harness.BENCH / "traffic" / (w["traffic"] + ".json"))
        client = harness.load_module(
            harness.BENCH / "clients" / (traffic["client"] + ".py"))
        for fn in ("setup", "request", "release", "check", "control"):
            assert callable(getattr(client, fn)), fn


def test_metrics_found_by_name_and_reported():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        if m["name"] != "setup_s":
            reader = harness.load_module(
                harness.BENCH / "metrics" / (m["name"] + ".py"))
            assert callable(reader.read)
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
    for w in MAN["workloads"]:
        reported = [m["name"] for m in MAN["end_to_end"]
                    if harness.applies(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness.applies(m, w["name"]) for m in MAN["per_layer"])


def test_runner_holds_nothing_of_one_cell():
    names = [w["name"] for w in MAN["workloads"]]
    names += [c["name"] for c in MAN["configs"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]
              if m["name"] != "setup_s"]
    for path in [harness.BENCH / "run.py"] + sorted(
            (harness.BENCH / "common").glob("*.py")):
        text = path.read_text()
        for name in names:
            assert name not in text, (path.name, name)


@pytest.mark.parametrize("folder", ["configs", "traffic", "clients",
                                    "metrics"])
def test_every_file_loads(folder):
    """The files of every kind, those of the prepared whole-shot solve
    cell too: a configuration or traffic mix parses and names what it
    needs, a client and a reader load."""
    files = sorted((harness.BENCH / folder).glob("*.*"))
    assert files
    for path in files:
        if path.name == "__init__.py":
            continue
        if path.suffix == ".json":
            data = harness.read_json(path)
            key = "source" if folder == "configs" else "client"
            assert key in data, path.name
            if folder == "traffic":
                assert (harness.BENCH / "clients" /
                        (data["client"] + ".py")).is_file()
        else:
            module = harness.load_module(path)
            assert callable(getattr(module, "read", None)
                            or getattr(module, "request", None)), path.name
