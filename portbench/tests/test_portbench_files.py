"""Every name in BENCHMARK.json resolves to its file, and the file keeps to
the benchmark's contract on names, keys and sizes."""

import json
import os
import re

import pytest

from portbench import compare, harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = harness.find_cell(cell)
    assert c.entry["chips"] in (1, 4)
    assert callable(c.driver.program) and callable(c.driver.reference)
    assert callable(c.driver.half_batch)
    # every training cell holds the four training numbers; a driver may add its own
    assert set(compare.NAMES) <= set(c.traffic["limits"])
    assert set(c.traffic["limits"]) <= set(compare.NAMES) | {"update_gap"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m).read)
        if "workloads" in m and m in c.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_resolves(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"].startswith("portbench/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        data = json.load(f)
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_every_metric_is_reported_somewhere():
    cells = [harness.find_cell(w["name"]) for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert any(m in c.end_to_end + c.per_layer for c in cells), m["name"]
