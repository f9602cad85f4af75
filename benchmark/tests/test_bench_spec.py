"""``BENCHMARK.json`` and the files it names: found by name, each within
the limits its format sets, and an unknown name fails."""

import json
import re

import pytest

from benchmark import harness
from benchmark.generator import Traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_configs_match_their_files(spec):
    for entry in spec["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and entry["file"].startswith("benchmark/")
        assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200
        config = harness.load_config(entry)
        assert config["reduced"] == entry["reduced"]
        assert config["source"] == entry["source"]
        assert set(config["limits"]) >= {"recall_at_10", "score_err", "ineligible_hits", "failed"}
        assert any(w["config"] == entry["name"] for w in spec["workloads"])


def test_cells_find_their_files(spec):
    pairs = set()
    for cell in spec["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        harness.find_cell(spec, cell["name"])
        assert isinstance(harness.load_traffic(cell["traffic"]), Traffic)
        e2e = {m["name"] for m in harness.metrics_for(spec, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(spec, cell["name"], "per_layer")


def test_metrics_have_readers_and_limits(spec):
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES and m["name"] not in names
            names.add(m["name"])
            assert callable(harness.load_reader(m["name"]).read)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in spec["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        # each lists the cells where its reader finds something, and each of
        # them reports the metric it moves
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.metrics_for(spec, cell, "end_to_end")}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_coalescer_metric_only_in_its_cell(spec):
    cells = [w["name"] for w in spec["workloads"] if any(
        m["name"] == "coalescer.queries_per_dispatch" for m in harness.metrics_for(spec, w["name"], "per_layer")
    )]
    assert cells == ["semantic-768d-1m.clients32"]


@pytest.mark.parametrize("what", ["workload", "traffic", "metric", "traffic_key", "config_name"])
def test_unknown_names_fail(spec, what):
    if what == "workload":
        with pytest.raises(KeyError, match="no workload"):
            harness.find_cell(spec, "semantic-768d-1m.nope")
    elif what == "traffic":
        with pytest.raises(FileNotFoundError, match="no traffic file"):
            harness.load_traffic("nope")
    elif what == "metric":
        with pytest.raises(FileNotFoundError, match="no reader"):
            harness.load_reader("nope.ms")
    elif what == "traffic_key":
        with pytest.raises(ValueError, match="unknown traffic keys"):
            Traffic.from_dict({"entry": "searcher", "nope": 1})
    else:
        entry = dict(spec["configs"][0], name="other")
        with pytest.raises(ValueError, match="holds configuration"):
            harness.load_config(entry)
