"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""

import json
import os
import re

import pytest

from anns_bench.cell import HERE, ROOT, load_cell, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["anns_bench"]
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_text(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("anns_bench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    every = [x["name"] for x in bench["configs"] + bench["workloads"]
             + bench["end_to_end"] + bench["per_layer"]]
    assert len(every) == len(set(every))
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_loads_with_its_readers(bench):
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_reader(m["name"]))
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
