"""BENCHMARK.json against the rules the harness and its readers rely on:
names, units, the metrics each cell reports and moves, every file found by
name, one chip a cell."""

import json
import os
import re

import pytest

from benchmark.harness.main import load_cell, reader
from benchmark.tests.tiny import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_per_layer_metrics_move(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"] if reports(m, cell)]
    assert per
    for m in per:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_moves_names_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
    c = load_cell(ROOT, cell)
    assert c.config["name"] == w["config"] and c.traffic["kind"] in ("serve", "train")
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(reader(ROOT, m))


def test_configs():
    for conf in BENCH["configs"]:
        assert conf["file"].startswith("benchmark/configs/")
        with open(os.path.join(ROOT, conf["file"])) as f:
            doc = json.load(f)
        assert doc["source"] == conf["source"] and doc["reduced"] == conf["reduced"] == []
        assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
