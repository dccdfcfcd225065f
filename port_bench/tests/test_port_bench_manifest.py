"""BENCHMARK.json against the rules the harness relies on: names and
units in the allowed characters, every cell's configuration, workload
file, entry and metric readers present, every per-layer metric's
``moves`` reported by each of its cells, and the run length within what
a full check of 24 cells allows."""

import importlib.util
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
M = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = {w["name"]: w for w in M["workloads"]}


def reported(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["port_bench"]
    assert M["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_run_length_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [x["name"] for x in METRICS]
                         + [c["name"] for c in M["configs"]]
                         + list(CELLS) + [w["traffic"] for w in
                                          M["workloads"]])
def test_names(name):
    assert NAME.match(name), name


def test_unique():
    for group in (METRICS, M["configs"], M["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = os.path.join(HERE, "metrics", metric["name"] + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.UNIT == metric["unit"]
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in M["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moves = {m["name"]: m for m in M["end_to_end"]}[metric["moves"]]
        for cell in metric["workloads"]:
            assert reported(moves, cell), (metric["name"], cell)
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    cfg = {c["name"]: c for c in M["configs"]}[cell["config"]]
    assert cfg["file"].startswith("port_bench/")
    config = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert config["name"] == cell["config"]
    spec = json.load(open(os.path.join(HERE, "workloads",
                                       cell["name"] + ".json")))
    assert os.path.exists(os.path.join(HERE, "entries",
                                       spec["entry"] + ".py"))
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    e2e = [m for m in M["end_to_end"] if reported(m, cell["name"])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(reported(m, cell["name"]) for m in M["per_layer"])


def test_four_chip_cells():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(M["workloads"]) // 4)
