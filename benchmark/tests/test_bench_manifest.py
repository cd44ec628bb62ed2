"""``BENCHMARK.json`` keeps to its format: its keys, names,
units, bounds, the window's length against the check's time, and every
per-layer metric listing only cells that report the end-to-end metric it
moves."""

import json
import os
import re

from .conftest import REPO

M = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for e in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
    assert len(json.dumps(M)) < 64 * 1024


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in M[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds_and_window():
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert {e["name"] for e in M["end_to_end"]} >= {"setup_s"}
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    # the check's time with the full 24 cells: 2 + 14 n runs of rs + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_reports_enough():
    cells = {w["name"] for w in M["workloads"]}

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        e2e = [e["name"] for e in M["end_to_end"] if reports(e, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(p, cell) and p["moves"] in e2e
                   for p in M["per_layer"])
    for p in M["per_layer"]:
        moved = [e for e in M["end_to_end"] if e["name"] == p["moves"]][0]
        for cell in p["workloads"]:
            assert cell in cells and reports(moved, cell)
        assert "\n" not in p["layer"] and len(p["layer"]) <= 200
