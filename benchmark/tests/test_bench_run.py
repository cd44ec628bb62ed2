"""The harness end to end on the CPU at a 6^3 box: each cell runs through
the same entry, prints the result line's keys, and agrees with the reference
under its limits; a measuring run without a card fails; a new cell,
configuration, traffic mix and per-layer metric come in as new files and
new entries alone."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from .conftest import REPO, small_root

CELLS = [w["name"] for w in json.load(open(os.path.join(
    REPO, "BENCHMARK.json")))["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_cell(root, cell, trace=0, seconds=0.5, seed=3000000019):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          root=root, device="cpu")
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_every_cell_resolves_its_files():
    manifest = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in manifest["workloads"]:
        cell = harness.Cell(REPO, w["name"])
        for name in ("make_job", "roofline", "reference", "record", "check",
                     "compare"):
            assert callable(getattr(cell.kind, name))
        for m in cell.metrics(False) + cell.metrics(True):
            assert callable(cell.reader(m["name"]))
        assert cell.box().kk == cell.config["n1"] ** 3


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu(small, cell):
    rc, res = run_cell(small, cell)
    assert rc == 0
    assert set(res) == KEYS and list(res)[-1] == "checks"
    want = {m["name"] for m in harness.Cell(small, cell).metrics(False)}
    assert set(res["metrics"]) == want
    assert res["attempted"] >= 1 and res["failed"] == 0
    bad = {k: v for k, v in res["checks"].items()
           if not v["value"] <= v["limit"]}
    assert res["correct"] is True, bad


def test_traced_run_on_cpu(small):
    rc, res = run_cell(small, "bccfe30-scf-cheb", trace=1)
    assert rc == 0 and set(res) == KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    names = {m["name"] for m in harness.Cell(
        small, "bccfe30-scf-cheb").metrics(True)}
    assert set(res["metrics"]) <= names
    assert "atomic_scf_ms.scf" in res["metrics"]
    assert "terminators_ms.scf" not in res["metrics"]  # no fits here


def test_no_card_fails():
    with pytest.raises(harness.NoCard):
        harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1"], root=REPO)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()


def test_new_cell_from_new_files(tmp_path):
    """A dummy configuration (an 8^3 box), kind of job (two SCF iterations a
    job), traffic mix of that kind (another mixing), per-layer metric and
    cell, added as files and entries only."""
    root = small_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    before = {p: open(os.path.join(d, p), "rb").read()
              for d, _, fs in os.walk(bench) for p in fs}
    cfg = json.load(open(os.path.join(bench, "configs",
                                      "bccfe-nsp2-box30.json")))
    cfg["n1"] = cfg["n2"] = cfg["n3"] = 8
    json.dump(cfg, open(os.path.join(bench, "configs", "dummy-box8.json"),
                        "w"))
    with open(os.path.join(bench, "kinds", "dummy-kind.py"), "w") as f:
        f.write(DUMMY_KIND)
    tr = json.load(open(os.path.join(bench, "traffic", "scf-block.json")))
    tr["namelists"]["mix"] = {"beta": 0.1}
    tr["job"] = "dummy-kind"
    json.dump(tr, open(os.path.join(bench, "traffic", "dummy-mix.json"),
                       "w"))
    with open(os.path.join(bench, "metrics", "dummy_jobs.scf.py"), "w") as f:
        f.write("def read(run):\n    return float(run.n_jobs)\n")
    shutil.copy(os.path.join(bench, "limits", "bccfe30-scf-block.json"),
                os.path.join(bench, "limits", "dummy-cell.json"))
    path = os.path.join(root, "BENCHMARK.json")
    m = json.load(open(path))
    m["configs"].append(dict(m["configs"][0], name="dummy-box8",
                             file="benchmark/configs/dummy-box8.json"))
    m["workloads"].append({"name": "dummy-cell", "config": "dummy-box8",
                           "traffic": "dummy-mix", "chips": 1,
                           "why": "a test"})
    for e in m["end_to_end"]:
        if "workloads" in e and "bccfe30-scf-block" in e["workloads"]:
            e["workloads"].append("dummy-cell")
    m["per_layer"].append({"name": "dummy_jobs.scf", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "host", "moves": "scf_iter_s",
                           "workloads": ["dummy-cell"]})
    json.dump(m, open(path, "w"))
    after = {p: open(os.path.join(d, p), "rb").read()
             for d, _, fs in os.walk(bench) for p in fs}
    assert all(after[p] == v for p, v in before.items())
    cell = harness.Cell(root, "dummy-cell")
    assert cell.kind.__name__ == "bench_kind_dummy_kind"
    rc, res = run_cell(root, "dummy-cell", trace=1)
    assert rc == 0 and res["metrics"]["dummy_jobs.scf"]["value"] >= 1
    assert res["correct"] is True


DUMMY_KIND = """
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "dummy_base", os.path.join(os.path.dirname(__file__), "scf.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
roofline, reference, record, check, compare = (
    base.roofline, base.reference, base.record, base.check, base.compare)


class Job(base.Job):
    def run(self):
        base.Job.run(self)
        base.Job.run(self)


def make_job(cell, sys_, workdir):
    return Job(sys_, workdir)
"""
