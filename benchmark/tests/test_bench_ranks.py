"""A cell on four cards, run on the CPU as four gloo ranks through
``harness.main(device="cpu")``: one result line, ``correct``, the count of
cards, the chain-sharded route on rank 0, the same Jij table as one rank,
the comparison failing where the exchange between ranks is left out, and a
rank that raises or dies ending the run with no line and no process left.
Also K4's bound: on one card exactly the count before the multi-card
harness, on four the chains rank 0 recurs."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness, ranks, roofline

from .conftest import REPO, small_root
from .test_bench_run import run_cell

CELL = "dummy-jij4"
SEED = 5100000001

FAULTY_KIND = """
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "dummy_base", os.path.join(os.path.dirname(__file__), "exchange.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
roofline, reference, record, check, compare = (
    base.roofline, base.reference, base.record, base.check, base.compare)
FAULT = {fault!r}


class Job(base.Job):
    def run(self):
        import torch.distributed as dist

        rank = dist.get_rank()
        if FAULT == "raise" and rank == 1 and self.records:
            raise RuntimeError("a planted fault in the window")
        if FAULT == "die" and rank == 2:
            os._exit(3)
        base.Job.run(self)


def make_job(cell, sys_, workdir):
    if FAULT == "no_exchange":
        # each rank keeps its own share where the others' should come in
        import torch
        from rslmtoasa_tpu_torch.parallel import mesh

        def gather_chains(m, x, n, dim=1):
            return torch.cat([x] * m.world, dim=dim).narrow(dim, 0, n)

        mesh.gather_chains = gather_chains
    return Job(sys_, workdir, cell.traffic["pairs"])
"""


def four_card_root(where, fault=None) -> str:
    """The benchmark at box 6 with a four-card Jij cell of two pairs (R = 5
    chains: two a rank, copies of chain 0 padding ranks 2 and 3), lld 10 and
    300 energy channels, added as files and entries; ``fault`` plants one in
    the ranks through a kind of its own."""
    root = small_root(where)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "jij-block.json")) as fh:
        tr = json.load(fh)
    tr["pairs"] = tr["pairs"][:2]
    tr["namelists"]["control"]["lld"] = 10
    tr["namelists"]["energy"] = {"channels_ldos": 300}
    if fault is not None:
        tr["job"] = "dummy-faulty"
        with open(os.path.join(bench, "kinds", "dummy-faulty.py"), "w") as f:
            f.write(FAULTY_KIND.format(fault=fault))
    with open(os.path.join(bench, "traffic", CELL + ".json"), "w") as fh:
        json.dump(tr, fh)
    with open(os.path.join(bench, "limits", "bccfe30-jij-block.json")) as fh:
        limits = fh.read()
    with open(os.path.join(bench, "limits", CELL + ".json"), "w") as fh:
        fh.write(limits)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        m = json.load(fh)
    m["workloads"].append({"name": CELL, "config": "bccfe-nsp2-box30",
                           "traffic": CELL, "chips": 4, "why": "a test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "bccfe30-jij-block" in e.get("workloads", ()):
            e["workloads"].append(CELL)
    with open(path, "w") as fh:
        json.dump(m, fh)
    return root


def test_four_ranks_one_line(tmp_path, monkeypatch):
    root = four_card_root(tmp_path)
    seen = {}
    inner = ranks.execute

    def spy(*a, **k):
        seen["run"] = inner(*a, **k)
        return seen["run"]

    monkeypatch.setattr(ranks, "execute", spy)
    rc, res = run_cell(root, CELL, seed=SEED)
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 4
    m, records, _ = seen["run"]
    assert len(m.ranks) == 4
    assert res["device"]["memory_peak_bytes"] == max(
        i["peak"] for i in m.ranks)
    assert {i["jobs"] for i in m.ranks} == {m.n_jobs}
    assert m.ranks[0]["routes"].get("chains_block", 0) >= m.n_jobs
    # the same table on one rank: a process of its own with the ranks'
    # host threads (the CPU's plain recursion rounds with the thread count:
    # this process's threads read 2.9e-11 mRy apart)
    cell = harness.Cell(root, CELL)
    cell.workload = dict(cell.workload, chips=1)
    one_m, one, _ = ranks.execute(cell, SEED, 0.1, False, "cpu",
                                  time.perf_counter())
    assert one_m.ranks[0]["routes"] == {}
    for key in ("jij", "dmi", "aij"):
        gap = abs(records[-1][key] - one[-1][key]).max()
        assert gap <= 1e-12, (key, gap)


def test_exchange_between_ranks_left_out(tmp_path):
    rc, res = run_cell(four_card_root(tmp_path, "no_exchange"), CELL,
                       seed=SEED)
    assert rc == 0 and res["correct"] is False
    row = res["checks"]["coef"]
    assert not row["value"] <= row["limit"]


def _left_in(root: str) -> list:
    """Processes whose working directory is ``root``."""
    left = []
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                if os.readlink(f"/proc/{pid}/cwd") == root:
                    left.append(int(pid))
            except OSError:
                pass
    return left


@pytest.mark.parametrize("fault,said", [
    ("raise", "a planted fault in the window"), ("die", "cluster built")])
def test_failing_rank_ends_the_run(tmp_path, fault, said):
    """Rank 1 raises in the window, or rank 2 dies in its warm-up (after
    rank 0 has logged its cluster): the run exits nonzero, prints no line,
    and leaves no rank behind."""
    root = four_card_root(tmp_path, fault)
    code = (f"import sys; sys.path[:0] = [{root!r}, {REPO!r}]; "
            "from benchmark.harness import main; "
            f"sys.exit(main(['--workload', '{CELL}', '--seed', '{SEED}', "
            f"'--seconds', '0.5'], root={root!r}, device='cpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0 and not res.stdout.strip()
    assert said in res.stderr and "failed" in res.stderr
    deadline = time.monotonic() + 120
    while _left_in(root) and time.monotonic() < deadline:
        time.sleep(1)
    assert _left_in(root) == []


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.load(open(os.path.join(
        REPO, "BENCHMARK.json")))["workloads"]])
def test_k4_bound_counts_rank_zero(workload, chips):
    """One card: the bound the harness computed before it ran several
    cards, bit for bit.  Four: the first ceil(R / 4) chains where the
    dispatch shards them (R >= 4), every chain where it does not."""
    cell = harness.Cell(REPO, workload)
    cell.workload = dict(cell.workload, chips=chips)
    box = cell.box()
    chains, launches, gram = cell.kind.roofline(cell, box)
    if chips == 4 and len(chains) >= 4:
        chains = chains[:-(-len(chains) // 4)]
    want = roofline.recursion_bound(box, chains, launches, 18, gram) * 3
    assert harness.Measured(cell, walls=[1.0] * 3).k4_bound_s() == want


def test_four_ranks_traced(tmp_path):
    """With ``--trace 1`` rank 0's profile and sections give the per-layer
    metrics."""
    root = four_card_root(tmp_path)
    rc, res = run_cell(root, CELL, trace=1, seed=SEED + 2)
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert {"busy_s", "window_s", "count"} <= set(res["device"])
    assert res["device"]["count"] == 4 and "breakdown" in res
    assert "pair_recursion_ms.post" in res["metrics"]
