"""One run of one cell: build, warm up, measure a window of whole jobs,
check the outputs against the plain reference, print the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything a cell is comes from files found by name: the cell in
``BENCHMARK.json``, its configuration (``configs/``), its traffic
(``traffic/<mix>.json``), the kind of job the traffic names
(``kinds/<kind>.py``: what a job is, its reference, its record layout, the
numbers it compares and its K4 work), its limits (``limits/<cell>.json``)
and one reader per metric (``metrics/<metric>.py``, a function
``read(run)`` that returns the value or None).  The harness holds no branch
per kind.  Set-up runs from the process's start to the end of the
warm-up job; the window runs jobs in a closed loop from the first timed
job's start until ``--seconds`` have passed and the job under way has ended.
With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the per-layer metrics; otherwise the end-to-end ones.  A cell on
more than one card runs one process a card (:mod:`benchmark.ranks`); the
comparison and the line stay in the process the command started.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from . import checks, jobs, roofline
from .reference import lattice

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "rslmtoasa_tpu")


class NoCard(RuntimeError):
    """A measuring run found fewer cards than its cell asks for."""


# ----------------------------------------------------------------------
# the cell, from its files
class Cell:
    def __init__(self, root: str, workload: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.manifest = json.load(fh)
        found = [w for w in self.manifest["workloads"]
                 if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        centry = [c for c in self.manifest["configs"]
                  if c["name"] == self.workload["config"]][0]
        self.config = self._json(centry["file"])
        self.traffic = self._json(os.path.join(
            "benchmark", "traffic", self.workload["traffic"] + ".json"))
        self.limits = self._json(os.path.join(
            "benchmark", "limits", workload + ".json"))
        self.kind = _load(os.path.join(root, "benchmark", "kinds",
                                       self.traffic["job"] + ".py"),
                          "bench_kind_" + self.traffic["job"])

    def _json(self, rel: str) -> dict:
        with open(os.path.join(self.root, rel)) as fh:
            return json.load(fh)

    def metrics(self, traced: bool) -> list:
        """The metric entries this cell reports in a run of this kind."""
        e2e = [m for m in self.manifest["end_to_end"] if self._in(m)]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"]
                if m["moves"] in names and self._in(m)]

    def _in(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, name: str):
        path = os.path.join(self.root, "benchmark", "metrics", name + ".py")
        return _load(path, "bench_metric_" + name).read

    # the entries the reference reads
    def groups(self) -> dict:
        return jobs.namelists(self.config, self.traffic)

    def box(self) -> lattice.BccBox:
        lat = self.groups()["lattice"]
        return lattice.BccBox((self.config["n1"], self.config["n2"],
                               self.config["n3"]), lat["alat"],
                              lat["ct"][0])

    def run_params(self) -> dict:
        g = self.groups()
        ctl, lat, en = g["control"], g["lattice"], g["energy"]
        return {"recur": ctl["recur"], "lld": ctl["lld"], "nsp": ctl["nsp"],
                "txc": ctl["txc"], "sym_term": ctl["sym_term"],
                "energy": {k: en[k] for k in (
                    "channels_ldos", "energy_min", "energy_max", "fermi",
                    "fix_fermi")},
                "beta": g["mix"]["beta"], "mixtype": g["mix"]["mixtype"],
                "wav": lat["wav"], "r2": lat["r2"], "alat": lat["alat"],
                "ws_max": g["self"]["ws_max"]}


def _load(path: str, name: str):
    """The module of the file ``path``."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
class Measured:
    """What one run measured; what the metric readers read."""

    def __init__(self, cell: Cell, **kw):
        self.cell = cell
        self.trace = None
        self.__dict__.update(kw)

    @property
    def n_jobs(self) -> int:
        return len(self.walls)

    def section_ms(self, *names: str) -> Optional[float]:
        """Milliseconds a job of the window spent in the program's timer
        sections ``names``, or None where none of them ran."""
        calls = sum(self.calls.get(n, 0) for n in names)
        if calls == 0:
            return None
        return 1e3 * sum(self.sections.get(n, 0.0) for n in names) \
            / self.n_jobs

    def k4_bound_s(self) -> float:
        """The K4 bound of the window's jobs (:mod:`roofline`) on the card
        that is traced.  On N cards that is rank 0's: the dispatch shards
        R >= N chains over the ranks and rank 0 recurs the first
        ceil(R / N) (padding copies of chain 0 go to the last ranks); with
        fewer chains than ranks each rank recurs all of them."""
        box = self.cell.box()
        chains, launches, gram = self.cell.kind.roofline(self.cell, box)
        world = int(self.cell.workload["chips"])
        if len(chains) >= world:
            chains = chains[:-(-len(chains) // world)]
        per_job = roofline.recursion_bound(box, chains, launches, 18, gram)
        return per_job * self.n_jobs


def _timer_totals():
    """(seconds, calls) of each section name of the program's timer tree."""
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    tot, calls = {}, {}
    stack = [g_timer.root]
    while stack:
        node = stack.pop()
        for ch in node.children.values():
            tot[ch.name] = tot.get(ch.name, 0.0) + ch.total
            calls[ch.name] = calls.get(ch.name, 0) + ch.ncalls
            stack.append(ch)
    return tot, calls


def _k4_launches() -> int:
    from rslmtoasa_tpu_torch.ops import block_kernels

    return block_kernels.block_step.launches


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_name(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def draw(seed: int, n: int) -> int:
    """The window job the seed picks for the comparison, 1 .. n."""
    return 1 + int(np.random.default_rng([int(seed), 1]).integers(n))


# ----------------------------------------------------------------------
def window(job, seconds: float, device, traced: bool, agree=None):
    """Run whole jobs until ``seconds`` have passed; (walls, window_s,
    profile or None).  On several cards ``agree(stop)`` (:mod:`ranks`) is
    the ranks' stop flag, set by rank 0's clock: the ranks start the window
    together, and after each job every rank learns whether it goes on, so
    a job's wall runs until its slowest rank has finished it."""
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    walls = []
    if agree is not None:
        agree(False)
    span = torch.profiler.record_function("bench.window") if traced else None
    if span is not None:
        span.__enter__()
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t = time.perf_counter()
        job.run()
        _sync(device)
        now = time.perf_counter()
        stop = now >= deadline
        if agree is not None:
            stop = agree(stop)
            now = time.perf_counter()
        walls.append(now - t)
        if stop:
            break
    window_s = time.perf_counter() - start
    if span is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    return walls, window_s, prof


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t0: float):
    """Build, warm up and measure; returns (Measured, the job's records,
    the slot vectors of the program's table)."""
    from .device_trace import Trace

    with tempfile.TemporaryDirectory(prefix="bench-") as wd:
        state = jobs.seeded_state(cell.config, seed)
        sys_ = jobs.build_system(cell.config, cell.traffic, state, wd,
                                 device)
        job = cell.kind.make_job(cell, sys_, wd)
        try:
            job.run()
            _sync(device)
            setup_s = time.perf_counter() - t0
            tot0, calls0 = _timer_totals()
            k0 = _k4_launches()
            walls, window_s, prof = window(job, seconds, device, traced)
            tot1, calls1 = _timer_totals()
            peak = (torch.cuda.max_memory_allocated()
                    if torch.device(device).type == "cuda" else 0)
            job.finish()
        finally:
            job.close()
        m = Measured(
            cell, setup_s=setup_s, window_s=window_s, walls=walls,
            seconds=seconds, memory_peak_bytes=int(peak),
            sections={k: tot1[k] - tot0.get(k, 0.0) for k in tot1},
            calls={k: calls1[k] - calls0.get(k, 0) for k in calls1},
            k4_launches=_k4_launches() - k0)
        if prof is not None:
            m.trace = Trace(prof)
            del prof
        records = job.records
        slots = np.asarray(sys_.cluster.dirs[0])
        del job, sys_
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return m, records, slots


# ----------------------------------------------------------------------
def control_readings(cell: Cell, state0: dict, ref: dict, device) -> dict:
    """The control's readings: the reference in complex64 (its tables
    rounded to complex64, its recursion and Green function computed in it)
    in the program's place, from the seed's state, against ``ref``, the
    reference's outputs from the same state."""
    kind = cell.kind
    ctrl = kind.record(cell, kind.reference(cell, state0, device,
                                            torch.complex64), lower=True)
    vectors = cell.box().vectors
    return kind.check(ctrl, ref, vectors, vectors)


# ----------------------------------------------------------------------
def measure(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t0: float) -> dict:
    """One whole run: the result line's object."""
    if int(cell.workload["chips"]) > 1:
        from . import ranks

        m, records, slots = ranks.execute(cell, seed, seconds, traced,
                                          device, t0)
    else:
        m, records, slots = execute(cell, seed, seconds, traced, device, t0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {', '.join(found)}")
    metrics = {}
    for entry in cell.metrics(traced):
        value = cell.reader(entry["name"])(m)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    state0 = jobs.seeded_state(cell.config, seed)
    k = draw(seed, len(records) - 1)
    readings, refs = cell.kind.compare(cell, records, slots, k, device,
                                       state0)
    ok, rows = checks.judge(readings, cell.limits)
    result = {"correct": bool(ok), "attempted": m.n_jobs, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if torch.device(device).type
                         == "cuda" else "cpu",
                         "kind": card_name(device),
                         "count": int(cell.workload["chips"]),
                         "memory_peak_bytes": m.memory_peak_bytes}}
    if m.trace is not None:
        result["device"]["busy_s"] = m.trace.busy_s
        result["device"]["window_s"] = m.trace.window_s
        result["breakdown"] = m.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    result["_measured"] = m
    result["_rows"] = rows
    result["_refs"] = refs
    result["_readings"] = readings
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None, root: Optional[str] = None,
         device: str = "cuda") -> int:
    """The command.  ``device`` other than cuda is for the tests: a
    measuring run requires the cards its cell asks for."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = Cell(root or os.path.dirname(BENCH), args.workload)
    chips = int(cell.workload["chips"])
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= chips):
        raise NoCard(f"{args.workload} needs {chips} card(s); found "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if device == "cuda":
        if chips == 1:  # the ranks of a larger cell take their own cards
            torch.cuda.set_device(0)
        print(f"card: {power_limit()}", file=sys.stderr)
    res = measure(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    m, rows = res.pop("_measured"), res.pop("_rows")
    del res["_refs"], res["_readings"]
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {', '.join(found)}")
    print(f"jobs {m.n_jobs} in {m.window_s:.3f} s; K4 launches "
          f"{m.k4_launches}; setup {m.setup_s:.3f} s", file=sys.stderr)
    for r, info in enumerate(getattr(m, "ranks", ())):
        print(f"rank {r}: peak {info['peak']} B; K4 launches "
              f"{info['k4_launches']}; routes {info['routes']}",
              file=sys.stderr)
    if m.trace is not None:
        print(f"device busy {m.trace.busy_s:.4f} s of {m.trace.window_s:.4f}"
              f" s", file=sys.stderr)
    for name, v, lim in rows:
        mark = "ok" if lim is not None and math.isfinite(v) and v <= lim \
            else "FAIL"
        print(f"check {name} {v!r} limit {lim!r} {mark}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
