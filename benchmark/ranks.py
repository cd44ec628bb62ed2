"""A cell on N > 1 cards: one process a card, rank 0 measures.

The process the command starts joins no process group and touches no card
while the ranks run.  It starts N rank processes (``spawn``), one a card,
each joining through the port's own entry,
``parallel/mesh.init_distributed``: rank r on ``cuda:r`` over NCCL, the
group ``torchrun`` gives users (gloo ranks on the host where the tests run
``main(device="cpu")``).  As under ``torchrun``, each rank runs
``OMP_NUM_THREADS=1`` unless the environment sets it.

Each rank builds the cell's system with ``jobs.build_system`` in a workdir
of its own (only rank 0 logs, as ``cli._run_rank`` has it) and runs the
warm-up job; set-up runs from the starting process's ``T0`` to the moment
the last rank has finished it (``time.perf_counter`` is the host's monotonic
clock, one clock for every process).  Then every rank runs the same closed
loop of whole jobs (``harness.window``): after each job one all-reduce of a
stop flag, set by rank 0's clock, says whether the window goes on, so a
job's wall runs until its slowest rank has finished it and every rank runs
the same jobs.  Only rank 0 runs the profiler with ``--trace 1``.

Rank 0 sends its walls, sections, counts, records and trace to the starting
process; every rank sends its peak, its K4 launches and the dispatch's
routes it took in the window.  The comparison runs in the starting process
once every rank has exited, so the cards are free.  A rank that raises,
dies, or is not done within the run's limits ends the run with an error;
no rank outlives it (the starting process stops them on its way out, and
the kernel kills each with the starting process, however that ends).  Rank
processes write nothing to stdout.
"""

from __future__ import annotations

import ctypes
import multiprocessing
import os
import queue as queue_mod
import shutil
import signal
import tempfile
import time
import traceback

import numpy as np
import torch

from . import harness, jobs

#: the longest a run may take from its start (the first run of a cell in a
#: checkout, which builds the kernels): every rank has ended by then
RUN_LIMIT_S = 1200.0
#: after the last rank's warm-up: the window, the job under way when it
#: closes, the records and the trace handed over
AFTER_WINDOW_S = 300.0
PR_SET_PDEATHSIG = 1


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float):
    """Build, warm up and measure on ``chips`` ranks; returns (Measured,
    rank 0's records, the slot vectors of its table), as
    ``harness.execute`` does for one card.  The Measured also holds
    ``ranks``: each rank's ``peak``, ``jobs``, ``k4_launches`` and
    ``routes``."""
    world = int(cell.workload["chips"])
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="bench-rdv-")
    args = (world, "file://" + os.path.join(tmp, "rendezvous"), cell.root,
            cell.name, int(seed), float(seconds), bool(traced),
            str(device), float(t0), os.getpid(), out)
    procs = [ctx.Process(target=_rank, args=(r,) + args)
             for r in range(world)]
    threads = "OMP_NUM_THREADS" not in os.environ
    try:
        if threads:
            os.environ["OMP_NUM_THREADS"] = "1"
        try:
            for p in procs:
                p.start()
        finally:
            if threads:
                del os.environ["OMP_NUM_THREADS"]
        got = _collect(procs, out, world, seconds, t0)
    finally:
        _stop(procs)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    ready, info, res = got
    m = harness.Measured(
        cell, setup_s=max(ready) - t0, window_s=res["window_s"],
        walls=res["walls"], seconds=seconds,
        memory_peak_bytes=max(i["peak"] for i in info),
        sections=res["sections"], calls=res["calls"],
        k4_launches=info[0]["k4_launches"], ranks=info)
    m.trace = res["trace"]
    return m, res["records"], res["slots"]


def _collect(procs, out, world: int, seconds: float, t0: float):
    """Drain the ranks' messages until every rank has sent its own and rank
    0 its results, and every rank has exited; (warm-up ends by rank, rank
    infos by rank, rank 0's results)."""
    ready, info, res = {}, {}, None
    limit = t0 + RUN_LIMIT_S
    while True:
        try:
            kind, r, val = out.get(timeout=0.5)
        except queue_mod.Empty:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or all(c is not None for c in codes):
                msg = _late_error(out)
                raise RuntimeError(
                    msg or f"rank exit codes {codes} before every rank "
                    f"reported (ranks done: {sorted(info)})")
            if time.perf_counter() > limit:
                raise TimeoutError(
                    f"the ranks did not finish within the run's limit "
                    f"(warmed up: {sorted(ready)}, done: {sorted(info)})")
            continue
        if kind == "error":
            raise RuntimeError(f"rank {r} of {world} failed:\n{val}")
        if kind == "ready":
            ready[r] = val
            if len(ready) == world:
                limit = min(limit, time.perf_counter() + seconds
                            + AFTER_WINDOW_S)
        elif kind == "rank":
            info[r] = val
        elif kind == "result":
            res = val
        if len(info) == world and res is not None:
            break
    for p in procs:
        p.join(max(1.0, limit - time.perf_counter()))
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"rank exit codes {codes}")
    return list(ready.values()), [info[r] for r in range(world)], res


def _late_error(out) -> str:
    """A failed rank's traceback, if it sent one before it ended."""
    try:
        while True:
            kind, r, val = out.get(timeout=5.0)
            if kind == "error":
                return f"rank {r} failed:\n{val}"
    except queue_mod.Empty:
        return ""


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


# ----------------------------------------------------------------------
# a rank
def _rank(r: int, world: int, rdv: str, root: str, workload: str,
          seed: int, seconds: float, traced: bool, device: str, t0: float,
          parent: int, out) -> None:
    """Rank ``r``: join the group, build, warm up, run the window, report."""
    os.dup2(2, 1)  # nothing of a rank reaches the result's stdout
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:  # the starting process has already gone
        os._exit(1)
    try:
        _run_rank(r, world, rdv, root, workload, seed, seconds, traced,
                  device, t0, out)
    except BaseException:
        out.put(("error", r, traceback.format_exc()))
        raise


def _run_rank(r, world, rdv, root, workload, seed, seconds, traced, device,
              t0, out) -> None:
    import torch.distributed as dist
    from rslmtoasa_tpu_torch.parallel import dispatch
    from rslmtoasa_tpu_torch.parallel.mesh import init_distributed, shutdown
    from rslmtoasa_tpu_torch.utils.logger import g_logger

    dev = init_distributed(r, world, r, device=device, init_method=rdv)
    if r != 0:
        g_logger.level = 100  # above fatal: only rank 0 logs
    wire = torch.device("cpu") if dist.get_backend() == "gloo" else dev

    def agree(stop: bool) -> bool:
        flag = torch.tensor([1.0 if (r == 0 and stop) else 0.0],
                            dtype=torch.float64, device=wire)
        dist.all_reduce(flag)
        return bool(flag.item())

    cell = harness.Cell(root, workload)
    with tempfile.TemporaryDirectory(prefix=f"bench-rank{r}-") as wd:
        state = jobs.seeded_state(cell.config, seed)
        sys_ = jobs.build_system(cell.config, cell.traffic, state, wd, dev)
        job = cell.kind.make_job(cell, sys_, wd)
        try:
            job.run()
            harness._sync(dev)
            out.put(("ready", r, time.perf_counter()))
            tot0, calls0 = harness._timer_totals()
            k0 = harness._k4_launches()
            routes0 = dict(dispatch.routes)
            walls, window_s, prof = harness.window(
                job, seconds, dev, traced and r == 0, agree)
            tot1, calls1 = harness._timer_totals()
            k4 = harness._k4_launches() - k0
            routes = {k: v - routes0.get(k, 0)
                      for k, v in dispatch.routes.items()
                      if v - routes0.get(k, 0)}
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            if r == 0:
                job.finish()
        finally:
            job.close()
        found = harness.forbidden_modules()
        if found:
            raise RuntimeError(f"rank {r} holds {', '.join(found)}")
        out.put(("rank", r, {"peak": int(peak), "jobs": len(walls),
                             "k4_launches": k4, "routes": routes}))
        if r == 0:
            from .device_trace import Trace

            out.put(("result", 0, {
                "walls": walls, "window_s": window_s,
                "sections": {k: tot1[k] - tot0.get(k, 0.0) for k in tot1},
                "calls": {k: calls1[k] - calls0.get(k, 0) for k in calls1},
                "trace": None if prof is None else Trace(prof),
                "records": _host(job.records),
                "slots": np.asarray(sys_.cluster.dirs[0])}))
    shutdown()


def _host(x):
    """``x`` with every tensor a NumPy array, so that it pickles by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x
