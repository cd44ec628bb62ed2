"""The device allocations live at the peak of one job of a benchmark cell.

    python3 tools/peak_tensors.py --workload <cell> --seed <n> \
        [--above <GB>] [--out <file.json>]

Builds the cell's system as ``benchmark/run.py`` does and runs its job
twice: once to warm up (the kernels' build, the first plans), then once with
the CUDA caching allocator recording its history
(``torch.cuda.memory._record_memory_history``, Python frames).  The history
is replayed, allocation by allocation, to find when the live bytes peaked;
each allocation then live of more than ``--above`` GB (default 1) is printed
with its bytes and the innermost frames of the port or the benchmark that
made it.  Also printed: ``max_memory_allocated`` of the recorded job, the
bytes live before it (the system's tables), its wall and the ms of each of
the program's timer sections in it.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from benchmark import harness, jobs  # noqa: E402

OURS = ("rslmtoasa_tpu_torch", "benchmark")


def peak_live(events: list):
    """(bytes live at the peak, [(bytes, frames)] of the allocations then
    live) over the allocator's ``alloc`` / ``free_requested`` events."""
    live, total, best, at = {}, 0, 0, {}
    for ev in events:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            total += ev["size"]
            if total > best:
                best, at = total, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    return best, sorted(at.values(), key=lambda v: -v[0])


def where(frames: list, n: int = 3) -> list:
    """The innermost ``n`` frames in the port's or the benchmark's files."""
    return [f"{os.path.relpath(f['filename'], ROOT)}:{f['line']} "
            f"{f['name']}" for f in frames
            if any(k in f["filename"] for k in OURS)][:n]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--above", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cell = harness.Cell(ROOT, args.workload)
    with tempfile.TemporaryDirectory(prefix="peak-") as wd:
        state = jobs.seeded_state(cell.config, args.seed)
        sys_ = jobs.build_system(cell.config, cell.traffic, state, wd,
                                 "cuda")
        job = cell.kind.make_job(cell, sys_, wd)
        job.run()
        torch.cuda.synchronize()
        job.last = None  # as the next job does first
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        tot0, calls0 = harness._timer_totals()
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")
        t = time.perf_counter()
        job.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        peak = torch.cuda.max_memory_allocated()
        tot1, calls1 = harness._timer_totals()
        job.close()
    events = snap["device_traces"][torch.cuda.current_device()]
    best, allocs = peak_live(events)
    big = [{"bytes": b, "where": where(f)} for b, f in allocs
           if b > args.above * 1e9]
    out = {"workload": args.workload, "seed": args.seed,
           "card": harness.power_limit(), "max_memory_allocated": peak,
           "live_before_job": before, "job_peak_live": before + best,
           "job_s": wall, "allocations_above": big,
           "sections_ms": {k: 1e3 * (tot1[k] - tot0.get(k, 0.0))
                           for k in tot1 if calls1[k] > calls0.get(k, 0)}}
    print(json.dumps(out, indent=1), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
