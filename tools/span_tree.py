"""One run of a benchmark cell, with the program's span tree of its window.

    python3 tools/span_tree.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--out <file.json>]

Runs ``benchmark/run.py``'s entry unchanged (its result line on stdout) and
adds, on stderr and in ``--out``, what the window's jobs did under the
port's ``g_timer`` sections:

* ``spans``: each section path's ms a job, its self ms (its time less its
  children's) and calls a job;
* ``coverage``: the job's wall (``job_ms``) against the time under some
  span other than the roots (``scf-iteration``, ``jij-table``) and the
  phases (``recursion-phase``, ``dos-phase``), which are structure, not
  layers; ``uncovered_pct`` is the rest, as a share of the wall;
* ``routes``: the dispatch's routes (``parallel/dispatch.py routes`` and
  ``local_routes``) taken in the window, summed over its jobs: which route
  the recursions took (``wavefront_block``, ``full_block``, ...);
* ``plans``: the wavefront's plans made in the window and the levels of
  their BFS (``ops/wavefront.py plan_counts``), summed over its jobs;
* ``log_ms``: ms a job in the logger's calls (``utils/logger.py``), and
  the part of it under no span but the roots and the phases
  (``log_uncovered_ms``); the tool wraps the logger, so the lines it
  prints name ``span_tree.py`` as their source;
* with ``--trace 1``, ``device_copies``: the profiler's device-side
  events that carry a section's name, and whether each reads
  ``is_user_annotation()`` (``benchmark/device_trace.py`` leaves those out
  of the device's work).
"""

from __future__ import annotations

import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

STRUCTURE = ("scf-iteration", "jij-table", "recursion-phase", "dos-phase")


def snapshot(root) -> dict:
    """{path: (seconds, calls)} of every node below ``root``."""
    out, stack = {}, [(root, "")]
    while stack:
        node, path = stack.pop()
        for ch in node.children.values():
            p = f"{path}/{ch.name}" if path else ch.name
            out[p] = (ch.total, ch.ncalls)
            stack.append((ch, p))
    return out


def tree_summary(before: dict, after: dict, walls) -> dict:
    """Per path ms, self ms and calls a job over the window, and the
    coverage of the job's wall by the spans that are layers."""
    n = len(walls)
    delta = {p: (after[p][0] - before.get(p, (0.0, 0))[0],
                 after[p][1] - before.get(p, (0.0, 0))[1]) for p in after}
    delta = {p: v for p, v in delta.items() if v[1] > 0}
    spans = {}
    for p, (t, c) in sorted(delta.items()):
        kids = sum(v[0] for q, v in delta.items()
                   if q.startswith(p + "/") and "/" not in q[len(p) + 1:])
        spans[p] = {"ms": 1e3 * t / n, "self_ms": 1e3 * (t - kids) / n,
                    "calls": c / n}

    def layer_top(p):
        parts = p.split("/")
        return (parts[-1] not in STRUCTURE
                and all(q in STRUCTURE for q in parts[:-1]))

    covered = sum(t for p, (t, _) in delta.items() if layer_top(p))
    wall = sum(walls)
    return {"jobs": n, "spans": spans,
            "coverage": {"job_ms": 1e3 * wall / n,
                         "covered_ms": 1e3 * covered / n,
                         "uncovered_ms": 1e3 * (wall - covered) / n,
                         "uncovered_pct": 100.0 * (wall - covered) / wall}}


def device_copies(prof, names) -> dict:
    """{name: [count, count reading is_user_annotation()]} of the
    device-side events named as a section."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.name() in names:
            c = out.setdefault(e.name(), [0, 0])
            c[0] += 1
            c[1] += int(bool(e.is_user_annotation()))
    return out


def main(argv, **kw) -> int:
    """``kw`` goes to ``harness.main`` (``root``, ``device``: the CPU
    rehearsal at a small box)."""
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    from benchmark import harness
    from rslmtoasa_tpu_torch.ops import wavefront
    from rslmtoasa_tpu_torch.parallel import dispatch
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    from rslmtoasa_tpu_torch.utils.logger import Logger

    seen = {}
    inner = harness.window
    log = [False, 0.0, 0.0]  # in the window, seconds, of them uncovered
    inner_log = Logger._log

    def _log(self, level, msg):
        t = time.perf_counter()
        try:
            return inner_log(self, level, msg)
        finally:
            if log[0]:
                dt = time.perf_counter() - t
                log[1] += dt
                node = g_timer.current
                if node is g_timer.root or node.name in STRUCTURE:
                    log[2] += dt

    def window(job, seconds, device, traced):
        before = snapshot(g_timer.root)
        routes = dispatch.routes + dispatch.local_routes
        plans = +wavefront.plan_counts
        log[0] = True
        walls, window_s, prof = inner(job, seconds, device, traced)
        log[0] = False
        after = snapshot(g_timer.root)
        seen.update(tree_summary(before, after, walls))
        seen["routes"] = dict(dispatch.routes + dispatch.local_routes
                              - routes)
        seen["plans"] = dict(wavefront.plan_counts - plans)
        seen["log_ms"] = 1e3 * log[1] / len(walls)
        seen["log_uncovered_ms"] = 1e3 * log[2] / len(walls)
        seen["window_ms_per_job"] = 1e3 * window_s / len(walls)
        if prof is not None:
            names = {p.split("/")[-1] for p in after}
            seen["device_copies"] = device_copies(prof, names)
        return walls, window_s, prof

    harness.window = window
    Logger._log = _log
    rc = harness.main(argv, t0=T0, **kw)
    line = json.dumps(seen)
    print("span_tree " + line, file=sys.stderr, flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            fh.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
