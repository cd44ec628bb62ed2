"""The readings a cell's limits are set from: the program's, and the
control's.

    python3 benchmark/control.py --workload <cell> --seeds <n> ... \
        [--control 3] [--seconds 3] [--out file.json]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a window
of ``--seconds``, the comparison with the reference) gives the program's
readings.  For the first ``--control`` seeds the control stands in the
program's place: the reference computed a precision below the
configuration's complex128 (complex64 tables, recursion and Green function),
compared with the reference from the same seed.  A control that crashes has
failed, sets no upper end and is listed under ``crashed``.  A limit lies above the
largest of the program's readings and below the smallest of the control's.
The benchmark's own runs never run the control.  Prints one line per seed
and the extremes; ``--out`` writes them all as JSON.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness, jobs  # noqa: E402


def readings(cell, seeds, n_control, seconds, device):
    """{"program": {seed: readings}, "control": {seed: readings},
    "crashed": {seed: the control's error}}."""
    out = {"program": {}, "control": {}, "crashed": {}}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = harness.measure(cell, seed, seconds, False, device, t0)
        out["program"][seed] = dict(res["_readings"])
        print(f"seed {seed} program {out['program'][seed]}", flush=True)
        if i < n_control:
            state0 = jobs.seeded_state(cell.config, seed)
            try:
                out["control"][seed] = harness.control_readings(
                    cell, state0, res["_refs"]["start"], device)
            except RuntimeError as exc:  # torch's LinAlgError, OutOfMemoryError
                # a control that crashes has failed and sets no upper end
                out["crashed"][seed] = repr(exc)
                print(f"seed {seed} control crashed: {exc!r}", flush=True)
                continue
            print(f"seed {seed} control {out['control'][seed]}", flush=True)
    return out


def extremes(out) -> dict:
    """Per number: the program's largest reading, the control's
    smallest."""
    names = sorted({k for r in out["program"].values() for k in r})
    return {k: {"program_max": max(r[k] for r in out["program"].values()),
                "control_min": min((r[k] for r in out["control"].values()),
                                   default=None)}
            for k in names}


def main(argv=None, root=None, device="cuda"):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = harness.Cell(root or ROOT, args.workload)
    out = readings(cell, args.seeds, args.control, args.seconds, device)
    out["extremes"] = extremes(out)
    out["card"] = harness.power_limit() if device == "cuda" else "cpu"
    for k, v in out["extremes"].items():
        print(f"{k}: program max {v['program_max']!r}, control min "
              f"{v['control_min']!r}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
