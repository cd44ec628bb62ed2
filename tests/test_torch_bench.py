"""The port's bench entry point, at a small shape on the CPU.

``rslmtoasa_tpu_torch.bench.main`` builds the synthetic bcc box, times
both recursion engines, runs its NumPy complex128 host guard (which
raises on a miss) and prints one JSON line.  Its numbers here are CPU
numbers; the test checks the line's form and the guard, not speed.
"""

import json
import math

from rslmtoasa_tpu_torch import bench

KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step",
        "sustained_tf_s", "flops_per_nnz", "guard_max_abs_err", "device"}


def test_bench_prints_one_json_line(capsys):
    line = bench.main(box=6, lld=4, n_start=2, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    parsed = json.loads(out[0])
    assert parsed == line and set(parsed) == KEYS
    assert parsed["metric"] == "bsr_recursion_spmv_throughput"
    assert parsed["unit"] == "Gnnz/s" and parsed["flops_per_nnz"] == 8
    assert parsed["device"] == "cpu"
    assert parsed["value"] > 0 and parsed["vs_baseline"] > 0
    assert parsed["guard_max_abs_err"] <= bench.GUARD_ATOL
    # the work behind the rate: 216 rows x 15 slots x 81 entries x 18
    # chains x 3 steps, at 8 flop each
    work = 216 * 15 * 81 * 18 * 3
    seconds = parsed["ms_per_step"] * 3 / 1e3
    assert math.isclose(parsed["value"] * 1e9 * seconds, work, rel_tol=1e-9)
    assert math.isclose(parsed["sustained_tf_s"], 8 * parsed["value"] / 1e3,
                        rel_tol=1e-12)
