"""Benchmark: scalar Haydock recursion throughput on one CUDA card.

    python -m rslmtoasa_tpu_torch.bench

The workload and the metric are those of the JAX package's root
``bench.py``: the batched Haydock recursion on the synthetic bcc box
(``build_synthetic_bcc(rc=120, ndim=1_000_000, lld=20, box=30)``,
kk = 27 000, 15 ELL slots), one spin channel, 16 start atoms x 9 orbitals
= 144 chains, 19 recursion steps.  Throughput counts logical Hamiltonian
entries: ``nnz = kk * nslots * 81`` per SpMV, once per chain per step,
in Gnnz/s.  A NumPy complex128 recursion on the host is the guard (its
first 3 steps' ``a`` within 1e-8) and the baseline (``vs_baseline``).

Prints ONE JSON line on stdout, for the default engine (K1' + K3'):
``metric``, ``value``, ``unit``, ``vs_baseline``, ``ms_per_step``,
``sustained_tf_s`` (the FP64 rate at 8 flop per complex MAC, so
``flops_per_nnz`` is 8), ``guard_max_abs_err`` and ``device``.  On
stderr it also times the ``roll`` engine (K2' + K3') and prints the two
engines' difference in ``a``.

The recursion is timed on the device the caller names (default the card;
``cuda`` without one raises): host clock around
``HaydockOperator.coefficients`` between two ``torch.cuda.synchronize()``
calls.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .models.presets import build_synthetic_bcc
from .ops.lanczos import HaydockOperator, scalar_start_vectors
from .utils.device import resolve_device, synchronize

FLOPS_PER_NNZ = 8  # one complex multiply-add in FP64
GUARD_STEPS = 3
GUARD_ATOL = 1e-8
ROLL_ATOL = 1e-12  # the two engines' a: same y, different dot order
REPS = 5


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _time(fn, dev: torch.device):
    """(seconds per call, last result) after one warm-up call."""
    out = fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn()
    synchronize(dev)
    return (time.perf_counter() - t0) / REPS, out


def host_recursion(hs, iz, cols, psi0, steps: int):
    """NumPy complex128 Haydock recursion, the guard and the baseline.

    Returns (a of the first ``steps`` steps, seconds)."""
    kk, nslots = cols.shape
    hi = hs[iz]  # (kk, nslots, 9, 9)
    psi = psi0.copy()
    c = psi.shape[2]
    pmn = np.zeros((kk, 9, c), np.complex128)
    a = np.zeros((steps, c))
    t0 = time.perf_counter()
    for ll in range(steps):
        v = np.zeros((kk, 9, c), np.complex128)
        for m in range(nslots):
            v += np.einsum("iab,ibc->iac", hi[:, m], psi[cols[:, m]])
        a[ll] = np.sum((v * psi[:-1].conj()).real, axis=(0, 1))
        pmn = pmn + v - a[ll][None, None, :] * psi[:-1]
        s = np.sqrt(np.sum(np.abs(pmn) ** 2, axis=(0, 1)))
        psi_new = pmn / s[None, None, :]
        pmn = -psi[:-1] * s[None, None, :]
        psi = np.concatenate([psi_new, np.zeros((1, 9, c), np.complex128)])
    return a, time.perf_counter() - t0


def main(box: int = 30, lld: int = 20, n_start: int = 16,
         device="cuda") -> dict:
    """Run the bench at this shape and print its JSON line; returns it as
    a dict.  Raises if the host guard fails or the two engines' ``a``
    differ by more than ``ROLL_ATOL``."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    sys_ = build_synthetic_bcc(rc=120.0, ndim=1_000_000, lld=lld, box=box,
                               device=dev)
    hb = sys_.ham
    kk, nslots = hb.cols.shape
    hs_np = np.ascontiguousarray(hb.ee[:, :, :9, :9])
    starts = list(range(0, kk, max(1, kk // n_start)))[:n_start]
    c = 9 * len(starts)
    op = HaydockOperator(hs_np, hb.iz, hb.cols).to(dev)
    psi0 = scalar_start_vectors(kk, starts, dev)
    _say(f"{kind}: kk={kk} nslots={nslots} lld={lld} chains={c}")

    dt, (a, _) = _time(lambda: op.coefficients(psi0, lld, roll=False), dev)
    dt_roll, (a_roll, _) = _time(
        lambda: op.coefficients(psi0, lld, roll=True), dev)
    work = kk * nslots * 81 * c * (lld - 1)
    gnnz = work / dt / 1e9
    _say(f"K1' engine: {dt * 1e3:.3f} ms -> {gnnz:.3f} Gnnz/s")
    roll_err = float((a_roll - a).abs().max())
    _say(f"K2' (roll) engine: {dt_roll * 1e3:.3f} ms -> "
         f"{work / dt_roll / 1e9:.3f} Gnnz/s; max |a_roll - a| = "
         f"{roll_err:.3e}")
    if not roll_err <= ROLL_ATOL:
        raise RuntimeError(f"roll engine: |a_roll - a| = {roll_err} > "
                           f"{ROLL_ATOL}")

    steps = min(GUARD_STEPS, lld - 1)
    a_host, t_host = host_recursion(hs_np, np.asarray(hb.iz),
                                    np.asarray(hb.cols),
                                    psi0.cpu().numpy(), steps)
    err = float(np.abs(a[:steps].cpu().numpy() - a_host).max())
    if not err <= GUARD_ATOL:
        raise RuntimeError(f"host guard: |a - a_host| = {err} > "
                           f"{GUARD_ATOL}")
    base = t_host * (lld - 1) / steps
    _say(f"numpy baseline: {base * 1e3:.1f} ms -> "
         f"{work / base / 1e9:.3f} Gnnz/s; guard {err:.3e}")
    line = {
        "metric": "bsr_recursion_spmv_throughput",
        "value": gnnz,
        "unit": "Gnnz/s",
        "vs_baseline": base / dt,
        "ms_per_step": dt / (lld - 1) * 1e3,
        "sustained_tf_s": work * FLOPS_PER_NNZ / dt / 1e12,
        "flops_per_nnz": FLOPS_PER_NNZ,
        "guard_max_abs_err": err,
        "device": kind,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
