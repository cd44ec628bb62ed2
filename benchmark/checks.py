"""The arithmetic of the numbers that decide ``correct``, shared by the
kinds of job (``kinds/<kind>.py``, whose ``check`` returns
``{name: reading}``), and the judgement: a run is correct where every
reading is finite and at most its limit (``limits/<workload>.json``).  The
same functions read the control (the reference run a precision lower) in
the program's place.
"""

from __future__ import annotations

import numpy as np


def rel(got, want) -> float:
    if got is None:  # the program did not produce it
        return float("inf")
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def absdiff(got, want) -> float:
    if got is None:
        return float("inf")
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


def hamiltonian(blocks, lsham, slot_vectors, ref_blocks, ref_lsham,
                ref_vectors) -> float:
    """The program's block table ``blocks`` (1, nslots, 18, 18), slot m > 0
    along ``slot_vectors[m - 1]`` (Angstrom), and its spin-orbit table,
    against the reference's blocks along ``ref_vectors``: the largest
    difference over the largest reference entry."""
    if blocks is None:  # the program built no Hamiltonian
        return float("inf")
    order = [0]
    for v in np.asarray(slot_vectors):
        d = np.abs(np.asarray(ref_vectors) - v[None, :]).max(1)
        k = int(np.argmin(d))
        if d[k] > 1e-6:
            return float("inf")
        order.append(k + 1)
    if len(order) != len(ref_blocks):
        return float("inf")
    want = np.concatenate([ref_blocks[order], np.asarray(ref_lsham)[None]])
    got = np.concatenate([np.asarray(blocks)[0],
                          np.asarray(lsham).reshape(1, 18, 18)])
    return rel(got, want)


def tables_record(out: dict, lower: bool = False) -> dict:
    """The Hamiltonian's tables of a reference job in the program's record
    layout; ``lower`` rounds them to complex64, as a complex64 recursion
    would read them."""
    rnd = (lambda x: np.asarray(x).astype(np.complex64).astype(
        np.complex128)) if lower else np.asarray
    return {"blocks": rnd(out["blocks"])[None],
            "lsham": rnd(out["lsham"])[None], "term": out.get("term")}


def worst(*readings: dict) -> dict:
    """The largest reading of each number over several comparisons."""
    out = {}
    for r in readings:
        for k, v in r.items():
            old = out.get(k)
            out[k] = v if old is None or not np.isfinite(v) else (
                old if not np.isfinite(old) else max(old, v))
    return out


def judge(readings: dict, limits: dict):
    """(correct, [(name, reading, limit)]) over the named limits; a number
    without a limit, or a limit without a number, is not correct."""
    rows, ok = [], set(readings) == set(limits)
    for name in sorted(set(readings) | set(limits)):
        v, lim = readings.get(name, float("nan")), limits.get(name)
        good = lim is not None and np.isfinite(v) and v <= lim
        ok = ok and good
        rows.append((name, float(v), None if lim is None else float(lim)))
    return ok, rows
