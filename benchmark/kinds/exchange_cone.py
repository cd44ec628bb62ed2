"""Kind ``exchange_cone``: the kind ``exchange`` (``kinds/exchange.py``: the
job, its record, its numbers and its K4 work, all reused) on a box too large
for that kind's reference, which recurs on the whole grid (at 100^3 sites a
buffer of the 21 chains would hold 109 GB).

The reference here takes the pairs one at a time.  A pair's chains recur on
the smallest sub-box of the grid, centred as the box is (``BccBox``'s own
rule), that holds every site of the box within ``lld - 1`` hops of the
pair's sites: after k applications of H a chain is nonzero only within k
hops of its sites, and block Lanczos applies H ``lld - 1`` times.  Every
site the recursion can reach is then on the sub-box, and every site off it
is zero on the whole box too, so the sub-box's recursion is the whole box's
up to the order of the sums.  The Hamiltonian's screening cluster is the
whole box's.  The pairs' tables are then put together in the order of the
traffic's pairs, as one reference table.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from benchmark.reference import lattice
from benchmark.reference.jij import TWOINDEX, exchange_table

_spec = importlib.util.spec_from_file_location(
    "bench_kind_exchange_base", os.path.join(os.path.dirname(__file__),
                                             "exchange.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
Job, make_job, pair_sites, roofline, record, table, check = (
    base.Job, base.make_job, base.pair_sites, base.roofline, base.record,
    base.table, base.check)


class ConeBox(lattice.BccBox):
    """The sub-box of ``whole`` with ``dims`` sites an axis, centred as the
    box is; the screening cluster of its Hamiltonian is the whole box's."""

    def __init__(self, whole: lattice.BccBox, dims):
        self.__dict__.update(whole.__dict__)
        self.whole = whole
        self.dims = tuple(int(n) for n in dims)
        self.lc = np.array([(n + 1) // 2 for n in self.dims])

    def positions_ang(self, radius: float) -> np.ndarray:
        return self.whole.positions_ang(radius)


def cone_box(box: lattice.BccBox, sites, hops: int) -> ConeBox:
    """The smallest sub-box of ``box``, centred as it is, that holds every
    site within ``hops`` hops of ``sites`` (primitive coordinates)."""
    mask = np.zeros(box.dims, dtype=bool)
    for m in sites:
        mask[box.index(m)] = True
    for _ in range(hops):
        grown = mask.copy()
        for s in box.shifts:
            dst, src = box._slices(s)
            grown[dst] |= mask[src]
        mask = grown
    dims = []
    for k, g in enumerate(np.nonzero(mask)):
        lo, hi = g.min() + 1 - box.lc[k], g.max() + 1 - box.lc[k]
        n = box.dims[k]
        dims.append(next(s for s in range(1, n + 1)
                         if 1 - (s + 1) // 2 <= lo and s - (s + 1) // 2 >= hi))
    return ConeBox(box, dims)


def joined(parts: list) -> dict:
    """The reference tables of single pairs as one table of all of them."""
    out = {"blocks": parts[0]["blocks"], "lsham": parts[0]["lsham"]}
    # chains: the coefficients' second axis, the terminators' first
    out["coef"] = tuple(np.concatenate([p["coef"][i] for p in parts], 1)
                        for i in (0, 1))
    out["term"] = tuple(np.concatenate([p["term"][i] for p in parts])
                        for i in (0, 1))
    for key in ("gij", "jij", "dmi", "aij"):
        out[key] = np.concatenate([p[key] for p in parts])
    out["twoindex"] = {k: np.concatenate([p["twoindex"][k] for p in parts])
                       for k in TWOINDEX}
    return out


def reference(cell, state: dict, device, cdtype) -> dict:
    box = cell.box()
    hops = cell.groups()["control"]["lld"] - 1
    return joined([exchange_table(cone_box(box, pair, hops),
                                  cell.run_params(), state, [pair], device,
                                  cdtype)
                   for pair in pair_sites(cell, box)])


def compare(cell, records: list, slots, k: int, device, state0: dict):
    """(readings, the reference's outputs): the last table in full and
    table ``k``'s values against the reference from the seed's state."""
    refs = {"start": reference(cell, state0, device, torch.complex128)}
    out = check(records[-1], refs["start"], slots, cell.box().vectors)
    out["jij"] = max(out["jij"], table(records[k], refs["start"]))
    return out, refs
