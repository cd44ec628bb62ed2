"""Kind ``exchange``: one exchange table a job, always from the seed's
potential: the atoms' potentials restored, then
``ExchangeCalculation(...).run()`` and ``calculate_exchange_twoindex()`` as
``cli.run_exchange`` calls them, the pairs (the traffic's ``pairs``) given
as vectors from atom 1.

The comparison: the last table in full and the values of one table the seed
draws, against one reference table from the seed's potential.  Numbers: the
Hamiltonian, the pair chains' coefficients, their terminators, the intersite
Green functions, Jij / DMI / the anisotropic tensor (mRy) and the two-index
files as written (seven digits, mRy).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from benchmark import checks
from benchmark.reference.frozen.physics.greens import zsqr
from benchmark.reference.jij import TWOINDEX, exchange_table, pair_chains


class Job:
    """One exchange table a job, always from the seed's potential."""

    def __init__(self, sys_, workdir: str, pairs):
        self.sys = sys_
        self.workdir = workdir
        cl = sys_.cluster
        cr = np.asarray(cl.cr, dtype=np.float64)
        if np.abs(cr[0]).max() > 1e-9:
            raise ValueError("atom 1 of the cluster is not at the origin")
        js = []
        for v in pairs:
            hit = np.nonzero(np.abs(cr - np.asarray(v)).max(1) < 1e-6)[0]
            if hit.size != 1:
                raise ValueError(f"no single atom at {v} from atom 1")
            js.append(int(hit[0]) + 1)
        lat = sys_.cfg.lattice
        lat.njij = len(js)
        lat.ijpair = np.array([[1, j] for j in js], dtype=np.int64)
        self.pristine = [copy.deepcopy(at.potential) for at in sys_.atoms]
        self.records = []
        self.last = None

    def close(self):
        pass

    def run(self):
        from rslmtoasa_tpu_torch.models.exchange import ExchangeCalculation

        for at, pot in zip(self.sys.atoms, self.pristine):
            at.potential = copy.deepcopy(pot)
        self.last = None  # let the last table's tensors go first
        xc = ExchangeCalculation(self.sys, self.sys.cfg.lattice.ijpair,
                                 self.workdir)
        results = xc.run()
        xc.calculate_exchange_twoindex()
        self.last = xc
        self.records.append({"jij": np.array([r["jij"] for r in results]),
                             "dmi": np.array([r["dmi"] for r in results]),
                             "aij": np.array([r["aij"] for r in results])})

    def finish(self):
        xc = self.last
        rec = self.records[-1]
        rec["blocks"], rec["lsham"] = self.sys.ham.ee, self.sys.ham.lsham
        rec["coef_full"] = (xc.a_b, xc.b_b)
        rec["chains"] = np.asarray(xc.chains)
        rec["term"] = (xc.a_inf, xc.b_inf)
        rec["gij"] = xc.gij_full.permute(0, 3, 1, 2).cpu().numpy()
        rec["twoindex"] = read_twoindex(self.workdir)


def read_twoindex(workdir: str) -> dict:
    """The value columns of the two-index files, per pair."""
    out = {}
    for name in TWOINDEX:
        rows = []
        with open(os.path.join(workdir, name + ".out")) as fh:
            for line in fh:
                f = line.split()
                if f:
                    rows.append([float(x) for x in f[5:-1]])
        out[name] = np.array(rows)
    return out


def pair_sites(cell, box) -> list:
    return [((0, 0, 0), tuple(box.site_of(v)))
            for v in cell.traffic["pairs"]]


def make_job(cell, sys_, workdir: str) -> Job:
    return Job(sys_, workdir, cell.traffic["pairs"])


def roofline(cell, box):
    """(start sites of each chain, K4 launches, Gram or not) of one job."""
    chains, _ = pair_chains(pair_sites(cell, box))
    lld = cell.groups()["control"]["lld"]
    return [[m for m, _ in chain] for chain in chains], lld - 1, True


def reference(cell, state: dict, device, cdtype) -> dict:
    box = cell.box()
    return exchange_table(box, cell.run_params(), state,
                          pair_sites(cell, box), device, cdtype)


def record(cell, out: dict, lower: bool = False) -> dict:
    """A reference table in the program's record layout (the control in
    the program's place); ``lower`` rounds its tables to complex64."""
    rec = checks.tables_record(out, lower)
    a_b, b2_b = out["coef"]
    rec.update(coef_full=(a_b, zsqr(b2_b)), chains=np.arange(a_b.shape[1]),
               gij=out["gij"], twoindex=out["twoindex"], jij=out["jij"],
               dmi=out["dmi"], aij=out["aij"])
    return rec


def table(rec: dict, ref: dict) -> float:
    """Jij, DMI and the anisotropic tensor of one table (mRy)."""
    return max(checks.absdiff(rec[k], ref[k]) for k in ("jij", "dmi", "aij"))


def check(rec: dict, ref: dict, slot_vectors, ref_vectors) -> dict:
    """One whole table: the Hamiltonian, the pair chains' coefficients,
    their terminators, the intersite Green functions, Jij / DMI / the
    anisotropic tensor and the two-index files."""
    live = rec["chains"]
    a_b, b_b = rec["coef_full"]
    out = {"ham": checks.hamiltonian(rec["blocks"], rec["lsham"],
                                     slot_vectors, ref["blocks"],
                                     ref["lsham"], ref_vectors)}
    out["coef"] = max(checks.rel(a_b[:, live], ref["coef"][0]),
                      checks.rel(b_b[:, live], zsqr(ref["coef"][1])))
    out["terminator"] = max(checks.absdiff(rec["term"][0], ref["term"][0]),
                            checks.absdiff(rec["term"][1], ref["term"][1]))
    out["green"] = checks.rel(rec["gij"], ref["gij"])
    out["jij"] = table(rec, ref)
    out["twoindex"] = max(checks.absdiff(rec["twoindex"][k],
                                         ref["twoindex"][k])
                          for k in ref["twoindex"])
    return out


def compare(cell, records: list, slots, k: int, device, state0: dict):
    """(readings, the reference's outputs): the last table in full and
    table ``k``'s values against the reference from the seed's state."""
    refs = {"start": reference(cell, state0, device, torch.complex128)}
    out = check(records[-1], refs["start"], slots, cell.box().vectors)
    out["jij"] = max(out["jij"], table(records[k], refs["start"]))
    return out, refs
