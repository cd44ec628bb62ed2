"""Kind ``scf``: one SCF iteration a job, ``SelfConsistency.run(nstep=1)``,
each continuing from the state the last one left.

The comparison: the warm-up job from the seed's state, which the reference
builds from the configuration, and one window job the seed draws, from the
state that job started from (from the second iteration on the SCF is
chaotic at ~1e-14 through the atomic-sphere solver's stops, so a chained
reference would drift).  Numbers: the Hamiltonian, the recursion's
coefficients or moments, the terminators, the Green function, the Fermi
level, the mixed moments, the spin moment, the solver's total energy and the
potential parameters it hands on.
"""

from __future__ import annotations

import torch

from benchmark import checks, jobs
from benchmark.reference.scf import scf_iteration

#: The potential parameters the atomic-sphere step hands on, and the band
#: parameters ``predls`` makes of them for the next Hamiltonian
POTPAR = ("c", "enu", "srdel", "qpar", "ppar", "center_band", "width_band",
          "obar")


class Job:
    """One SCF iteration a job, from the state the last one left.  The
    recursion (``run_<recur>``) and the terminators are wrapped to keep what
    they hand on; the Green function is the iteration's ``last_g0``."""

    def __init__(self, sys_, workdir: str):
        from rslmtoasa_tpu_torch.models import scf as scf_mod
        from rslmtoasa_tpu_torch.models.scf import SelfConsistency

        self.sys = sys_
        self.scf = SelfConsistency(sys_, workdir)
        self.records = []
        self._got = {}
        name = "run_" + sys_.cfg.control.recur
        inner = getattr(sys_, name)

        def recursion(*a, **k):
            self._got["coef"] = out = inner(*a, **k)
            return out

        setattr(sys_, name, recursion)
        self._scf_mod = scf_mod
        self._terminf = scf_mod.get_terminf

        def terminf(a_b, b_b):
            self._got["term"] = out = self._terminf(a_b, b_b)
            return out

        scf_mod.get_terminf = terminf

    def close(self):
        self._scf_mod.get_terminf = self._terminf

    def run(self):
        """One job; keeps the state it started from and what it made."""
        sys_ = self.sys
        before = jobs.read_state(sys_.atoms[0], self.scf.fermi)
        self._got = {}
        self.scf.run(nstep=1)
        hb = sys_.ham
        self.records.append({
            "before": before, "coef": self._got.get("coef"),
            "term": self._got.get("term"),
            "g0": getattr(self.scf, "last_g0", None),
            "blocks": None if hb is None else hb.ee,
            "lsham": None if hb is None else hb.lsham})

    def finish(self):
        """Each record gets the state its job left."""
        for rec, nxt in zip(self.records, self.records[1:]):
            rec["after"] = nxt["before"]
        self.records[-1]["after"] = jobs.read_state(self.sys.atoms[0],
                                                    self.scf.fermi)


def make_job(cell, sys_, workdir: str) -> Job:
    return Job(sys_, workdir)


def roofline(cell, box):
    """(start sites of each chain, K4 launches, Gram or not) of one job."""
    ctl = cell.groups()["control"]
    cheb = ctl["recur"] == "chebyshev"
    return [[(0, 0, 0)]], (ctl["lld"] + 1 if cheb else ctl["lld"] - 1), \
        not cheb


def reference(cell, state: dict, device, cdtype) -> dict:
    return scf_iteration(cell.box(), cell.run_params(), state, device,
                         cdtype)


def record(cell, out: dict, lower: bool = False) -> dict:
    """A reference job's outputs in the program's record layout (the
    control in the program's place); ``lower`` rounds its tables to
    complex64."""
    rec = checks.tables_record(out, lower)
    rec.update(coef=out["coef"], g0=out["g0"],
               after={"potential": out["potential"], "fermi": out["fermi"]})
    return rec


def check(rec: dict, ref: dict, slot_vectors, ref_vectors) -> dict:
    """One SCF iteration: the Hamiltonian, the recursion, the terminators,
    the Green function, and the state the iteration left: the Fermi level,
    the mixed moments ``ql``, the spin moment, the solver's total energy
    and the potential parameters (:data:`POTPAR`)."""
    out = {"ham": checks.hamiltonian(rec["blocks"], rec["lsham"],
                                     slot_vectors, ref["blocks"],
                                     ref["lsham"], ref_vectors)}
    if isinstance(ref["coef"], tuple):
        coef, term = rec["coef"] or (None, None), rec["term"] or (None, None)
        out["coef"] = max(checks.rel(coef[0], ref["coef"][0]),
                          checks.rel(coef[1], ref["coef"][1]))
        out["terminator"] = max(checks.absdiff(term[0], ref["term"][0]),
                                checks.absdiff(term[1], ref["term"][1]))
    else:
        out["coef"] = checks.rel(rec["coef"], ref["coef"])
    out["green"] = checks.rel(rec["g0"], ref["g0"])
    got, want = rec["after"]["potential"], ref["potential"]
    out["fermi"] = abs(rec["after"]["fermi"] - ref["fermi"])
    out["ql"] = checks.absdiff(got["ql"], want["ql"])
    out["moment"] = max(abs(got["mtot"] - want["mtot"]),
                        checks.absdiff(got["mom0"], want["mom0"]))
    out["etot"] = abs(got["etot"] - want["etot"])
    out["potpar"] = max(checks.absdiff(got[k], want[k]) for k in POTPAR)
    return out


def compare(cell, records: list, slots, k: int, device, state0: dict):
    """(readings, the reference's outputs by job): the warm-up job against
    the reference from the seed's state, job ``k`` against the reference
    from the state it started from."""
    vectors = cell.box().vectors
    c128 = torch.complex128
    refs = {"start": reference(cell, state0, device, c128),
            "drawn": reference(cell, records[k]["before"], device, c128)}
    return checks.worst(check(records[0], refs["start"], slots, vectors),
                        check(records[k], refs["drawn"], slots,
                              vectors)), refs

