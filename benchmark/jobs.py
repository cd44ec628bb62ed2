"""How a cell's system is made: one general generator for every kind of
job.

A configuration file (``configs/<config>.json``) gives the namelist
entries, the species and how the seed perturbs it; a traffic file
(``traffic/<mix>.json``) gives the kind of job (``"job"``, the name of a
file ``kinds/<kind>.py``) and the entries it sets over the configuration's.
Both are data; a new cell of an existing kind adds files and touches no
code, and a new kind adds its own file.

The system goes through the port's normal entry: the namelist and the
element file are written into the job's directory, then
``JobConfig.from_namelists`` and ``BulkSystem.build``.
"""

from __future__ import annotations

import copy
import os

import numpy as np

#: Potential fields a job's state is read from
STATE_FIELDS = (
    "lmax", "center_band", "width_band", "shifted_band", "obar",
    "gravity_center", "ql", "pl", "c", "enu", "ppar", "qpar", "srdel", "vl",
    "pnu", "qi", "dele", "ws_r", "sumec", "sumev", "etot", "utot", "ekin",
    "rhoeps", "vmad", "mom", "lmom", "mom0", "mom1", "mtot", "xi_p", "xi_d",
    "rac", "cshi", "dw_l")


# ----------------------------------------------------------------------
# namelists
def _value(v) -> str:
    if isinstance(v, bool):
        return ".true." if v else ".false."
    if isinstance(v, str):
        return "'" + v + "'"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


def namelist_text(groups: dict) -> str:
    """``&group key = value, ... /`` blocks; arrays in Fortran order."""
    out = []
    for name, entries in groups.items():
        out.append(f"&{name}")
        for key, val in entries.items():
            if isinstance(val, (list, tuple, np.ndarray)):
                flat = np.asarray(val).ravel(order="F")
                out.append(f" {key} = " + ", ".join(
                    _value(x.item()) for x in flat))
            else:
                out.append(f" {key} = {_value(val)}")
        out.append("/")
    return "\n".join(out) + "\n"


def merged(base: dict, over: dict) -> dict:
    """Namelist groups of ``base`` with the entries of ``over`` set over
    them."""
    out = copy.deepcopy(base)
    for g, entries in over.items():
        out.setdefault(g, {}).update(copy.deepcopy(entries))
    return out


# ----------------------------------------------------------------------
# the seed's species
def seeded_state(config: dict, seed: int) -> dict:
    """``{"element", "potential", "fermi"}`` of the configuration's species
    with the seed's perturbation: band centres moved by up to
    ``center_band`` Ry (``c`` and ``enu`` with them, so that ``predls``
    maps them onto themselves), widths scaled by up to ``width_band`` (and
    ``srdel`` with them), and ``moment`` d electrons moved from the
    majority to the minority spin."""
    rng = np.random.default_rng(int(seed))
    atom = config["atom"]
    pert = config["seed_perturbation"]
    par = {k: np.array(v, dtype=np.float64) if isinstance(v, list) else v
           for k, v in atom["par"].items()}
    par["ql"] = par["ql"].reshape(3, 3, 2)
    centre = par["center_band"] + rng.uniform(
        -pert["center_band"], pert["center_band"], (3, 2))
    width = par["width_band"] * (1.0 + rng.uniform(
        -pert["width_band"], pert["width_band"], (3, 2)))
    dq = rng.uniform(-pert["moment"], pert["moment"])
    par["center_band"], par["c"], par["enu"] = centre, centre.copy(), \
        centre.copy()
    par["width_band"], par["srdel"] = width, width.copy()
    par["ql"][0, 2, 0] -= dq
    par["ql"][0, 2, 1] += dq
    fermi = float(config["namelists"]["energy"]["fermi"])
    return {"element": dict(atom["element"]), "potential": par,
            "fermi": fermi}


def element_file(state: dict) -> str:
    el = dict(state["element"])
    par = {k: v for k, v in state["potential"].items()}
    return namelist_text({"element": el, "par": par})


def namelists(config: dict, traffic: dict) -> dict:
    """The input's namelist groups: the configuration's, the box's size,
    then the traffic's entries."""
    groups = merged(config["namelists"], {"lattice": {
        "n1": config["n1"], "n2": config["n2"], "n3": config["n3"]}})
    return merged(groups, traffic.get("namelists", {}))


# ----------------------------------------------------------------------
def build_system(config: dict, traffic: dict, state: dict, workdir: str,
                 device):
    """The port's system of this cell, built through its normal entry."""
    from rslmtoasa_tpu_torch.config import JobConfig
    from rslmtoasa_tpu_torch.models.bulk import BulkSystem
    from rslmtoasa_tpu_torch.utils.namelist import read_namelists

    groups = namelists(config, traffic)
    label = state["element"]["symbol"]
    groups["atoms"] = {"database": workdir, "label": [label]}
    path = os.path.join(workdir, "input.nml")
    with open(path, "w") as fh:
        fh.write(namelist_text(groups))
    with open(os.path.join(workdir, f"{label}.nml"), "w") as fh:
        fh.write(element_file(state))
    cfg = JobConfig.from_namelists(read_namelists(path), fname=path)
    return BulkSystem.build(cfg, workdir, device=device)


def read_state(atom, fermi: float) -> dict:
    """The state of the program's species ``atom``: its element, the
    potential's fields, and the Fermi level."""
    el = atom.element
    return {"element": {k: getattr(el, k) for k in (
        "symbol", "atomic_number", "core", "valence", "f_core",
        "num_quant_s", "num_quant_p", "num_quant_d")},
        "potential": {k: copy.deepcopy(getattr(atom.potential, k))
                      for k in STATE_FIELDS},
        "fermi": float(fermi)}
