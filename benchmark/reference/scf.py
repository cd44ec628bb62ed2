"""One SCF iteration of a bcc bulk cluster, from a given state, in plain code.

The steps of the reference code's ``self%run`` (``self.f90`` :676-764) for
``calctype='B'`` with one rec atom: the Hamiltonian's blocks from the
screened structure constants and the potential parameters, the block Lanczos
or Chebyshev recursion on the grid of :mod:`lattice`, the terminators and
the Green function, the Fermi level and moments (``Bands``), linear mixing,
the bulk Madelung shift, the atomic-sphere solve (the Python solver, which
the program replaces by its native one for the LDA functionals), the
potential parameters and ``predls``.  The host steps are the frozen copies in
:mod:`.frozen`; the recursion and the Green function run on ``device`` in
``cdtype`` (complex128, or complex64 for the control).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import lattice
from .frozen.atoms.potential import Element, Potential, SymbolicAtom
from .frozen.geometry.strconst import screened_sbar
from .frozen.physics.atomsphere import atomsc, potpar, racsi
from .frozen.physics.bands import Bands
from .frozen.physics.energy_mesh import EnergyMesh
from .frozen.physics.greens import bgreen, chebyshev_green, get_terminf, zsqr
from .frozen.physics.hamiltonian import build_lsham, ham0m_nc
from .frozen.physics.madelung import MadelungMatrix, bulkpot
from .frozen.physics.mixer import Mixer
from .frozen.physics.radial import mesh_b
from .frozen.geometry.crystal import primitive_cell

ANG2AU = 1.8897259886
NCUT = 9  # the screening cluster reaches sqrt(NCUT * r2) (structb :1878)


def make_atom(state: dict) -> SymbolicAtom:
    """A frozen ``SymbolicAtom`` from ``{"element": {...}, "potential":
    {name: value}}``; unnamed potential fields keep their defaults."""
    el = Element(**state["element"])
    pot = Potential()
    for k, v in state["potential"].items():
        cur = getattr(pot, k)
        setattr(pot, k, np.array(v, dtype=np.asarray(cur).dtype)
                if isinstance(cur, np.ndarray) else type(cur)(v))
    return SymbolicAtom(element=el, potential=pot, label=el.symbol)


class EnergyCfg:
    """The ``&energy`` entries ``EnergyMesh.build`` reads."""

    def __init__(self, channels_ldos, energy_min, energy_max, fermi,
                 fix_fermi=False):
        self.channels_ldos = int(channels_ldos)
        self.energy_min = float(energy_min)
        self.energy_max = float(energy_max)
        self.fermi = float(fermi)
        self.fix_fermi = bool(fix_fermi)


def hamiltonian_blocks(box: lattice.BccBox, pot: Potential, wav: float,
                       r2: float, with_soc: bool):
    """(blocks (1 + nshift, 18, 18), lsham (18, 18)): the onsite block,
    then one per neighbour shift of ``box``, of a bulk of one species."""
    r_big = box.positions_ang(np.sqrt(NCUT * r2))
    sb, svec = screened_sbar(r_big, wav, r2)
    vets = np.concatenate([np.zeros((1, 3)), box.vectors])
    blocks = np.zeros((len(vets), 18, 18), dtype=np.complex128)
    for m, vet in enumerate(vets):
        d2 = ((svec - vet[None, :]) ** 2).sum(axis=1)
        k = int(np.argmin(d2))
        if d2[k] >= 1e-4:
            raise ValueError(f"no structure constant for bond {vet}")
        blocks[m], _ = ham0m_nc(pot, pot, m == 0, sb[k].T)
    at = SymbolicAtom(element=Element(), potential=pot)
    lsham = build_lsham([at])[0] if with_soc else np.zeros((18, 18),
                                                           np.complex128)
    return blocks, lsham


def recursion(box, blocks, lsham, chains, lld, recur, window, device,
              cdtype):
    """The block coefficients (a_b, b2_b) or the Chebyshev moments mu of
    ``chains`` on the grid, as complex128 host arrays."""
    h = torch.as_tensor(blocks.copy(), device=device).to(cdtype)
    h[0] += torch.as_tensor(lsham, device=device).to(cdtype)
    psi0 = lattice.start_blocks(box, chains, 18, cdtype, device)
    if recur == "chebyshev":
        emin, emax = window
        mu = lattice.chebyshev_moments(
            box, h, psi0, lld, (emax - emin) / (2.0 - 0.3),
            (emax + emin) / 2.0)
        return mu.to(torch.complex128).cpu().numpy()
    a_b, b2_b = lattice.block_lanczos(box, h, psi0, lld)
    return (a_b.to(torch.complex128).cpu().numpy(),
            b2_b.to(torch.complex128).cpu().numpy())


def green(coef, recur, ene, window, device, cdtype, sym_term=False):
    """(g0 (R, 18, 18, NE) complex128 on the host, the terminators or
    None)."""
    if recur == "chebyshev":
        g0 = chebyshev_green(coef, ene, window[0], window[1], device, cdtype)
        return g0.to(torch.complex128).cpu().numpy(), None
    a_b, b2_b = coef
    b_b = zsqr(b2_b)
    a_inf, b_inf = get_terminf(a_b, b_b)
    g0 = bgreen(a_b, b_b, a_inf, b_inf, ene, device, sym_term, cdtype)
    return g0.to(torch.complex128).cpu().numpy(), (a_inf, b_inf)


def scf_iteration(box: lattice.BccBox, run: dict, state: dict, device,
                  cdtype=torch.complex128) -> dict:
    """One iteration from ``state`` (``element``, ``potential``, ``fermi``).

    ``run`` holds the entries of the input the iteration reads: ``recur``,
    ``lld``, ``nsp``, ``energy`` (``EnergyCfg``'s keywords), ``beta``,
    ``mixtype``, ``txc``, ``wav``, ``r2``, ``alat``, ``ws_max``,
    ``sym_term``.  Returns every stage's result and the state it leaves."""
    atom = make_atom(state)
    atoms, iz_rec = [atom], [0]
    pot = atom.potential
    out = {}
    pot.build_pot()
    blocks, lsham = hamiltonian_blocks(box, pot, run["wav"], run["r2"],
                                       run["nsp"] in (2, 4))
    out["blocks"], out["lsham"] = blocks, lsham
    ecfg = EnergyCfg(**run["energy"])
    emesh = EnergyMesh.build(ecfg, fermi=state["fermi"])
    window = (emesh.energy_min, emesh.energy_max)
    coef = recursion(box, blocks, lsham, [[((0, 0, 0), 1.0)]], run["lld"],
                     run["recur"], window, device, cdtype)
    out["coef"] = coef
    mix = Mixer(1, beta=run["beta"], mixtype=run["mixtype"])
    mix.save_to("old", atoms, iz_rec)
    mix.mag_old[0] = pot.mom
    g0, term = green(coef, run["recur"], emesh.ene, window, device, cdtype,
                     run.get("sym_term", False))
    out["g0"], out["term"] = g0, term
    bands = Bands(emesh, atoms, iz_rec, float(atom.element.valence),
                  nsp=run["nsp"])
    bands.calculate_fermi(g0, fix_fermi=emesh.fix_fermi, calctype="B")
    bands.calculate_magnetic_moments(g0)
    mix.mag_new[0] = pot.mom
    mag_mix = mix.mix_magnetic_moments(np.array([pot.mtot]))
    pot.mom = mag_mix[0]
    bands.calculate_orbital_moments(g0, None)
    bands.calculate_moments(g0)
    mix.save_to("new", atoms, iz_rec)
    out["fermi"] = emesh.fermi
    mix.mixpq()
    dq = mix.charge_transfer(atoms, iz_rec)
    cell = primitive_cell("bcc")
    amad = MadelungMatrix.bulk(cell.a, cell.crd, run["alat"]).amad
    bulkpot(amad, dq, [0], atoms, iz_rec)
    mix.save_to("current", atoms, iz_rec)
    _atomic_sphere(atom, run, lower=cdtype != torch.complex128)
    out["potential"] = {k: copy.deepcopy(v) for k, v in vars(pot).items()}
    return out


def _f32(x):
    out = np.asarray(x, dtype=np.float32).astype(np.float64)
    return out if out.ndim else float(out)


def _atomic_sphere(at: SymbolicAtom, run: dict, lower: bool = False):
    """``run_scf`` (``self.f90`` :861-912, ``lmtst`` :1135-1186) on the
    Python solver.  ``lower`` (the control) rounds the solver's inputs and
    its results to float32, as a float32 solver would at best hand them
    on."""
    pot = at.potential
    wsm = run["wav"] * ANG2AU
    if lower:
        pot.ql, pot.pl = _f32(pot.ql), _f32(pot.pl)
    res = atomsc(z=at.element.atomic_number, lmax=pot.lmax, a=0.02,
                 ws_r=pot.ws_r, pl=pot.pl, ql=pot.ql,
                 ifcore=at.element.f_core, txc=run["txc"])
    if lower:
        for k in ("etot", "utot", "ekin", "rhoeps", "sumev", "sumec", "v"):
            setattr(res, k, _f32(getattr(res, k)))
    pot.etot, pot.utot, pot.ekin = res.etot, res.utot, res.ekin
    pot.rhoeps, pot.sumev, pot.sumec = res.rhoeps, res.sumev, res.sumec
    qsl = racsi(0.02, mesh_b(pot.ws_r, 0.02, res.nr), res.rofi, res.fun2,
                res.vzt)
    pot.xi_p = np.array([qsl[0], qsl[3]])
    pot.xi_d = np.array([qsl[1], qsl[4]])
    pot.rac = np.array([qsl[2], qsl[5]])
    if pot.ws_r > run["ws_max"]:
        for k in ("c", "srdel", "qpar", "ppar", "enu", "vl"):
            getattr(pot, k)[:] = 0.0
    else:
        pot.pnu = pot.pl.copy()
        o = potpar(at.element.atomic_number, pot.lmax, 0.02, pot.ws_r,
                   pot.pnu, res.v, res.rofi)
        pot.enu, pot.c, pot.srdel = o["enu"], o["c"], o["srdel"]
        pot.qpar = 1.0 / o["qpar"]
        pot.ppar, pot.vl = o["ppar"], o["vl"]
    pot.predls(wsm)
