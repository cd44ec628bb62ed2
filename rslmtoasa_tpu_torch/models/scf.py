"""Self-consistent field driver (reference ``source/self.f90 run`` :676-764).

Per iteration: recursion (device) -> LDOS/Green -> Fermi -> moments ->
mixing -> Madelung -> atomic-sphere SCF (host) -> orthogonal->TB transform
-> convergence check.  Produces the reference's observable outputs:
``totaldos.out`` rows and ``<El>_out.nml`` checkpoints.

The port runs the bulk (``calctype='B'``), surface (``'S'``) and impurity
(``'I'``) branches: the bulk with each of its recursions (``recur``
``'lanczos'``, ``'block'``, ``'chebyshev'``), the surface and the impurity
with the block and Chebyshev ones.  The atomic spheres run on the native
solver for the LDA functionals, and on the Python one
(:mod:`..physics.atomsphere`) for the gradient functionals (``txc`` 5, 8,
9) and ``hyperfine``, as the JAX package routes them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.block_lanczos import zsqr
from ..ops.chebyshev import chebyshev_green
from ..ops.lanczos import roll_selected
from ..physics.atomsphere import atomsc, potpar, racsi
from ..physics.bands import Bands
from ..physics.energy_mesh import EnergyMesh
from ..physics.greens import bgreen, get_terminf
from ..physics.madelung import MadelungMatrix, bulkpot, impmad, imppot
from ..physics.madelung_surf import SurfaceMadelung, build_alelay, surfpot
from ..physics.mixer import Mixer
from ..physics.radial import mesh_b
from ..utils.logger import g_logger
from ..utils.namelist import write_namelist
from ..utils.timer import g_timer
from .bulk import BulkSystem, refuse_scalar_embedded

ANG2AU = 1.8897259886
RY2TESLA = 2.35051754997e5


@dataclass
class SCFState:
    converged: bool = False
    niter: int = 0
    delta: float = 0.0


def update_fermi_in_input(fermi: float, filename: str):
    """Rewrite the ``fermi =`` line of the &energy group in the input
    file, preserving trailing comments (``self.f90
    update_fermi_in_input`` :1042-1123).  No-op when the file is absent
    or not writable (the mode bits are checked too: running as root,
    os.access(W_OK) lies about permission-protected files)."""
    if not filename or not os.path.exists(filename) \
            or not os.access(filename, os.W_OK):
        return
    if not (os.stat(os.path.realpath(filename)).st_mode & 0o200):
        return
    with open(filename) as fh:
        lines = fh.readlines()
    in_energy = False
    done = False
    out = []
    for line in lines:
        stripped = line.strip()
        if stripped == "&energy":
            in_energy = True
        elif stripped == "/":
            in_energy = False
        elif in_energy and not done and stripped.startswith("fermi"):
            eq = line.find("=")
            if eq >= 0:
                rest = line[eq + 1:]
                com = rest.find("!")
                comment = rest[com:] if com >= 0 else "\n"
                line = line[:eq + 1] + f" {fermi:.6f} " + comment
                if not line.endswith("\n"):
                    line += "\n"
                done = True
        out.append(line)
    # every rank of a run rewrites the file: replace it whole, so that no
    # rank reads it truncated by another and writes that back
    path = os.path.realpath(filename)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path))
    with os.fdopen(fd, "w") as fh:
        fh.writelines(out)
    shutil.copymode(path, tmp)
    os.replace(tmp, path)


def magnetic_torques(atoms, iz_rec) -> np.ndarray:
    """Effective field I_loc per rec atom in Tesla
    (``calculate_magnetic_torques``; mom0/mom1 must be current)."""
    out = np.zeros((3, len(iz_rec)))
    for na, isp in enumerate(iz_rec):
        p = atoms[isp].potential
        d, up, dw = 2, 0, 1
        pref_0 = (p.c[d, up] * p.srdel[d, dw] / p.srdel[d, up]
                  - p.c[d, dw] * p.srdel[d, up] / p.srdel[d, dw])
        pref_1 = (p.srdel[d, dw] / p.srdel[d, up]
                  - p.srdel[d, up] / p.srdel[d, dw])
        i_loc = pref_0 * p.mom0 - pref_1 * p.mom1
        out[:, na] = i_loc * RY2TESLA
    return out


class SelfConsistency:
    def __init__(self, sys: BulkSystem, workdir: str = "."):
        self.sys = sys
        self.cfg = sys.cfg
        calctype = self.cfg.control.calctype
        if calctype not in ("B", "S", "I"):
            raise NotImplementedError(f"calctype={calctype!r}")
        if self.cfg.control.recur not in ("block", "chebyshev"):
            refuse_scalar_embedded(calctype)
        self.workdir = workdir
        cl = sys.cluster
        # recursion atoms -> species index (0-based)
        self.iz_rec = [int(cl.iz[int(j) - 1]) - 1 for j in cl.irec]
        self.nrec = cl.nrec
        self.mix = Mixer(self.nrec, beta=self.cfg.mix.beta,
                         mixtype=self.cfg.mix.mixtype)
        # valence from the bulk species (calculate_fermi :252-253)
        qqv = sum(sys.atoms[t].element.valence
                  for t in range(cl.cell.ntot))
        self.qqv = float(qqv)
        self.madelung = self.amad_imp = self.smad = None
        if calctype == "B":
            with g_timer.section("madelung-matrix"):
                self.madelung = MadelungMatrix.bulk(
                    cl.cell.a, cl.cell.crd, cl.alat
                )
        elif calctype == "I":
            with g_timer.section("madelung-surface"):
                self.amad_imp = impmad(cl.cr, cl.alat, cl.wav, cl.nbas)
        else:
            with g_timer.section("madelung-surface"):
                bs, q3 = build_alelay(cl.cr, cl.num, cl.miller)
                self.smad = SurfaceMadelung(bs, q3, cl.nbas, cl.alat, cl.wav)
        self.fermi = self.cfg.energy.fermi
        self.state = SCFState()

    # ------------------------------------------------------------------
    def g0_from_ldos(self, tdens: np.ndarray) -> np.ndarray:
        """Collinear scalar path: diagonal g0 = -i pi * LDOS
        (``green%sgreen`` :628-707, nmdir=1 branch).

        tdens: (nrec, 18, NE) -> g0 (nrec, 18, 18, NE) complex.
        """
        nrec, _, ne = tdens.shape
        g0 = np.zeros((nrec, 18, 18, ne), dtype=np.complex128)
        idx = np.arange(18)
        g0[:, idx, idx, :] = -1j * np.pi * tdens
        return g0

    # ------------------------------------------------------------------
    def run(self, nstep: Optional[int] = None) -> SCFState:
        cfg = self.cfg
        sys = self.sys
        nstep = cfg.scf.nstep if nstep is None else nstep
        recur = cfg.control.recur
        g_logger.info(f"{recur} recursion on {sys.device}: "
                      f"{self.engine()}")
        for it in range(1, nstep + 1):
            g_logger.info(f"SCF iteration {it}/{nstep}")
            with g_timer.section("scf-iteration"):
                self._iteration()
            self.state.delta = self.mix.delta
            self.state.niter = it
            if self.mix.delta < cfg.scf.conv_thr:
                g_logger.info(f"Converged! delta={self.mix.delta:.3e}")
                self.state.converged = True
                break
            g_logger.info(f"Not converged, delta={self.mix.delta:.6e}")
        return self.state

    # ------------------------------------------------------------------
    def _iteration(self):
        """One SCF iteration.  Its spans are siblings: ``bands`` (the Fermi
        search, the moments, the mixing and the electrostatics) opens again
        after ``scf-output`` writes the densities of states between the
        Fermi search and the moments."""
        cfg = self.cfg
        sys = self.sys
        recur = cfg.control.recur
        with g_timer.section("recursion-phase"):
            sys.build_hamiltonian()
            if recur == "block":
                a_b, b2_b = sys.run_block()
            elif recur == "chebyshev":
                # the moments depend on the energy window scaling only
                emesh_ch = EnergyMesh.build(cfg.energy, fermi=self.fermi)
                mu = sys.run_chebyshev(emesh_ch)
            else:
                a, b2 = sys.run_lanczos()
        self.mix.save_to("old", sys.atoms, self.iz_rec)
        for ia, isp in enumerate(self.iz_rec):
            self.mix.mag_old[ia] = sys.atoms[isp].potential.mom

        # ---------------- run_dos -----------------------------------
        with g_timer.section("dos-phase"):
            emesh = EnergyMesh.build(cfg.energy, fermi=self.fermi)
            sys.emesh = emesh
            if recur == "block":
                with g_timer.section("terminators"):
                    b_b = zsqr(b2_b)  # host
                    # the fits on the recursion's device (the plain
                    # engine's on the host)
                    on = "cpu" if sys.plain else sys.device
                    a_inf, b_inf = get_terminf(
                        torch.as_tensor(a_b, device=on),
                        torch.as_tensor(b_b, device=on))
                with g_timer.section("green-function"):
                    g0 = bgreen(a_b, b_b, a_inf, b_inf, emesh.ene,
                                sys.device, sym_term=cfg.control.sym_term)
            elif recur == "chebyshev":
                with g_timer.section("green-function"):
                    g0 = chebyshev_green(mu, emesh.ene, emesh.energy_min,
                                         emesh.energy_max, sys.device)
            else:
                tdens = sys.ldos(a, b2)
                g0 = self.g0_from_ldos(tdens)
            with g_timer.section("bands"):
                bands = Bands(emesh, sys.atoms, self.iz_rec, self.qqv,
                              nsp=cfg.control.nsp)
                # totaldos.out is written with the pre-search Fermi level
                # (reference calculate_fermi :279-289 writes before the
                # bisection)
                fermi_for_output = emesh.fermi
                bands.calculate_fermi(
                    g0, fix_fermi=emesh.fix_fermi,
                    calctype=cfg.control.calctype,
                )
            with g_timer.section("scf-output"):
                self._write_totaldos(bands, emesh, fermi_for_output)
            with g_timer.section("bands"):
                bands.calculate_magnetic_moments(g0)
                for ia, isp in enumerate(self.iz_rec):
                    self.mix.mag_new[ia] = sys.atoms[isp].potential.mom
                mtot = np.array(
                    [sys.atoms[isp].potential.mtot for isp in self.iz_rec]
                )
                mag_mix = self.mix.mix_magnetic_moments(mtot)
                for ia, isp in enumerate(self.iz_rec):
                    sys.atoms[isp].potential.mom = mag_mix[ia]
                # orbital moments run at the top of calculate_moments
                # (bands.f90 :435)
                bands.calculate_orbital_moments(g0, self.workdir)
                bands.calculate_moments(g0)
                self.bands = bands
                self.last_g0 = g0
                self.mix.save_to("new", sys.atoms, self.iz_rec)
                self.fermi = emesh.fermi

        # ---------------- mixing + electrostatics -------------------
        with g_timer.section("bands"):
            self.mix.mixpq()
            dq = self.mix.charge_transfer(sys.atoms, self.iz_rec)
            self.electrostatics(dq)
            self.mix.save_to("current", sys.atoms, self.iz_rec)

        # ---------------- atomic spheres ----------------------------
        with g_timer.section("atomic-scf"):
            self.run_scf()

        with g_timer.section("scf-output"):
            # rewrite fermi in the input file (self.f90 :748; skipped
            # for read-only inputs)
            update_fermi_in_input(self.fermi, cfg.control.fname)
            self.save_checkpoints()

    # ------------------------------------------------------------------
    def electrostatics(self, dq: np.ndarray):
        """The Madelung shifts of the rec atoms' potentials from their
        charge transfers ``dq``: ``bulkpot``, ``imppot`` with the bulk
        host's charge transfers (``get_charge_transf`` :402-416), or
        ``surfpot`` with ``&charge vmix``."""
        sys, cl = self.sys, self.sys.cluster
        if self.madelung is not None:
            iz_bas = [int(z) - 1 for z in cl.cell.izp]
            bulkpot(self.madelung.amad, dq, iz_bas, sys.atoms, self.iz_rec)
        elif self.amad_imp is not None:
            bulk_charge = np.array([
                sys.atoms[t].potential.ql[0].sum()
                - sys.atoms[t].element.valence for t in range(cl.nbulk)])
            imppot(self.amad_imp, dq, bulk_charge, cl.chargetrf_type,
                   sys.atoms, self.iz_rec, cl.nbulk)
        else:
            vmix = 1.0
            ch = self.cfg.namelists.get("charge")
            if ch is not None and ch.has("vmix"):
                vmix = float(ch.get_scalar("vmix"))
            surfpot(self.smad, dq, cl.natoms_layer, int(self.cfg.lattice.nlay),
                    sys.atoms, self.iz_rec, cl.nbulk, vmix=vmix,
                    logger=g_logger)

    # ------------------------------------------------------------------
    def engine(self) -> str:
        """What the recursion runs through, for the log."""
        if self.sys.plain:
            return "the kernels' plain versions"
        if self.cfg.control.recur in ("block", "chebyshev"):
            return ("K4 block_step, two launches per H psi (HoH)"
                    if self.cfg.hamiltonian.hoh
                    else "K4 block_step, one launch per H psi")
        spmv = ("K2' spmv_dot_pipelined" if roll_selected()
                else "K1' spmv_dot")
        return f"{spmv} + K3' update_norm"

    # ------------------------------------------------------------------
    def run_scf(self):
        """Per-atom atomic-sphere SCF + potential parameters + predls
        (``run_scf`` :861-912 and ``lmtst`` :1135-1186): on the native
        solver for the LDA functionals, on the Python one for the gradient
        functionals and ``hyperfine``."""
        from .. import native

        cfg = self.cfg
        wsm = self.sys.cluster.wav * ANG2AU
        # the C++ solver implements the LDA functionals only and no
        # hyperfine accumulation; those paths run the Python solver
        use_native = (cfg.control.txc not in (5, 8, 9)
                      and not cfg.control.hyperfine)
        for ia, isp in enumerate(self.iz_rec):
            at = self.sys.atoms[isp]
            pot = at.potential
            solver = native.atomsc_native if use_native else atomsc
            kwargs = {} if use_native else dict(
                hyperfine=bool(cfg.control.hyperfine))
            res = solver(
                z=at.element.atomic_number,
                lmax=pot.lmax,
                a=0.02,
                ws_r=pot.ws_r,
                pl=pot.pl,
                ql=pot.ql,
                ifcore=at.element.f_core,
                txc=cfg.control.txc,
                **kwargs,
            )
            if getattr(res, "hyper_field", None) is not None:
                pot.hyper_field = res.hyper_field
                g_logger.info(
                    f"Hyperfine field for atom {ia + 1}: H_core="
                    f"{res.hyper_field[0]:8.3f} T, H_val="
                    f"{res.hyper_field[1]:8.3f} T.")
            pot.etot = res.etot
            pot.utot = res.utot
            pot.ekin = res.ekin
            pot.rhoeps = res.rhoeps
            pot.sumev = res.sumev
            pot.sumec = res.sumec
            racsi_fn = native.racsi_native if use_native else racsi
            qsl = racsi_fn(0.02, mesh_b(pot.ws_r, 0.02, res.nr),
                           res.rofi, res.fun2, res.vzt)
            pot.xi_p = np.array([qsl[0], qsl[3]])
            pot.xi_d = np.array([qsl[1], qsl[4]])
            pot.rac = np.array([qsl[2], qsl[5]])
            if pot.ws_r > cfg.scf.ws_max:
                for k in ("c", "srdel", "qpar", "ppar", "enu", "vl"):
                    getattr(pot, k)[:] = 0.0
            else:
                pot.pnu = pot.pl.copy()
                potpar_fn = native.potpar_native if use_native else potpar
                out = potpar_fn(at.element.atomic_number, pot.lmax, 0.02,
                                pot.ws_r, pot.pnu, res.v, res.rofi)
                pot.enu = out["enu"]
                pot.c = out["c"]
                pot.srdel = out["srdel"]
                pot.qpar = 1.0 / out["qpar"]
                pot.ppar = out["ppar"]
                pot.vl = out["vl"]
            at.potential.predls(wsm)

    # ------------------------------------------------------------------
    def report(self):
        """Write ``report.out`` (reference ``self%report`` :913-1032):
        total/band energies, spin and orbital moments, magnetic forces,
        occupations, charge transfers, Fermi energy, hyperfine."""
        sys = self.sys
        cfg = self.cfg
        bands = getattr(self, "bands", None)
        path = os.path.join(self.workdir, "report.out")
        bar = "=" * 75
        with open(path, "w") as fh:
            def sec(title):
                fh.write(bar + "\n|" + title.center(73) + "|\n" + bar + "\n")

            sec("Total Energy")
            fh.write("Total energy of system: "
                     f"{sum(at.potential.etot for at in sys.atoms):20.10f}\n")
            if bands is not None:
                sec("Band Energy")
                fh.write("Band energy of system: "
                         f"{bands.calculate_band_energy():16.10f}\n")
            sec("Spin moment")
            mom0 = np.array([sys.atoms[isp].potential.mom0
                             for isp in self.iz_rec])
            fh.write("Total spin moment: " + "".join(
                f"{v:16.10f}" for v in mom0.sum(axis=0)) + "\n")
            mag_for = -magnetic_torques(sys.atoms, self.iz_rec)
            for ia in range(len(self.iz_rec)):
                fh.write(f"Spin moment of atom{ia + 1:4d}:"
                         f"{np.linalg.norm(mom0[ia]):10.6f}\n")
                fh.write(f"Spin moment projections of atom{ia + 1:4d}:"
                         + "".join(f"{v:10.6f}" for v in mom0[ia]) + "\n")
                fh.write(f"Magnetic force on atom{ia + 1:4d}:"
                         + "".join(f"{v:16.6f}"
                                   for v in mag_for[:, ia]) + "\n")
            sec("Orbital moment")
            lmom = np.array([sys.atoms[isp].potential.lmom
                             for isp in self.iz_rec])
            fh.write("Total orbital moment: " + "".join(
                f"{v:16.10f}" for v in lmom.sum(axis=0)) + "\n")
            for ia in range(len(self.iz_rec)):
                fh.write(f"Orbital moment of atom{ia + 1:4d}:"
                         f"{np.linalg.norm(lmom[ia]):10.6f}\n")
                fh.write(f"Orbital moment projections of atom{ia + 1:4d}:"
                         + "".join(f"{v:10.6f}" for v in lmom[ia]) + "\n")
            sec("Charge Transfer")
            for ia, isp in enumerate(self.iz_rec):
                pot = sys.atoms[isp].potential
                occ = pot.ql[0]
                fh.write(f"Occupation at atom{ia + 1:4d}:"
                         f"{occ.sum():10.6f}\n")
                fh.write(f"Up orbital occupation at atom{ia + 1:4d}:"
                         + "".join(f"{v:10.6f}" for v in occ[:, 0]) + "\n")
                fh.write(f"Down orbital occupation at atom{ia + 1:4d}:"
                         + "".join(f"{v:10.6f}" for v in occ[:, 1]) + "\n")
                dq = occ.sum() - sys.atoms[isp].element.valence
                fh.write(f"Charge transfer at atom{ia + 1:4d}:"
                         f"{dq:10.6f}\n")
            sec("Fermi Energy")
            fh.write(f"Fermi energy: {self.fermi:10.6f}\n")
            if cfg.control.hyperfine:
                sec("Hyperfine field")
                for ia, isp in enumerate(self.iz_rec):
                    h = sys.atoms[isp].potential.hyper_field
                    fh.write(f"Hyperfine field of atom{ia + 1:4d}:"
                             f"{h.sum():10.3f} T (core {h[0]:8.3f},"
                             f" valence {h[1]:8.3f})\n")
        g_logger.info("Calculation finished. Report printed in report.out")

    # ------------------------------------------------------------------
    def _write_totaldos(self, bands: Bands, emesh: EnergyMesh,
                        fermi: float):
        """totaldos.out plus the per-atom LDOS files <El>_dos.out and
        <El>_orbital_dos.out (calculate_fermi :279-324), all with the
        pre-search Fermi level."""
        path = os.path.join(self.workdir, "totaldos.out")
        with open(path, "w") as fh:
            for i in range(emesh.npts):
                fh.write(f"{emesh.ene[i] - fermi:16.5f}"
                         f"{bands.dtot[i]:16.5f}\n")
        for ia, isp in enumerate(self.iz_rec):
            sym = self.sys.atoms[isp].element.symbol
            with open(os.path.join(self.workdir, sym + "_dos.out"),
                      "w") as fh:
                for i in range(emesh.npts):
                    fh.write(f"{emesh.ene[i] - fermi:16.5f}"
                             f"{bands.dosia[ia, i]:16.5f}\n")
            with open(os.path.join(self.workdir,
                                   sym + "_orbital_dos.out"), "w") as fh:
                for i in range(emesh.npts):
                    fh.write(f"{emesh.ene[i] - fermi:16.5f}" + "".join(
                        f"{bands.dosial[ia, l, i]:16.5f}"
                        for l in range(18)) + "\n")

    # ------------------------------------------------------------------
    def save_checkpoints(self):
        """Write ``<El>_out.nml`` checkpoints for every species
        (``save_state_scf`` writes all symbolic atoms)."""
        for at in self.sys.atoms:
            pot = at.potential
            el = at.element
            out = write_namelist("element", {
                "f_core": el.f_core,
                "num_quant_s": el.num_quant_s,
                "num_quant_p": el.num_quant_p,
                "num_quant_d": el.num_quant_d,
                "symbol": el.symbol,
                "atomic_number": float(el.atomic_number),
                "core": float(el.core),
                "valence": float(el.valence),
            })
            out += write_namelist("par", {
                "lmax": pot.lmax,
                "sumec": pot.sumec,
                "sumev": pot.sumev,
                "etot": pot.etot,
                "utot": pot.utot,
                "ekin": pot.ekin,
                "rhoeps": pot.rhoeps,
                "ws_r": pot.ws_r,
                "vmad": pot.vmad,
                "center_band": pot.center_band,
                "width_band": pot.width_band,
                "gravity_center": pot.gravity_center,
                "c": pot.c,
                "enu": pot.enu,
                "ppar": pot.ppar,
                "qpar": pot.qpar,
                "srdel": pot.srdel,
                "vl": pot.vl,
                "pl": pot.pl,
                "mom": pot.mom,
                "ql": pot.ql,
                "xi_p": pot.xi_p,
                "xi_d": pot.xi_d,
            })
            # checkpoints are named by SYMBOL, not label (print_state_
            # formatted, symbolic_atom.f90:799-806): an impurity whose
            # element file sets symbol='Fe' overwrites the host Fe_out.nml
            # — the reference's impurity refs rely on this
            sym = el.symbol if el.symbol else at.label
            path = os.path.join(self.workdir, f"{sym}_out.nml")
            with open(path, "w") as fh:
                fh.write(out)
