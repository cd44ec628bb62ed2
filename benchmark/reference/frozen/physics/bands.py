"""Fermi level, band moments, magnetic moments (reference ``bands.f90``).

Works from the onsite Green function ``g0[18, 18, NE]`` per recursion atom
(for the collinear scalar path ``g0`` is diagonal ``-i pi * LDOS``, built by
``green%sgreen`` :628-707).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..atoms.potential import SymbolicAtom
from .energy_mesh import EnergyMesh


def simpson_m(h: float, ef: float, npts: int, y: np.ndarray, ea: float,
              nexp: int, ene: np.ndarray) -> float:
    """Moment-weighted Simpson integral (math.f90 ``simpson_m`` :1579-1598).

    ``npts`` is the 1-based NV1 count; y/ene must have npts+2 entries
    available.  Integrates int E^nexp y dE up to the grid point npts, plus
    the fractional end panel to EF when EA != EF.
    """
    w = ene**nexp if nexp else np.ones_like(ene)
    i = np.arange(1, npts - 1, 2)  # Fortran I=2,NPTS-1,2 (1-based)
    aint = np.sum(y[i - 1] * w[i - 1] + 4.0 * y[i] * w[i] + y[i + 1] * w[i + 1])
    aint = h * aint / 3.0
    if ea != ef:
        aint += (ef - ea) * (
            y[npts - 1] * w[npts - 1] + 4.0 * y[npts] * w[npts]
            + y[npts + 1] * w[npts + 1]
        ) / 6.0
    return float(aint)


def fermi_search(ef: float, h: float, ainf: float, npts: int, y: np.ndarray,
                 qqv: float):
    """Cumulative-Simpson Fermi search (bands.f90 ``fermi`` :366-407).

    Returns (ef, e1, ik1, ifail).
    """
    aint = 0.0
    aint0 = 0.0
    i_hit = None
    for i in range(2, npts, 2):  # Fortran I = 2, NPTS-1, 2 (1-based)
        aint += h * (y[i - 2] + 4.0 * y[i - 1] + y[i]) / 3.0
        if aint >= qqv:
            i_hit = i
            break
        aint0 = aint
    if i_hit is None:
        return ef, ef, 0, 1
    i = i_hit
    if aint == qqv:
        ik1 = i + 1
        ef = ainf + h * i
        e1 = ef
    else:
        alpha = (aint - aint0) / 2.0 / h
        ik1 = i - 1
        e1 = ainf + h * (i - 2)
        ef = (qqv - aint0) / alpha + e1
    return ef, e1, ik1, 0


@dataclass
class BandResults:
    fermi: float
    e1: float
    nv1: int
    dtot: np.ndarray


class Bands:
    """Per-SCF-iteration band analysis over all recursion atoms."""

    def __init__(self, emesh: EnergyMesh, atoms: Sequence[SymbolicAtom],
                 iz_rec: Sequence[int], valence_total: float, nsp: int = 1):
        self.em = emesh
        self.atoms = atoms  # species list
        self.iz_rec = list(iz_rec)  # 0-based species index per rec atom
        self.qqv = valence_total
        self.nsp = nsp
        self.e1 = emesh.fermi
        self.nv1 = emesh.nv1

    # ---------------------------------------------------------------
    def calculate_fermi(self, g0: np.ndarray, fix_fermi: bool = False,
                        calctype: str = "B"):
        """g0: (nrec, 18, 18, NE).  Updates em.fermi; returns dtot."""
        em = self.em
        npts = em.npts
        diag = np.einsum("ajjn->ajn", g0)  # (nrec, 18, NE)
        dtot = -(diag[:, :9].imag + diag[:, 9:].imag).sum(axis=(0, 1)) / np.pi
        self.dosia = -(diag[:, :9].imag + diag[:, 9:].imag).sum(axis=1) / np.pi
        self.dosial = -diag.imag / np.pi
        self.dtot = dtot
        if not fix_fermi and calctype == "B":
            ef, e1, ik1, ifail = fermi_search(
                em.fermi, em.edel, em.energy_min, npts, dtot, self.qqv
            )
            # reference runs the search twice (mag then charge) — identical
            em.fermi = ef
            self.e1 = e1
            self.nv1 = ik1
        else:
            ik1 = int(round((em.fermi - em.energy_min) / em.edel))
            self.e1 = em.energy_min + (ik1 - 1) * em.edel
            self.nv1 = ik1
        return dtot

    # ---------------------------------------------------------------
    def projected_dos(self, g0: np.ndarray):
        """(dx, dy, dz) spin-projected DOS per atom (bands ``calculate_projected_dos``)."""
        diag = np.einsum("ajjn->ajn", g0)
        up = diag[:, :9]
        dn = diag[:, 9:]
        updn = np.einsum("ajjn->ajn", g0[:, :9, 9:18]) if g0.shape[1] == 18 else None
        od_updn = np.stack([g0[:, i, i + 9] for i in range(9)], axis=1)
        od_dnup = np.stack([g0[:, i + 9, i] for i in range(9)], axis=1)
        dz = -(up.imag - dn.imag).sum(axis=1) / np.pi
        dy = -((1j * od_updn).imag - (1j * od_dnup).imag).sum(axis=1) / np.pi
        dx = -(od_updn.imag + od_dnup.imag).sum(axis=1) / np.pi
        return dx, dy, dz

    # ---------------------------------------------------------------
    def calculate_magnetic_moments(self, g0: np.ndarray):
        """Updates potential.mom/mom0/mom1/mtot per rec atom
        (``calculate_magnetic_moments`` :791-860)."""
        em = self.em
        dx, dy, dz = self.projected_dos(g0)
        for na, isp in enumerate(self.iz_rec):
            pot = self.atoms[isp].potential
            mx = simpson_m(em.edel, em.fermi, self.nv1, dx[na], self.e1, 0, em.ene)
            my = simpson_m(em.edel, em.fermi, self.nv1, dy[na], self.e1, 0, em.ene)
            mz = simpson_m(em.edel, em.fermi, self.nv1, dz[na], self.e1, 0, em.ene)
            pot.mom0 = np.array([mx, my, mz])
            pot.mom1 = np.array([
                simpson_m(em.edel, em.fermi, self.nv1, dx[na], self.e1, 1, em.ene),
                simpson_m(em.edel, em.fermi, self.nv1, dy[na], self.e1, 1, em.ene),
                simpson_m(em.edel, em.fermi, self.nv1, dz[na], self.e1, 1, em.ene),
            ])
            mtot = np.sqrt(mx * mx + my * my + mz * mz) + 1.0e-15
            pot.mtot = mtot
            pot.mom = np.array([mx, my, mz]) / mtot
            if self.nsp < 3:
                pot.mom = np.array([0.0, 0.0, 1.0])

    # ---------------------------------------------------------------
    def calculate_moments(self, g0: np.ndarray):
        """Band moments ql^(0,1,2) and gravity centers
        (``calculate_moments`` :409-524)."""
        em = self.em
        npts = em.npts
        nrec = g0.shape[0]
        dspd = np.zeros((nrec, 6, npts))
        for na, isp in enumerate(self.iz_rec):
            pot = self.atoms[isp].potential
            mom = pot.mom
            for ispn in range(2):
                isgn = (-1.0) ** ispn
                soff = 3 * ispn
                for l in range(1, 4):
                    for m in range(1, 2 * l):
                        o = (l - 1) ** 2 + m - 1  # 0-based orbital
                        guu = g0[na, o, o]
                        gdd = g0[na, o + 9, o + 9]
                        gud = g0[na, o, o + 9]
                        gdu = g0[na, o + 9, o]
                        dspd[na, l - 1 + soff] += (
                            -(guu + gdd).imag
                            - isgn * mom[2] * (guu - gdd).imag
                            - isgn * mom[1] * (1j * gud - 1j * gdu).imag
                            - isgn * mom[0] * (gud + gdu).imag
                        )
        dspd *= 0.5 / np.pi

        for na, isp in enumerate(self.iz_rec):
            pot = self.atoms[isp].potential
            for i in range(6):
                nspn = 2 if i >= 3 else 1
                soff = 3 * (nspn - 1)
                y = dspd[na, i]
                sgef = simpson_m(em.edel, em.fermi, self.nv1, y, self.e1, 0, em.ene)
                pmef = simpson_m(em.edel, em.fermi, self.nv1, y, self.e1, 1, em.ene)
                smef = simpson_m(em.edel, em.fermi, self.nv1, y, self.e1, 2, em.ene)
                l = i - soff  # 0..2
                pot.gravity_center[l, nspn - 1] = pmef / sgef - pot.vmad
                pot.ql[0, l, nspn - 1] = sgef
                pot.ql[1, l, nspn - 1] = 0.0
                pot.ql[2, l, nspn - 1] = (
                    smef - 2.0 * (pmef / sgef) * pmef + (pmef / sgef) ** 2 * sgef
                )
        self.calculate_pl()

    # ---------------------------------------------------------------
    def calculate_pl(self):
        """Update the log-derivative parameters PL (``calculate_pl`` :1241)."""
        for na, isp in enumerate(self.iz_rec):
            pot = self.atoms[isp].potential
            for s in range(2):
                for i in range(1, 4):  # Fortran i=1..3 (l = i-1)
                    rq = 1.0 / pot.qpar[i - 1, s]
                    delta2 = pot.srdel[i - 1, s] ** 2
                    cmg = pot.c[i - 1, s] - pot.gravity_center[i - 1, s]
                    dnu = (i - 1.0) + (2.0 * (i - 1) + 1.0) / (
                        rq * cmg / 2.0 / (2 * (i - 1) + 1.0)
                        / (cmg - delta2 * rq) - 1.0
                    )
                    pli = -np.arctan(dnu) / np.pi + 0.5 + int(pot.pl[i - 1, s])
                    pot.pl[i - 1, s] = pli

    # ---------------------------------------------------------------
    def calculate_band_energy(self) -> float:
        return simpson_m(self.em.edel, self.em.fermi, self.nv1, self.dtot,
                         self.e1, 1, self.em.ene)

    # ---------------------------------------------------------------
    def _l_operators_18(self):
        """L_x/L_y/L_z in spherical harmonics, spin-block-diagonal 18x18
        (``calculate_orbital_moments`` :1094-1111)."""
        from .harmonics import L_X, L_Y, L_Z, cart2sph

        ops = []
        for lop in (L_X, L_Y, L_Z):
            l9 = cart2sph(lop)
            l18 = np.zeros((18, 18), dtype=np.complex128)
            l18[:9, :9] = l9
            l18[9:, 9:] = l9
            ops.append(l18)
        return ops

    # ---------------------------------------------------------------
    def calculate_orbital_moments(self, g0: np.ndarray, workdir=None):
        """Orbital moments l_mom = -(1/pi) int^EF Im tr[L_a g0(E)] dE
        (``calculate_orbital_moments`` :1075-1156).  Writes
        ``<El>_orbene.out`` cumulative curves when workdir is given.
        """
        import os

        from .quadrature import simpson_f_cumulative

        em = self.em
        ops = self._l_operators_18()
        for na, isp in enumerate(self.iz_rec):
            pot = self.atoms[isp].potential
            # integrand per energy: Im tr[L g0]
            li = np.stack([
                np.einsum("ab,ban->n", op, g0[na]).imag for op in ops
            ])  # (3, NE)
            lmom = np.array([
                -simpson_m(em.edel, em.fermi, self.nv1, li[c], self.e1, 0,
                           em.ene) / np.pi
                for c in range(3)
            ])
            pot.lmom = lmom
            if workdir is not None:
                sym = self.atoms[isp].element.symbol
                cum = np.stack([
                    simpson_f_cumulative(li[c], em.ene, em.nv1)
                    for c in range(3)
                ])
                path = os.path.join(workdir, f"{sym}_orbene.out")
                with open(path, "w") as fh:
                    for ie in range(em.npts):
                        fh.write(f"{em.ene[ie] - em.fermi:16.6e}" + "".join(
                            f"{-cum[c, ie] / np.pi:16.6e}" for c in range(3)
                        ) + "\n")

    # ---------------------------------------------------------------
    def calculate_orbital_quadrupoles(self, g0: np.ndarray, workdir=None):
        """Orbital quadrupoles Q_ab = <1/2 {L_a, L_b}> per rec atom
        (``calculate_orbital_quadrupoles`` :878-1067).  Returns
        (nrec, 8) rows [Qxx Qyy Qzz Qxy Qyz Qzx Qx2y2 Q3z2r2]; writes
        ``<El>_orbquadene.out`` when workdir is given.
        """
        import os

        from .quadrature import simpson_f_cumulative

        em = self.em
        lx, ly, lz = self._l_operators_18()
        qops = [lx @ lx, ly @ ly, lz @ lz,
                0.5 * (lx @ ly + ly @ lx),
                0.5 * (ly @ lz + lz @ ly),
                0.5 * (lz @ lx + lx @ lz)]
        out = np.zeros((len(self.iz_rec), 8))
        for na, isp in enumerate(self.iz_rec):
            qi = np.stack([
                np.einsum("ab,ban->n", op, g0[na]).imag for op in qops
            ])  # (6, NE)
            q = np.array([
                -simpson_m(em.edel, em.fermi, self.nv1, qi[c], self.e1, 0,
                           em.ene) / np.pi
                for c in range(6)
            ])
            out[na, :6] = q
            out[na, 6] = q[0] - q[1]
            out[na, 7] = 2.0 * q[2] - q[0] - q[1]
            if workdir is not None:
                sym = self.atoms[isp].element.symbol
                cum = np.stack([
                    simpson_f_cumulative(qi[c], em.ene, em.nv1)
                    for c in range(6)
                ]) / (-np.pi)
                path = os.path.join(workdir, f"{sym}_orbquadene.out")
                with open(path, "w") as fh:
                    for ie in range(em.npts):
                        row = cum[:, ie]
                        fh.write(
                            f"{em.ene[ie] - em.fermi:16.6e}"
                            + "".join(f"{v:16.6e}" for v in row)
                            + f"{row[0] - row[1]:16.6e}"
                            + f"{2 * row[2] - row[0] - row[1]:16.6e}\n"
                        )
        return out
