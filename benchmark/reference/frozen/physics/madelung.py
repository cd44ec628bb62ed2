"""Bulk Ewald Madelung matrix and per-iteration potential shifts.

Re-implements the reference electrostatics chain (``source/charge.f90``):
``LATTC`` :1858-1934 (Ewald parameter + lattice-vector generation via
``LCTOFF``/``LGEN``), ``MADMAT``/``STRX00`` :1799-1981 (L=0 Ewald sums) and
``bulkpot`` :333-400 (per-SCF-iteration Madelung shifts vmad).

Units: the Ewald setup works in lattice units (alat=1); ``alat`` enters in
Bohr (reference converts with 0.52917721).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
from scipy.special import erfc

ANG2BOHR_CHG = 0.52917721  # the reference's bulkmat conversion constant


def _lctoff(a0: float, v0: float, lmax: int, tol: float):
    """Real/reciprocal cutoffs (LCTOFF :2043-2081)."""
    q1 = 0.001
    if lmax > 2:
        q1 = np.sqrt(0.5 * (lmax - 2)) * a0 / np.pi
    q2 = 50.0
    q0 = 5.0
    for _ in range(25):
        gq0 = (2.0 * np.pi * q0) ** (lmax - 2) * np.exp(-((np.pi * q0 / a0) ** 2)) \
            * 4.0 * np.pi / v0
        if gq0 > tol:
            q1 = q0
        else:
            q2 = q0
        q0 = 0.5 * (q1 + q2)
    r1, r2 = 0.1, 50.0
    r0 = 5.0
    f = np.zeros(lmax + 1)
    for _ in range(25):
        f = _dlmtor_f(r0, a0, lmax)
        if f[lmax] > tol:
            r1 = r0
        else:
            r2 = r0
        r0 = 0.5 * (r1 + r2)
    return r0, q0


def _dlmtor_f(r: float, a: float, lmax: int) -> np.ndarray:
    """Radial damped-LMTO values F(0..lmax) (DLMTOR :2085-2122)."""
    obsrpi = 0.564189835
    z = a * r
    emz2 = np.exp(-z * z)
    erfc0 = float(erfc(z))
    f = np.zeros(lmax + 1)
    f[0] = erfc0 / r
    g = 2.0 * a * emz2 * obsrpi / r
    ta2r = 2.0 * a * a * r
    for l in range(1, lmax + 1):
        f[l] = ((l + l - 1) / r) * f[l - 1] + g
        g = g * ta2r
    return f


def _lgen(bas: np.ndarray, bmax: float) -> np.ndarray:
    """Generate and length-sort lattice vectors within bmax (LGEN :2168-2242).

    ``bas`` columns are the primitive vectors.  Sort key is |v|^2 + L1/1000
    (the reference's skewed selection sort) — ties resolved identically.
    """
    a = bas.T @ bas
    det = np.linalg.det(a)
    i1 = int(bmax * np.sqrt((a[1, 1] * a[2, 2] - a[1, 2] ** 2) / det))
    i2 = int(bmax * np.sqrt((a[0, 0] * a[2, 2] - a[0, 2] ** 2) / det))
    i3 = int(bmax * np.sqrt((a[0, 0] * a[1, 1] - a[0, 1] ** 2) / det))
    rng1 = np.arange(-i1, i1 + 1)
    rng2 = np.arange(-i2, i2 + 1)
    rng3 = np.arange(-i3, i3 + 1)
    ii, jj, kk = np.meshgrid(rng1, rng2, rng3, indexing="ij")
    m = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1).astype(np.float64)
    v = m @ bas.T
    v2 = (v**2).sum(axis=1)
    keep = v2 <= bmax * bmax
    v = v[keep]
    key = (v**2).sum(axis=1) + np.abs(v).sum(axis=1) / 1000.0
    order = np.argsort(key, kind="stable")
    return v[order]


def _shortn(p: np.ndarray, dlat: np.ndarray) -> np.ndarray:
    """Shortest equivalent vector under the skewed norm (SHORTN :1995-2028)."""

    def anrm2(x, y, z):
        return (x * x * 1.00001 + y * y * 1.00002 + z * z * 1.00003
                - x * 0.000004 - y * 0.000003 - z * 0.000002)

    p1 = p.copy()
    dd = (dlat**2).sum(axis=1)
    for _ in range(20):
        p2 = anrm2(*p1)
        cand = dlat[dd <= p2 * 4.0]
        if cand.shape[0] == 0:
            break
        crit = anrm2(p1[0] + cand[:, 0], p1[1] + cand[:, 1], p1[2] + cand[:, 2])
        k0 = int(np.argmin(crit))
        # the reference breaks ties by first-in-list; argmin matches since
        # dlat is length-sorted and crit strictly ordered for distinct vecs
        if np.allclose(cand[k0], 0.0):
            return p1
        if crit[k0] >= anrm2(*p1):
            return p1
        p1 = p1 + cand[k0]
    return p1


def _strx00(tau: np.ndarray, awald: float, alat: float, vol: float,
            rlat: np.ndarray, dlat: np.ndarray) -> float:
    """L=0 Ewald structure constant (STRX00 :1951-1981)."""
    tpi = 2.0 * np.pi
    gamma = 0.25 / (awald * awald)
    tpiba = tpi / alat
    # reciprocal sum (skip the zero vector = first row)
    q = rlat[1:]
    r2 = tpiba * tpiba * (q**2).sum(axis=1)
    scalp = tpi * (q @ tau)
    dl = -gamma + np.sum(np.cos(scalp) * np.exp(-gamma * r2) / r2)
    dl *= 4.0 * np.pi / vol
    # real-space sum
    onsite = (tau @ tau) <= 1.0e-6
    d = dlat[1:] if onsite else dlat
    r1 = alat * np.sqrt(((tau[None, :] - d) ** 2).sum(axis=1))
    dl += np.sum(erfc(awald * r1) / r1)
    if onsite:
        dl -= 2.0 * awald / np.sqrt(np.pi)
    return float(dl)


@dataclass
class MadelungMatrix:
    amad: np.ndarray  # (nbas, nbas)

    @classmethod
    def bulk(cls, a_prim: np.ndarray, crd: np.ndarray, alat_ang: float,
             awald0: float = 3.0, tol: float = 1.0e-6, lmxst: int = 5
             ) -> "MadelungMatrix":
        """Build the bulk Madelung matrix (``bulkmat`` :580-634 + LATTC).

        a_prim: (3,3) primitive vectors (columns, lattice units);
        crd: (3, nbas) basis positions (lattice units); alat in Angstrom.
        """
        alat = alat_ang / ANG2BOHR_CHG  # Bohr
        nbas = crd.shape[1]
        rb0 = a_prim
        # reciprocal cell (rows of LATTC's qb0 = cross products / vol0)
        qb0 = np.zeros((3, 3))
        qb0[:, 0] = np.cross(rb0[:, 1], rb0[:, 2])
        qb0[:, 1] = np.cross(rb0[:, 2], rb0[:, 0])
        qb0[:, 2] = np.cross(rb0[:, 0], rb0[:, 1])
        vol0 = abs(np.dot(rb0[:, 0], np.cross(rb0[:, 1], rb0[:, 2])))
        qb0 /= vol0
        vol = vol0 * alat**3

        rdist0 = vol0 ** (1.0 / 3.0)
        qdist0 = 1.0 / rdist0
        radd = 0.7 * rdist0
        qadd = 0.7 * qdist0
        a0 = awald0 / rdist0
        awald = a0 / alat
        tol1 = tol * alat ** (lmxst + 1)
        r0, q0 = _lctoff(a0, vol0, lmxst, tol1)
        dlat = _lgen(rb0, r0 + radd)
        rlat = _lgen(qb0, q0 + qadd)

        amad = np.zeros((nbas, nbas))
        for ibas in range(nbas):
            for jbas in range(nbas):
                dtau = crd[:, ibas] - crd[:, jbas]
                dtau = _shortn(dtau, dlat)
                amad[jbas, ibas] = _strx00(dtau, awald, alat, vol, rlat, dlat)
        return cls(amad=amad)


ANG2AU = 1.8897259886


def impmad(cr: np.ndarray, alat: float, wav: float, nbas: int) -> np.ndarray:
    """Impurity point-charge Madelung matrix over the local region
    (``impmad`` :997-1076): amad[i, j] = 2/|r_i - r_j| (a.u.), 2/ws onsite.
    """
    pos = cr[:nbas] * alat * ANG2AU
    ws = wav * ANG2AU
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=2)
    with np.errstate(divide="ignore"):
        amad = 2.0 / d
    np.fill_diagonal(amad, 2.0 / ws)
    return amad


def imppot(amad: np.ndarray, dq: np.ndarray, bulk_charge: np.ndarray,
           chargetrf_type: Sequence[int], atoms, iz_rec: Sequence[int],
           nbulk: int, vmix: float = 1.0):
    """Impurity Madelung shifts (``imppot`` :417-489).

    dq: per-rec-atom charge transfer; bulk_charge: per bulk species;
    chargetrf_type: original species (1-based) of each local-region atom.
    Updates potential.vmad for the impurity species in place.
    """
    nbas = amad.shape[0]
    nrec = len(iz_rec)
    tdq = np.zeros(nbas)
    dif = 0.0
    for iclas in range(nrec):
        tdq[iclas] = dq[iclas] - bulk_charge[int(chargetrf_type[iclas]) - 1]
        dif += tdq[iclas]
    nsum = nbas - nrec
    if nsum > 0:
        tdq[nrec:] = -dif / nsum
    for jbas in range(nrec):
        ss = float(amad[jbas] @ tdq)
        # add the host's vmad at that site (bulk species)
        host = atoms[int(chargetrf_type[jbas]) - 1].potential.vmad
        pot = atoms[iz_rec[jbas]].potential
        vmad0 = ss + host
        pot.vmad = vmad0 * vmix + vmad0 * (1.0 - vmix)


def bulkpot(amad: np.ndarray, dq: np.ndarray, iz_bas: Sequence[int],
            atoms, iz_rec: Sequence[int], vmix: float = 1.0):
    """Per-iteration Madelung shifts (``bulkpot`` :333-400).

    ``iz_bas`` maps each basis atom to its recursion class (0-based);
    updates potential.vmad for each class in place.
    """
    nbas = amad.shape[0]
    nrec = len(iz_rec)
    vmad0 = np.array([atoms[isp].potential.vmad for isp in iz_rec])
    tdq = dq
    for ibas in range(nbas):
        vmadi = 0.0
        for jbas in range(nbas):
            vmadi += 2.0 * amad[jbas, ibas] * tdq[iz_bas[jbas]]
        atoms[iz_rec[iz_bas[ibas]]].potential.vmad = vmadi
    for iclas in range(nrec):
        pot = atoms[iz_rec[iclas]].potential
        vadd = 2.0 * tdq[iclas] / pot.ws_r
        pot.vmad = pot.vmad + vadd
        pot.vmad = pot.vmad * vmix + vmad0[iclas] * (1.0 - vmix)
