"""Tight-binding LMTO Hamiltonian block assembly.

Builds the per-type ELL block rows ``ee[ntype, nslots, 18, 18]`` of the
real-space two-center Hamiltonian from screened structure constants and
potential parameters, mirroring the reference pipeline
``build_bulkham`` -> ``chbar_nc`` -> ``hmfind`` + ``ham0m_nc`` + ``hcpx``
(``source/hamiltonian.f90`` :1553-1616, :2225-2420) with the spin structure

    ee[0:9, 0:9]   = H0 + Hz          ee[0:9, 9:18]  = Hx - i Hy
    ee[9:18, 9:18] = H0 - Hz          ee[9:18, 0:9]  = Hx + i Hy

where (H0, Hx, Hy, Hz) are the Pauli components built from the
spin-average/difference band parameters (wx0/wx1, cx0/cx1) and the local
moment directions.  Spin-orbit coupling ``lsham`` follows ``build_lsham``
:1370-1420; the HoH overlap correction follows ``build_obarm``/``build_enim``
:1477-1552.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..atoms.potential import SymbolicAtom
from ..utils.alloc import g_alloc
from ..geometry.cluster import Cluster, EPS_VEC
from .harmonics import cart2sph, L_X, L_Y, L_Z


def _attach_locham(hb: "HamiltonianBlocks", cl, atoms, sbars, sbarvecs,
                   hoh: bool) -> None:
    """Impurity-local Hamiltonian (``build_locham`` :1618-1668): per-atom
    blocks for the nmax perturbed atoms, assembled from each atom's actual
    species.  The device tables become [hall(atom rows); ee(type rows)] with
    per-atom row indices for the local zone."""
    nmax = cl.nmax
    nslots = hb.nslots
    hall = np.zeros((nmax, nslots, 18, 18), dtype=np.complex128)
    for i in range(nmax):
        it = int(cl.iz[i]) - 1
        site = int(cl.num[i]) - 1
        sb, svec = sbars[site], sbarvecs[site]
        nd = cl.dirs[site].shape[0]
        for m in range(nd + 1):
            if m == 0:
                jj = i
                vet = np.zeros(3)
            else:
                jj = int(cl.nn[i, m - 1])
                if jj < 0:
                    continue
                vet = cl.wrap_diff(cl.cr_ang[jj] - cl.cr_ang[i])
            jt = int(cl.iz[jj]) - 1
            d2 = ((svec - vet[None, :]) ** 2).sum(axis=1)
            k = int(np.argmin(d2))
            if d2[k] >= EPS_VEC:
                continue
            blk, _ = ham0m_nc(
                atoms[it].potential, atoms[jt].potential, m == 0,
                sb[k].T, hoh=hoh,
            )
            hall[i, m] = blk
    hb.hall = hall
    # combined tables: row i<nmax -> hall[i]; else ee[type]
    hb.blocks = np.concatenate([hall, hb.ee], axis=0)
    iz_eff = hb.iz.astype(np.int32) + nmax
    iz_eff[:nmax] = np.arange(nmax, dtype=np.int32)
    hb.iz_eff = iz_eff
    if hoh:
        hallo = np.zeros_like(hall)
        obarm = hb.obarm
        for i in range(nmax):
            nd = cl.dirs[int(cl.num[i]) - 1].shape[0]
            for m in range(nd + 1):
                jj = i if m == 0 else int(cl.nn[i, m - 1])
                if jj < 0:
                    continue
                ji = int(cl.iz[jj]) - 1
                hallo[i, m] = hall[i, m] @ obarm[ji]
        hb.hallo = hallo
        hb.blocks_o = np.concatenate([hallo, hb.eeo], axis=0)


@dataclass
class HamiltonianBlocks:
    """ELL-format BSR Hamiltonian for the cluster.

    ``cols[i, m]`` is the 0-based cluster index of atom ``i``'s neighbor in
    canonical slot ``m`` (slot 0 = the atom itself), or ``kk`` (one-past-end
    sentinel; gathers read a zero-padded row) when the neighbor is absent.
    ``ee[t, m]`` is the 18x18 block for slot ``m`` of type ``t`` (0-based).
    """

    ee: np.ndarray  # (ntype, nslots, 18, 18) complex128
    cols: np.ndarray  # (kk, nslots) int32
    iz: np.ndarray  # (kk,) 0-based type per cluster atom
    lsham: Optional[np.ndarray] = None  # (ntype, 18, 18)
    hxc: Optional[np.ndarray] = None  # magnetic-only part, same layout as ee
    eeo: Optional[np.ndarray] = None  # (ntype, nslots, 18, 18), HoH: ee @ obar
    eeoee: Optional[np.ndarray] = None  # HoH: eeo @ ee^H
    enim: Optional[np.ndarray] = None  # (ntype, 18, 18) HoH onsite correction
    obarm: Optional[np.ndarray] = None  # (ntype, 18, 18)
    # impurity-local zone (build_locham): per-atom rows + combined tables
    hall: Optional[np.ndarray] = None  # (nmax, nslots, 18, 18)
    hallo: Optional[np.ndarray] = None
    blocks: Optional[np.ndarray] = None  # [hall; ee] combined row table
    blocks_o: Optional[np.ndarray] = None
    iz_eff: Optional[np.ndarray] = None  # per-atom row index into blocks

    @property
    def kk(self) -> int:
        return self.cols.shape[0]

    @property
    def nslots(self) -> int:
        return self.cols.shape[1]


def _pauli_to_spinor(h4: np.ndarray, hm: np.ndarray) -> np.ndarray:
    """(H0, Hx, Hy, Hz) 9x9 blocks -> 18x18 spinor block (build_bulkham)."""
    out = np.zeros(h4.shape[:-2] + (18, 18), dtype=np.complex128)
    out[..., 0:9, 0:9] = h4 + hm[..., 2, :, :]
    out[..., 9:18, 9:18] = h4 - hm[..., 2, :, :]
    out[..., 0:9, 9:18] = hm[..., 0, :, :] - 1j * hm[..., 1, :, :]
    out[..., 9:18, 0:9] = hm[..., 0, :, :] + 1j * hm[..., 1, :, :]
    return out


def ham0m_nc(
    pot_i, pot_j, onsite: bool, hhh: np.ndarray, hoh: bool = False
) -> np.ndarray:
    """One 18x18 Hamiltonian block in the spherical-harmonic basis.

    ``hhh`` is the (transposed) screened structure-constant 9x9 block in the
    cubic basis; ``pot_i``/``pot_j`` are the two species' Potential objects
    (reference ``ham0m_nc`` :2225-2303).
    """
    mi = pot_i.mom
    mj = pot_j.mom
    dot = float(np.dot(mi, mj))
    cross = np.cross(mi, mj)
    hc = hhh.astype(np.complex128)

    wx0i, wx1i = pot_i.wx0, pot_i.wx1
    wx0j, wx1j = pot_j.wx0, pot_j.wx1

    h0 = wx0i[:, None] * hc * wx0j[None, :] + dot * wx1i[:, None] * hc * wx1j[None, :]
    hm = np.zeros((3, 9, 9), dtype=np.complex128)
    for m in range(3):
        hm[m] = (
            mi[m] * (wx1i[:, None] * hc * wx0j[None, :])
            + mj[m] * (wx0i[:, None] * hc * wx1j[None, :])
            + 1j * cross[m] * (wx1i[:, None] * hc * wx1j[None, :])
        )
    if onsite:
        c0 = pot_i.cex0 if hoh else pot_i.cx0
        c1 = pot_i.cex1 if hoh else pot_i.cx1
        h0 = h0 + np.diag(c0)
        for m in range(3):
            hm[m] = hm[m] + np.diag(c1) * mi[m]
    # cubic -> spherical on each Pauli component (chbar_nc :2354-2357)
    h0s = cart2sph(h0)
    hms = cart2sph(hm)
    return _pauli_to_spinor(h0s, hms), _pauli_to_spinor(np.zeros_like(h0s), hms)


def build_lsham(atoms: Sequence[SymbolicAtom]) -> np.ndarray:
    """Spin-orbit xi L.S blocks per type (``build_lsham`` :1370-1420)."""
    lx = cart2sph(L_X)
    ly = cart2sph(L_Y)
    lz = cart2sph(L_Z)
    prefac = np.zeros((9, 9, len(atoms)), dtype=np.complex128)
    out = np.zeros((len(atoms), 18, 18), dtype=np.complex128)
    for k, at in enumerate(atoms):
        p = at.potential
        soc_p = np.sqrt(p.xi_p[0] * p.xi_p[1])
        soc_d = np.sqrt(p.xi_d[0] * p.xi_d[1])
        pf = np.zeros((9, 9))
        pf[1:4, 1:4] = 0.5 * soc_p
        pf[4:9, 4:9] = 0.5 * soc_d
        out[k, 0:9, 0:9] = pf * lz
        out[k, 0:9, 9:18] = pf * (lx - 1j * ly)
        out[k, 9:18, 0:9] = pf * (lx + 1j * ly)
        out[k, 9:18, 9:18] = -pf * lz
    return out


def _spin_expand_diag(x0: np.ndarray, x1: np.ndarray, mom: np.ndarray) -> np.ndarray:
    """Diagonal 9-orbital (avg, diff) pair -> 18x18 spinor in sph basis
    (shared structure of build_obarm/build_enim :1477-1552)."""
    m0 = np.diag(x0)
    m1 = np.diag(x1)
    out = np.zeros((18, 18), dtype=np.complex128)
    out[0:9, 0:9] = m0 + m1 * mom[2]
    out[9:18, 9:18] = m0 - m1 * mom[2]
    # reference fills obarm(l, m+9) = obm1(m,l)*(mx - i my): transposed m1
    out[0:9, 9:18] = m1.T * (mom[0] - 1j * mom[1])
    out[9:18, 0:9] = m1.T * (mom[0] + 1j * mom[1])
    out[0:9, 0:9] = cart2sph(out[0:9, 0:9])
    out[9:18, 9:18] = cart2sph(out[9:18, 9:18])
    out[0:9, 9:18] = cart2sph(out[0:9, 9:18])
    out[9:18, 0:9] = cart2sph(out[9:18, 0:9])
    return out


def build_obarm(atoms: Sequence[SymbolicAtom]) -> np.ndarray:
    out = np.zeros((len(atoms), 18, 18), dtype=np.complex128)
    for k, at in enumerate(atoms):
        p = at.potential
        out[k] = _spin_expand_diag(p.obx0, p.obx1, p.mom)
    return out


def build_enim(atoms: Sequence[SymbolicAtom]) -> np.ndarray:
    out = np.zeros((len(atoms), 18, 18), dtype=np.complex128)
    for k, at in enumerate(atoms):
        p = at.potential
        eu = p.cx[:, 0] - p.cex[:, 0]
        ed = p.cx[:, 1] - p.cex[:, 1]
        out[k] = _spin_expand_diag(0.5 * (eu + ed), 0.5 * (eu - ed), p.mom)
    return out


def build_bulkham(
    cl: Cluster,
    atoms: Sequence[SymbolicAtom],
    sbars: List[np.ndarray],
    sbarvecs: List[np.ndarray],
    hoh: bool = False,
    with_soc: bool = False,
) -> HamiltonianBlocks:
    """Assemble the bulk ELL Hamiltonian (``build_bulkham`` :1553-1616).

    ``sbars[site]`` / ``sbarvecs[site]`` come from
    :func:`~rslmtoasa_tpu.geometry.strconst.sbar_for_cluster` per bravais
    site; slot blocks are matched to canonical neighbor directions by vector
    (the reference's ``hmfind`` contract).
    """
    assert cl.nn is not None and cl.dirs is not None and cl.atlist is not None
    ntype = cl.ntype
    nnmax = cl.nn.shape[1]
    nslots = nnmax + 1
    ee = np.zeros((ntype, nslots, 18, 18), dtype=np.complex128)
    hxc = np.zeros_like(ee)

    for t in range(ntype):
        ia = int(cl.atlist[t]) - 1
        it = int(cl.iz[ia]) - 1
        site = int(cl.num[ia]) - 1
        sb, svec = sbars[site], sbarvecs[site]
        dirs = cl.dirs[site]
        nd = dirs.shape[0]
        for m in range(nd + 1):
            if m == 0:
                jj = ia
                vet = np.zeros(3)
            else:
                jj = int(cl.nn[ia, m - 1])
                if jj < 0:
                    continue
                vet = cl.cr_ang[jj] - cl.cr_ang[ia]
            jt = int(cl.iz[jj]) - 1
            # hmfind: locate the sbar block whose vector matches vet
            d2 = ((svec - vet[None, :]) ** 2).sum(axis=1)
            k = int(np.argmin(d2))
            if d2[k] >= EPS_VEC:
                # reference logs and zeroes the neighbor (hmfind ni=0,
                # hamiltonian.f90:2401-2404)
                from ..utils.logger import g_logger

                g_logger.error(
                    f"hmfind: neighbour vector not found for atom {ia + 1}"
                    f" neighbour {m} vector {vet}")
                continue
            hhh = sb[k].T  # hmfind transposes: hhh(ilm,jlm)=sbar(jlm,ilm)
            blk, blk_mag = ham0m_nc(
                atoms[it].potential, atoms[jt].potential, m == 0, hhh, hoh=hoh
            )
            ee[t, m] = blk
            hxc[t, m] = blk_mag

    # per-atom neighbor columns with sentinel kk for missing
    cols = np.full((cl.kk, nslots), cl.kk, dtype=np.int32)
    cols[:, 0] = np.arange(cl.kk, dtype=np.int32)
    nn = np.where(cl.nn >= 0, cl.nn, cl.kk)
    cols[:, 1:] = nn.astype(np.int32)

    hb = HamiltonianBlocks(
        ee=ee, cols=cols, iz=(cl.iz - 1).astype(np.int32), hxc=hxc
    )
    if with_soc:
        hb.lsham = build_lsham(atoms[:ntype])
    if hoh:
        hb.obarm = build_obarm(atoms[:ntype])
        hb.enim = build_enim(atoms[:ntype])
        eeo = np.zeros_like(ee)
        eeoee = np.zeros_like(ee)
        for t in range(ntype):
            ia = int(cl.atlist[t]) - 1
            nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
            for m in range(nd + 1):
                jj = ia if m == 0 else int(cl.nn[ia, m - 1])
                if jj < 0:
                    continue
                ji = int(cl.iz[jj]) - 1
                eeo[t, m] = ee[t, m] @ hb.obarm[ji]
                eeoee[t, m] = eeo[t, m] @ ee[t, m].conj().T
        hb.eeo = eeo
        hb.eeoee = eeoee
    if cl.nmax > 0:
        _attach_locham(hb, cl, atoms, sbars, sbarvecs, hoh)
    g_alloc.release("hamiltonian.ee")
    g_alloc.track("hamiltonian.ee", hb.ee)
    if hb.eeo is not None:
        g_alloc.release("hamiltonian.eeo")
        g_alloc.track("hamiltonian.eeo", hb.eeo)
    if hb.hall is not None:
        g_alloc.release("hamiltonian.hall")
        g_alloc.track("hamiltonian.hall", hb.hall)
    return hb
