"""PAOFLOW interchange: export (``rs2pao``), import (``build_from_paoflow``).

Port of ``rslmtoasa_tpu/models/paoflow.py`` (host NumPy, as there).

File format (``rs2paoham.dat`` / ``paoham.dat``): one line per matrix
element ``idx1 idx2 idx3  orb_i orb_j  Re Im`` where (idx1..3) are the
lattice-translation integers of the pair vector, orb indices follow the
PAO layout (all sites' up orbitals first, then all sites' down orbitals;
``site2orb`` reference ``hamiltonian.f90`` :2430-2439) and the energies
are in eV (ry2ev = 13.605703976).

Export (``rs2pao`` :1669-1966): per type, accumulate the bare one-hop
blocks h_ik, the HoH two-hop paths -h_ij obar_j h_jk onto their
*effective* (i,k) pairs, add the onsite lsham/enim, transform each 9x9
spin block back to cubic harmonics and emit.  Deviation from the
reference, kept from the JAX package: the row PAO site uses the type index
(the reference passes the cluster atom number ``atlist(ntype)`` to
``site2orb``, which produces out-of-range site indices whenever the
representative is not atom ``ntype``; the column side already uses the
type).

Import (``build_from_paoflow_opt`` :2028-2112): match each file entry's
pair vector cr_i - (cr_j + n.A) against the cluster's neighbor vectors
and fill ``ee[type, slot]`` in Ry, in place.  Only ``ee`` changes: with
HoH, ``eeo``, ``eeoee`` and ``enim`` stay as the LMTO build made them, as
in the JAX package (ROADMAP queue 3).  Build every recursion operator
after the import: one built before it holds the old tables.
"""

from __future__ import annotations

import os

import numpy as np

from ..physics.harmonics import sph2cart
from ..utils.logger import g_logger

RY2EV = 13.605703976


def _site2orb(i18: int, site: int, n_atoms: int) -> int:
    """18-spinor index (0-based) at a site (0-based) -> 1-based PAO orbital."""
    if i18 < 9:
        return site * 9 + i18 + 1
    return site * 9 + (i18 - 9) + 1 + n_atoms * 9


def _orb2site(orb: int, n_atoms: int):
    """1-based PAO orbital -> (0-based 18-spinor index, 0-based site)."""
    if orb <= n_atoms * 9:
        return (orb - 1) % 9, (orb - 1) // 9
    return (orb - 1) % 9 + 9, (orb - 1 - n_atoms * 9) // 9


def _translation_index(avec: np.ndarray, delta: np.ndarray):
    """Integer n with sum_i n_i a(:, i) ~= delta (replaces the reference's
    -10..10 brute-force search, build_idx_from_actual_pair :1856-1894).
    avec: (3, 3) with primitive vectors as COLUMNS."""
    n = np.linalg.solve(avec, delta)
    ni = np.rint(n).astype(int)
    resid = np.linalg.norm(avec @ ni - delta)
    return ni, resid


def export_rs2pao(sys, path: str = "rs2paoham.dat"):
    """Write the effective two-center PAO Hamiltonian of every type."""
    cl = sys.cluster
    hb = sys.ham
    ntype = hb.ee.shape[0]
    avec = np.asarray(cl.cell.a)  # rows = lattice vectors (alat units)
    hoh = hb.eeo is not None
    lines = []
    for t in range(ntype):
        ia = int(cl.atlist[t]) - 1
        nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
        pairs = {}  # (ktype, n1, n2, n3) -> 18x18 block

        def accumulate(kactual: int, block: np.ndarray):
            kt = int(cl.iz[kactual]) - 1
            rep = int(cl.atlist[kt]) - 1
            ni, resid = _translation_index(
                avec, cl.cr[kactual] - cl.cr[rep]
            )
            if resid > 1e-3:
                g_logger.warning(
                    f"rs2pao: no lattice index for pair {ia + 1},"
                    f" {kactual + 1}"
                )
                return
            key = (kt, int(ni[0]), int(ni[1]), int(ni[2]))
            if key in pairs:
                pairs[key] = pairs[key] + block
            else:
                pairs[key] = block.astype(np.complex128).copy()

        # 1) bare one-hop blocks (slot 0 = onsite)
        accumulate(ia, hb.ee[t, 0])
        for m in range(1, nd + 1):
            jj = int(cl.nn[ia, m - 1])
            if jj < 0:
                continue
            accumulate(jj, hb.ee[t, m])
        # 2) HoH two-hop paths -h_ij obar_j h_jk
        if hoh:
            for m in range(1, nd + 1):
                jj = int(cl.nn[ia, m - 1])
                if jj < 0:
                    continue
                jt = int(cl.iz[jj]) - 1
                himom = hb.ee[t, m] @ hb.obarm[jt]
                accumulate(jj, -(himom @ hb.ee[jt, 0]))
                ndj = cl.dirs[int(cl.num[jj]) - 1].shape[0]
                for q in range(1, ndj + 1):
                    kk2 = int(cl.nn[jj, q - 1])
                    if kk2 < 0:
                        continue
                    # slots are canonical per crystal type, so slot q of
                    # the representative of jt carries h(jtype, q)
                    accumulate(kk2, -(himom @ hb.ee[jt, q]))
        # 3) onsite-only terms
        onsite = np.zeros((18, 18), np.complex128)
        if hb.lsham is not None:
            onsite += hb.lsham[t]
        if hoh and hb.enim is not None:
            onsite += hb.enim[t]
        if np.any(onsite):
            accumulate(ia, onsite)

        for (kt, n1, n2, n3), blk in pairs.items():
            dum = blk.copy()
            dum[:9, :9] = sph2cart(dum[:9, :9])
            dum[:9, 9:] = sph2cart(dum[:9, 9:])
            dum[9:, :9] = sph2cart(dum[9:, :9])
            dum[9:, 9:] = sph2cart(dum[9:, 9:])
            for i in range(18):
                for j in range(18):
                    ip = _site2orb(i, t, ntype)
                    jp = _site2orb(j, kt, ntype)
                    lines.append(
                        f"{n1:4d}{n2:4d}{n3:4d}{ip:7d}{jp:7d}"
                        f"{dum[i, j].real * RY2EV:22.14f}"
                        f"{dum[i, j].imag * RY2EV:22.14f}\n"
                    )
    with open(path, "w") as fh:
        fh.writelines(lines)
    g_logger.info(f"rs2pao: wrote {len(lines)} elements to {path}")


def import_paoflow(sys, path: str = "paoham.dat"):
    """Fill ``sys.ham.ee`` from a PAOFLOW real-space Hamiltonian file."""
    cl = sys.cluster
    hb = sys.ham
    ntype = hb.ee.shape[0]
    avec = np.asarray(cl.cell.a)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"paoflow Hamiltonian file not found: {path}"
        )
    dat = np.loadtxt(path)
    if dat.ndim == 1:
        dat = dat[None]
    idx = dat[:, 0:3].astype(int)
    orbl = dat[:, 3].astype(int)
    orbm = dat[:, 4].astype(int)
    val = (dat[:, 5] + 1j * dat[:, 6]) / RY2EV
    i18 = np.empty(len(orbl), int)
    isite = np.empty(len(orbl), int)
    j18 = np.empty(len(orbm), int)
    jsite = np.empty(len(orbm), int)
    for n, (ol, om) in enumerate(zip(orbl, orbm)):
        i18[n], isite[n] = _orb2site(int(ol), ntype)
        j18[n], jsite[n] = _orb2site(int(om), ntype)
    # pair vector represented by each entry: cr[isite_rep] - (cr[jsite_rep]
    # + n.A); group entries by (isite, jsite, idx) for fast slot matching
    hb.ee[:] = 0.0
    filled = 0
    for t in range(ntype):
        ia = int(cl.atlist[t]) - 1
        nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
        sel_t = isite == t
        if not np.any(sel_t):
            continue
        crep_i = cl.cr[int(cl.atlist[t]) - 1]
        for m in range(nd + 1):
            jj = ia if m == 0 else int(cl.nn[ia, m - 1])
            if jj < 0:
                continue
            vet = cl.cr[ia] - cl.cr[jj]
            jt = int(cl.iz[jj]) - 1
            crep_j = cl.cr[int(cl.atlist[jt]) - 1]
            sel = sel_t & (jsite == jt)
            if not np.any(sel):
                continue
            vet_pao = (crep_i[None, :]
                       - (crep_j[None, :] + idx[sel].astype(float) @ avec.T))
            hit = np.linalg.norm(vet_pao - vet[None, :], axis=1) < 1e-3
            if not np.any(hit):
                continue
            rows = np.nonzero(sel)[0][hit]
            for r in rows:
                hb.ee[t, m, i18[r], j18[r]] = val[r]
            filled += len(rows)
    g_logger.info(f"paoflow import: filled {filled} elements")
    return hb
