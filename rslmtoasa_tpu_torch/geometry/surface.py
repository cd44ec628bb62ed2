"""Surface (slab) cluster construction.

Implements ``lattice%build_surf_full`` (:1220-1473): slice the bulk cluster
into layers along the Miller normal ``surftype``; keep one empty-sphere
layer above the surface plane and ~50 layers below; the first ``nlay``
layers become new inequivalent surface types (recursion sites), deeper
layers keep their bulk types; per-type representatives are chosen near the
surface-normal axis.

Vectorised: atoms are bucketed by layer index once (NumPy), then the short
per-layer loop (~52 iterations) does grouped unique-type numbering and
representative selection, preserving the reference's exact enumeration
order (layer-major, original atom order within a layer) — the order fixes
surface-type numbering and therefore LDOS parity at 1e-6.
"""

from __future__ import annotations

import numpy as np

from .cluster import Cluster


def build_surf_full(cl: Cluster, surftype: str, nlay: int,
                    nbulk_bulk: int) -> Cluster:
    miller = np.array([float(x) for x in surftype.split()])
    if cl.cell.a.shape == (3, 3) and len(miller) == 4:  # hcp 4-index
        dx, dy, dz, dw = miller
        dx2 = 2 * dx + dy
        dy2 = dx2 + 2 * dy
        miller = np.array([dx2, dy2, dw])
    d = miller

    h = cl.cr @ d  # layer heights
    # layer step = smallest nonzero height difference (over unique heights,
    # not the O(kk^2) all-pairs matrix); ds2 = min |h|
    hu = np.unique(np.round(h, 9))
    du = np.diff(np.sort(hu))
    du = du[du > 1.0e-6]
    zstep = du.min()
    ds2 = np.abs(h).min()
    zmin = ds2 - zstep
    zmax = ds2 + 50.0 * zstep
    n = int((zmax - zmin) / zstep) + 1
    z = zmin + zstep * np.arange(n)

    max_type = int(cl.iz.max())
    atom_type = cl.iz
    crystal_type = cl.num

    # bucket every atom onto its layer: li = nearest grid index, kept only
    # if the height matches within the reference's 1e-6 window
    li = np.round((h - zmin) / zstep).astype(np.int64)
    on_layer = (li >= 0) & (li < n) \
        & (np.abs(h - (zmin + zstep * li)) < 1.0e-6)
    idx = np.flatnonzero(on_layer)
    # layer-major order, original atom order within a layer (the reference's
    # i-then-k double loop)
    keep_idx = idx[np.argsort(li[idx], kind="stable")]
    lay = li[keep_idx]
    nsurf = keep_idx.size
    pos1 = np.arange(1, nsurf + 1)  # 1-based index in the NEW ordering
    norms = np.linalg.norm(cl.cr[keep_idx], axis=1)

    typesurf = np.empty(nsurf, dtype=np.int64)
    crystalsurf = crystal_type[keep_idx].astype(np.int64)
    natoms_layer = np.zeros(n, dtype=np.int64)
    ichoicen = {}  # type -> 1-based index in the NEW cluster ordering
    bounds = np.searchsorted(lay, np.arange(n + 1))
    for i in range(min(n, nlay + nbulk_bulk)):
        s, e = int(bounds[i]), int(bounds[i + 1])
        if s == e:
            continue
        ks = keep_idx[s:e]
        disi_min = np.sqrt(z[i] ** 2) + 1.0
        if i < nlay:
            tk = atom_type[ks]
            uniq, first, inv = np.unique(tk, return_index=True,
                                         return_inverse=True)
            # number new types in order of first appearance
            rank = np.empty(uniq.size, dtype=np.int64)
            rank[np.argsort(first, kind="stable")] = np.arange(uniq.size)
            t_vals = max_type + 1 + rank[inv]
            natoms_layer[i] = uniq.size
            max_type += int(uniq.size)
        else:
            t_vals = atom_type[ks].astype(np.int64)
        typesurf[s:e] = t_vals
        # representative: LAST atom (enumeration order) within disi_min
        sel = norms[s:e] < disi_min
        for p_, t_ in zip(pos1[s:e][sel], t_vals[sel]):
            ichoicen[int(t_)] = int(p_)
    # deeper layers keep their bulk types (no representative updates)
    s = int(bounds[min(n, nlay + nbulk_bulk)])
    typesurf[s:] = atom_type[keep_idx[s:]]

    if nsurf % 2 != 0:
        nsurf -= 1
        keep_idx = keep_idx[:nsurf]
        typesurf = typesurf[:nsurf]
        crystalsurf = crystalsurf[:nsurf]

    out = Cluster(
        cr=cl.cr[keep_idx], iz=typesurf, num=crystalsurf, kk=nsurf,
        alat=cl.alat, cell=cl.cell, wav=cl.wav,
    )
    out.ntype = max_type
    out.nbulk = nbulk_bulk
    out.nrec = max_type - nbulk_bulk
    out.nbas = 49
    out.irec = np.array(
        [ichoicen[nbulk_bulk + i + 1] for i in range(out.nrec)],
        dtype=np.int64,
    )
    # bulk representatives (types 1..nbulk) double as bravais-site reps
    out.ib = np.array([ichoicen[i + 1] for i in range(nbulk_bulk)],
                      dtype=np.int64)
    out.iu = out.ib[: cl.cell.ntot].copy()
    out.atlist = np.concatenate([out.ib, out.irec])
    out.natoms_layer = natoms_layer
    out.miller = d
    out._ct1 = cl._ct1
    return out
