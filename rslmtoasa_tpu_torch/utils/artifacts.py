"""Geometry artifact exports for reference-tooling interop.

The reference binary writes its geometry pipeline to files as it runs:
``clust`` (atom positions, lattice.f90:1093-1102), ``map`` (neighbor
map, Fortran unformatted, :2894-2896), ``sbar`` (screened structure
constants, unformatted, :2517-2519), ``str.out`` (structb text trace,
:1831-1907) and ``mad.mat`` (Madelung matrix, charge.f90:1823).  These
writers reproduce the same layouts so reference tooling can diff the
geometry directly; they are opt-in (``&lattice write_artifacts=T`` or
``RSLMTO_WRITE_GEOM=1``) since nothing in this framework reads them
back.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _rec(fh, payload: bytes) -> None:
    """One Fortran sequential unformatted record (4-byte length framing,
    the gfortran default the reference builds with)."""
    fh.write(struct.pack("<i", len(payload)))
    fh.write(payload)
    fh.write(struct.pack("<i", len(payload)))


def write_clust(cl, path: str) -> None:
    """``clust``: atom count + positions/type/site pairs, two atoms per
    line (formats 300/200, lattice.f90:1093-1102)."""
    kk = cl.kk - (cl.kk % 2)  # the reference truncates to an even count
    with open(path, "w") as fh:
        fh.write(f"   II ={kk:7d}\n")
        for k in range(0, kk, 2):
            parts = []
            for i in (k, k + 1):
                x, y, z = cl.cr[i]
                parts.append(f"{x:14.8f}{y:14.8f}{z:14.8f}"
                             f"{int(cl.iz[i]):4d}{int(cl.num[i]):4d}")
            fh.write("".join(parts) + "\n")


def write_map(cl, path: str) -> None:
    """``map``: one unformatted record per atom with its neighbor list
    ``nn(i, 1:nn(i,1))`` (1-based; slot 1 holds the count,
    lattice.f90:2894-2896)."""
    nn = cl.nn
    with open(path, "wb") as fh:
        for i in range(cl.kk):
            cols = nn[i]
            present = cols >= 0
            nr = int(present.sum()) + 1  # count slot included
            row = np.empty(nr, np.int32)
            row[0] = nr
            row[1:] = (cols[present] + 1).astype(np.int32)
            _rec(fh, row.tobytes())


def write_sbar(sbars, path: str, view_path: str = None) -> None:
    """``sbar``: per (site, neighbor) block, 9 unformatted records of 9
    f64 (row-wise; lattice.f90:2517-2519).  ``view.sbar`` text mirror
    optional."""
    vf = open(view_path, "w") if view_path else None
    with open(path, "wb") as fh:
        for sb in sbars:  # (nslots-1?, 9, 9) per representative site
            for blk in sb:
                for row in np.asarray(blk, np.float64):
                    _rec(fh, row.tobytes())
                    if vf is not None:
                        vf.write("".join(f"{v:12.6f}" for v in row) + "\n")
    if vf is not None:
        vf.close()


def write_str_out(cl, path: str) -> None:
    """``str.out``: the structb text trace header (irec bookkeeping +
    lattice coordinates + neighbor summary; lattice.f90:1843-1895)."""
    with open(path, "w") as fh:
        irec = [int(x) for x in cl.irec]
        fh.write(" irec " + str(cl.nrec) + " "
                 + " ".join(str(x) for x in irec) + "\n")
        fh.write(" irec type "
                 + " ".join(str(int(cl.iz[i - 1])) for i in irec) + "\n")
        fh.write(f" ndi= {cl.kk}\n")
        fh.write(f"{cl.kk:5d}\n")
        fh.write(" LATTICE COORDINATES\n")
        nhead = max(getattr(cl, "nmax", 0), cl.ntype)
        for i in range(nhead):
            x, y, z = cl.cr_ang[i]
            fh.write(f"{i + 1:5d}{x:8.4f}{y:8.4f}{z:8.4f}\n")
        nnmax = cl.nn.shape[1] if cl.nn is not None else 0
        fh.write(f"{cl.kk:5d}{nnmax:5d}\n")


def write_mad_mat(amad: np.ndarray, path: str) -> None:
    """``mad.mat``: ntot unformatted records, row i = AMAD(i, 1:ntot)
    (charge.f90:1823)."""
    amad = np.asarray(amad, np.float64)
    with open(path, "wb") as fh:
        for row in amad:
            _rec(fh, row.tobytes())


def export_geometry(sys_, workdir: str = ".") -> None:
    """Write every geometry artifact for a built system."""
    cl = sys_.cluster
    write_clust(cl, os.path.join(workdir, "clust"))
    if cl.nn is not None:
        write_map(cl, os.path.join(workdir, "map"))
        write_str_out(cl, os.path.join(workdir, "str.out"))
    if sys_.sbars is not None:
        write_sbar(sys_.sbars, os.path.join(workdir, "sbar"),
                   os.path.join(workdir, "view.sbar"))


def wanted(cfg) -> bool:
    return bool(getattr(cfg.lattice, "write_artifacts", False)
                or os.environ.get("RSLMTO_WRITE_GEOM"))
