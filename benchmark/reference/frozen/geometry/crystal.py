"""Canned primitive cells (reference ``source/lattice.f90 build_data`` :731-980).

Each entry returns the primitive translation vectors ``a`` (columns, lattice
units of ``alat``), the basis positions ``crd`` (columns), and the per-basis
type (``izp``) and bravais-site (``no``) indices, all 1-based like the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PrimitiveCell:
    a: np.ndarray  # (3,3), columns are primitive vectors (units of alat)
    crd: np.ndarray  # (3, ntot) basis positions (units of alat)
    izp: np.ndarray  # (ntot,) type index, 1-based
    no: np.ndarray  # (ntot,) bravais-site index, 1-based
    ntot: int
    # optional bookkeeping from a user lattice.nml (crystal_sym='file')
    iu: "np.ndarray | None" = None  # 1-based representatives
    ib: "np.ndarray | None" = None
    irec: "np.ndarray | None" = None
    nrec: int = 0
    nbas: int = 0


def primitive_cell(crystal_sym: str, celldm: float = 0.0) -> PrimitiveCell:
    sym = crystal_sym.lower()
    if sym == "bcc":
        a = np.array([[-0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, -0.5]]).T
        crd = np.zeros((3, 1))
        izp = np.array([1])
        no = np.array([1])
    elif sym == "b2":
        a = np.eye(3)
        crd = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]).T
        izp = np.array([1, 2])
        no = np.array([1, 2])
    elif sym == "fcc":
        a = np.array([[0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]]).T
        crd = np.zeros((3, 1))
        izp = np.array([1])
        no = np.array([1])
    elif sym == "fcc2":
        a = np.array([[0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]]).T
        crd = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]).T
        izp = np.array([1, 2])
        no = np.array([1, 2])
    elif sym == "fcc3":
        a = np.array([[0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]).T
        crd = np.array(
            [
                [0.25, 0.25, 0.25],
                [0.0, 0.0, 0.0],
                [0.5, 0.5, 0.5],
                [-0.25, -0.25, -0.25],
            ]
        ).T
        izp = np.array([1, 2, 3, 4])
        no = np.array([1, 2, 3, 4])
    elif sym == "hcp":
        if celldm == 0.0:
            celldm = 1.633
        a = np.array(
            [[1.0, 0.0, 0.0], [-0.5, 0.866025, 0.0], [0.0, 0.0, celldm]]
        ).T
        crd = np.array([[0.0, 0.0, 0.0], [0.0, 0.57735, 0.5 * celldm]]).T
        izp = np.array([1, 2])
        no = np.array([1, 2])
    else:
        raise ValueError(f"unknown crystal_sym {crystal_sym!r}")
    return PrimitiveCell(a=a, crd=crd, izp=izp.astype(np.int64),
                         no=no.astype(np.int64), ntot=crd.shape[1])


def cell_volume(a: np.ndarray, alat: float) -> float:
    """Primitive-cell volume in cubic Angstroms (``build_data`` tail)."""
    return float(abs(np.dot(a[:, 2], np.cross(a[:, 0], a[:, 1]))) * alat**3)


def default_wav(a: np.ndarray, alat: float, ntot: int) -> float:
    """Wigner-Seitz radius from the cell volume when not given."""
    vol = cell_volume(a, alat)
    return float((vol / ((16.0 / 3.0) * np.arctan(1.0) * ntot)) ** (1.0 / 3.0))
