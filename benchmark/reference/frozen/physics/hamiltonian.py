"""Frozen copy of the Hamiltonian's two-centre blocks and spin-orbit table
(``rslmtoasa_tpu_torch/physics/hamiltonian.py``: ``_pauli_to_spinor``,
``ham0m_nc``, ``build_lsham``; reference ``hamiltonian.f90`` ``ham0m_nc``
:2225-2303, ``build_lsham`` :1370-1420)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..atoms.potential import SymbolicAtom
from .harmonics import L_X, L_Y, L_Z, cart2sph


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
