"""LDOS reconstruction from Haydock chain coefficients.

The Beer-Pettifor continued fraction with square-root terminator
(``density_of_states.f90`` ``bprldos`` :377-419) evaluated for all energies
and all chains at once, plus the orchestration of ``dos%density``
(:248-370): per-orbital terminator fits (``bpopt``), the empirical 1.01
beta_inf scaling for s-orbitals, per-orbital band renormalisation
``e/dw_l - cshi`` and the final ``/dw_l``.

Plain NumPy complex128 on the host: the fraction is tiny next to the
recursion, and the JAX package pins it to the host too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .terminator import bpopt


def bprldos(
    e: np.ndarray,  # (NE,) energies
    a: np.ndarray,  # (lld, C)
    b2: np.ndarray,  # (lld, C)
    ebot: np.ndarray,  # (C,)
    etop: np.ndarray,  # (C,)
) -> np.ndarray:
    """Continued-fraction LDOS density for each (energy, chain).

    ``e`` has shape (NE,); returns (NE, C).  The terminator is the
    square-root branch with Im(Q) <= 0 (reference :1268-1298 analogue in
    bprldos).
    """
    return _bprldos_shifted(np.asarray(e)[:, None], a, b2, ebot, etop)


def orbital_density(
    a: np.ndarray,  # (lld, 18) chain diagonals for one atom (sph basis)
    b2: np.ndarray,  # (lld, 18)
    ene: np.ndarray,  # (NE,) energy mesh
    dw_l: np.ndarray,  # (18,)
    cshi: np.ndarray,  # (18,)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-orbital LDOS for one atom (``dos%density``).

    Returns (tdens (18, NE), a_inf (18,), b_inf (18,)).
    """
    lld = a.shape[0]
    a_inf = np.zeros(18)
    b_inf = np.zeros(18)
    for nl in range(18):
        sqb = np.sqrt(b2[:, nl])
        ainf, binf, _ = bpopt(a[:, nl], sqb, lld - 1)
        if nl in (0, 9):  # s-orbitals: empirical band-edge widening
            binf *= 1.01
        a_inf[nl] = ainf
        b_inf[nl] = binf
    ebot = a_inf - 2.0 * b_inf
    etop = a_inf + 2.0 * b_inf

    # e_shift per orbital: ene/dw_l - cshi  (density :355-360)
    e_shift = ene[:, None] / dw_l[None, :] - cshi[None, :]  # (NE, 18)
    dens = _bprldos_shifted(e_shift, a, b2, ebot, etop)
    tdens = dens / dw_l[None, :]  # (NE, 18)
    return tdens.T, a_inf, b_inf


def _bprldos_shifted(
    e: np.ndarray,  # (NE, C) per-chain shifted energies
    a: np.ndarray,
    b2: np.ndarray,
    ebot: np.ndarray,
    etop: np.ndarray,
) -> np.ndarray:
    lld = a.shape[0]
    ec = np.asarray(e).astype(np.complex128)
    ebot_c = np.asarray(ebot)[None, :].astype(np.complex128)
    etop_c = np.asarray(etop)[None, :].astype(np.complex128)
    emid = 0.5 * (etop_c + ebot_c)
    det = (ec - etop_c) * (ec - ebot_c)
    zoff = np.sqrt(det)
    qt = (ec - emid - zoff) * 0.5
    qt = np.where(qt.imag > 0.0, (ec - emid + zoff) * 0.5, qt)
    for idx in range(lld - 2, -1, -1):
        qt = b2[idx][None, :] / (ec - a[idx][None, :] - qt)
    return -qt.imag / np.pi
