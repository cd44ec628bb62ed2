"""Screened LMTO structure constants.

Re-implements (vectorised) the reference chain ``dbar1`` -> ``clusba`` ->
``micha`` -> ``STREZE``/``CANSO`` -> ``SHLDCH`` (``source/lattice.f90``
:2178-2553):

1. collect the "big" screening cluster: atoms within ``sqrt(ncut*r2)`` of a
   representative atom (``clusba``, ``ncut = 9``),
2. assemble the dense canonical (unscreened) structure-constant matrix ``S``
   from the Slater-Koster-style table (``CANSO`` :2553-2680) with distances
   in Wigner-Seitz-radius units,
3. solve the screening linear system ``(S + diag(1/q)) X = S[:, :9]`` with a
   Cholesky factorisation (``SHLDCH`` — reference calls LAPACK
   DPOTRF/DPOTRS) and form ``sbar = -2 * diag(1/q) X`` rows for atoms inside
   the neighbor cutoff ``r2``.

The screening constants are the hard-coded "original factors"
``q = 2*[0.3485, 0.05303, 0.010714]`` of ``micha`` :2341-2350.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
from scipy.linalg import cho_factor, cho_solve

#: screening constants (micha's "Original faktors", already times fak=2)
Q_SCREEN = np.array([0.3485, 0.05303, 0.010714]) * 2.0

#: per-orbital l quantum number for the 9 spd orbitals
L_OF_ORB = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])

SQ3 = np.sqrt(3.0)
SQ5 = np.sqrt(5.0)


def canonical_sc(dr: np.ndarray) -> np.ndarray:
    """Canonical structure-constant 9x9 blocks for displacement(s) ``dr``.

    ``dr`` has shape (..., 3), in units of the Wigner-Seitz radius (the
    reference passes ``(r_j - r_i)/w`` with ``w=1`` to ``CANSO``).  Entries
    with ``|dr| <= 0.3`` (onsite) return zero blocks.  Orbital order:
    s, x, y, z, xy, yz, zx, x^2-y^2, 3z^2-r^2.
    """
    dr = np.asarray(dr, dtype=np.float64)
    shp = dr.shape[:-1]
    r1, r2, r3 = dr[..., 0], dr[..., 1], dr[..., 2]
    rr = np.sqrt(r1 * r1 + r2 * r2 + r3 * r3)
    on = rr <= 0.30
    rr_safe = np.where(on, 1.0, rr)
    sbyr = 1.0 / rr_safe
    s2 = sbyr * sbyr
    s3 = s2 * sbyr
    s4 = s3 * sbyr
    s5 = s4 * sbyr
    el = r1 / rr_safe
    em = r2 / rr_safe
    en = r3 / rr_safe
    el2, em2, en2 = el * el, em * em, en * en
    elem, elen, emen = el * em, el * en, em * en

    sc = np.zeros(shp + (9, 9), dtype=np.float64)
    # ---- upper triangle, exactly the reference table -----------------
    sc[..., 0, 0] = -2.0 * sbyr
    sc[..., 0, 1] = el * s2 * 2.0 * SQ3
    sc[..., 0, 2] = em * s2 * 2.0 * SQ3
    sc[..., 0, 3] = en * s2 * 2.0 * SQ3
    sc[..., 0, 4] = -2.0 * SQ3 * SQ5 * elem * s3
    sc[..., 0, 5] = -2.0 * SQ3 * SQ5 * emen * s3
    sc[..., 0, 6] = -2.0 * SQ3 * SQ5 * elen * s3
    sc[..., 0, 7] = -SQ3 * SQ5 * s3 * (el2 - em2)
    sc[..., 0, 8] = SQ5 * s3 * (1.0 - 3.0 * en2)
    sc[..., 1, 1] = (3.0 * el2 - 1.0) * 6.0 * s3
    sc[..., 1, 2] = 18.0 * s3 * elem
    sc[..., 1, 3] = 18.0 * s3 * elen
    sc[..., 1, 4] = 6.0 * SQ5 * s4 * em * (1.0 - 5.0 * el2)
    sc[..., 1, 5] = -30.0 * SQ5 * s4 * elem * en
    sc[..., 1, 6] = 6.0 * SQ5 * s4 * en * (1.0 - 5.0 * el2)
    sc[..., 1, 7] = 6.0 * SQ5 * s4 * el * (1.0 - 2.5 * el2 + 2.5 * em2)
    sc[..., 1, 8] = 3.0 * SQ3 * SQ5 * s4 * el * (1.0 - 5.0 * en2)
    sc[..., 2, 2] = 6.0 * s3 * (3.0 * em2 - 1.0)
    sc[..., 2, 3] = 18.0 * s3 * emen
    sc[..., 2, 4] = 6.0 * SQ5 * s4 * el * (1.0 - 5.0 * em2)
    sc[..., 2, 5] = 6.0 * SQ5 * s4 * en * (1.0 - 5.0 * em2)
    sc[..., 2, 6] = sc[..., 1, 5]
    sc[..., 2, 7] = -6.0 * SQ5 * s4 * em * (1.0 - 2.5 * em2 + 2.5 * el2)
    sc[..., 2, 8] = 3.0 * SQ3 * SQ5 * s4 * em * (1.0 - 5.0 * en2)
    sc[..., 3, 3] = 6.0 * s3 * (3.0 * en2 - 1.0)
    sc[..., 3, 4] = sc[..., 1, 5]
    sc[..., 3, 5] = 6.0 * SQ5 * s4 * em * (1.0 - 5.0 * en2)
    sc[..., 3, 6] = 6.0 * SQ5 * s4 * el * (1.0 - 5.0 * en2)
    sc[..., 3, 7] = -15.0 * SQ5 * s4 * en * (el2 - em2)
    sc[..., 3, 8] = 3.0 * SQ3 * SQ5 * s4 * en * (3.0 - 5.0 * en2)
    sc[..., 4, 4] = 10.0 * s5 * (-35.0 * el2 * em2 - 5.0 * en2 + 4.0)
    sc[..., 4, 5] = -50.0 * s5 * elen * (7.0 * em2 - 1.0)
    sc[..., 4, 6] = -50.0 * s5 * emen * (7.0 * el2 - 1.0)
    sc[..., 4, 7] = -175.0 * s5 * elem * (el2 - em2)
    sc[..., 4, 8] = -25.0 * SQ3 * s5 * elem * (7.0 * en2 - 1.0)
    sc[..., 5, 5] = 10.0 * s5 * (-35.0 * em2 * en2 - 5.0 * el2 + 4.0)
    sc[..., 5, 6] = -50.0 * s5 * elem * (7.0 * en2 - 1.0)
    sc[..., 5, 7] = 50.0 * s5 * emen * (3.5 * em2 - 3.5 * el2 - 1.0)
    sc[..., 5, 8] = -25.0 * SQ3 * s5 * emen * (7.0 * en2 - 3.0)
    sc[..., 6, 6] = 10.0 * s5 * (-35.0 * el2 * en2 - 5.0 * em2 + 4.0)
    sc[..., 6, 7] = -50.0 * s5 * elen * (3.5 * el2 - 3.5 * em2 - 1.0)
    sc[..., 6, 8] = -25.0 * SQ3 * s5 * elen * (7.0 * en2 - 3.0)
    sc[..., 7, 7] = 10.0 * s5 * (-8.75 * (el2 - em2) ** 2 - 5.0 * en2 + 4.0)
    sc[..., 7, 8] = -12.5 * SQ3 * s5 * (7.0 * en2 - 1.0) * (el2 - em2)
    sc[..., 8, 8] = -7.5 * s5 * (35.0 * en2 * en2 - 30.0 * en2 + 3.0)

    # symmetrise: lower triangle <- upper triangle
    iu, ju = np.triu_indices(9, k=1)
    sc[..., ju, iu] = sc[..., iu, ju]
    # sign flips: s-p rows and d-p block (reference :2660-2670)
    sc[..., 1:4, 0] = -sc[..., 1:4, 0]
    sc[..., 4:9, 1:4] = -sc[..., 4:9, 1:4]
    # final scale (ip permutation is identity in this convention)
    sc = -0.5 * sc
    # zero out onsite blocks
    sc = np.where(on[..., None, None], 0.0, sc)
    return sc


def streze(r: np.ndarray, wav: float) -> np.ndarray:
    """Dense canonical structure-constant matrix over cluster ``r`` (n,3) Å.

    Returns ``S`` of shape (9n, 9n) with
    ``S[9i+a, 9j+b] = canonical_sc((r_j - r_i)/wav)[a, b]``.
    """
    n = r.shape[0]
    dr = (r[None, :, :] - r[:, None, :]) / wav  # (i, j, 3)
    blocks = canonical_sc(dr)  # (i, j, 9, 9)
    return blocks.transpose(0, 2, 1, 3).reshape(9 * n, 9 * n)


def screened_sbar(
    r_big: np.ndarray, wav: float, r2_small: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Screened structure-constant blocks for one representative atom.

    Parameters
    ----------
    r_big : (n, 3) positions (Å) of the screening cluster *relative* to the
        representative atom; row 0 must be the origin.  Ordering defines the
        output slot order (ascending cluster order; row 0 = onsite).
    wav : Wigner-Seitz radius (Å).
    r2_small : squared neighbor cutoff (Å^2); rows within it are returned.

    Returns
    -------
    sbar : (nt, 9, 9) screened blocks (reference scaling, ``2 * s``)
    vec : (nt, 3) the corresponding relative vectors (``sbarvec``)
    """
    n = r_big.shape[0]
    s = streze(r_big, wav)
    bet = np.tile(1.0 / Q_SCREEN[L_OF_ORB], n)  # (9n,)
    m = s + np.diag(bet)
    cf = cho_factor(m, lower=False)
    x = cho_solve(cf, s[:, :9])
    x = -bet[:, None] * x  # (9n, 9)

    d2 = (r_big**2).sum(axis=1)
    keep = d2 <= r2_small
    idx = np.nonzero(keep)[0]
    sbar = 2.0 * x.reshape(n, 9, 9)[idx]
    return sbar, r_big[idx]


def sbar_for_cluster(
    pos: np.ndarray, iu: np.ndarray, wav: float, r2: float, ncut: int = 9
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Screened structure constants for every bravais-site representative.

    ``pos`` is (kk, 3) in Å; ``iu`` holds the 1-based representative cluster
    index per site.  ``r2`` is the squared neighbor cutoff (Å^2, the
    ``&lattice r2`` value); the screening cluster uses ``ncut * r2``
    (``structb`` :1878).  Returns per-site lists of (nt, 9, 9) blocks and
    (nt, 3) vectors, slot order = onsite first then ascending cluster order.
    """
    sbars: List[np.ndarray] = []
    vecs: List[np.ndarray] = []
    for site, ia1 in enumerate(iu):
        ia = int(ia1) - 1
        rel = pos - pos[ia]
        d2 = (rel**2).sum(axis=1)
        # clusba: origin first, then atoms with 1e-4 < d2 < ncut*r2 in order
        sel = np.nonzero((d2 < ncut * r2) & (d2 > 0.0001))[0]
        r_big = np.concatenate([np.zeros((1, 3)), rel[sel]], axis=0)
        sb, vec = screened_sbar(r_big, wav, r2)
        sbars.append(sb)
        vecs.append(vec)
    return sbars, vecs
