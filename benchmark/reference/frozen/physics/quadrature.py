"""Fermi-weighted Simpson quadrature (math.f90 ``simpson_f`` :1600-1633).

The reference evaluates the T -> 0 Fermi factor with kbT = 1e-15, i.e. a
step function that is 1/2 exactly at E = EF.  ``simpson_f_fermi`` matches
the reference's single-cutoff integral; ``simpson_f_cumulative`` evaluates
it for every grid point at once (the energy-resolved output curves) via
the weight-vector formulation, which is exactly equivalent because only
the Fermi factor depends on the cutoff.
"""

from __future__ import annotations

import numpy as np


def _simpson_weights(n: int, npts: int) -> np.ndarray:
    """Accumulated Simpson panel weights for the Fortran loop
    ``do I = 2, NPTS+9, 2`` with terms y[I-2] + 4 y[I-1] + y[I] (0-based
    k = I-2, I-1, I)."""
    w = np.zeros(n)
    i = np.arange(2, npts + 10, 2)
    i = i[i + 1 <= n]  # y[i] used with 0-based i, so i <= n-1
    np.add.at(w, i - 2, 1.0)
    np.add.at(w, i - 1, 4.0)
    np.add.at(w, i, 1.0)
    return w


def simpson_f_fermi(y: np.ndarray, ene: np.ndarray, ef: float,
                    npts: int) -> float:
    """Fermi-cut Simpson integral of y over ene up to ef."""
    kbt = 1.0e-15
    h = ene[1] - ene[0]
    with np.errstate(over="ignore"):
        f = 1.0 / (np.exp(np.clip((ene - ef) / kbt, -700, 700)) + 1.0)
    w = _simpson_weights(ene.shape[0], npts)
    return float(h * np.sum(w * y * f) / 3.0)


def simpson_f_cumulative(y: np.ndarray, ene: np.ndarray,
                         npts: int) -> np.ndarray:
    """simpson_f_fermi evaluated at every grid point: out[ie] = integral
    up to ene[ie] (with the half-weight at E = EF)."""
    h = ene[1] - ene[0]
    wy = _simpson_weights(ene.shape[0], npts) * y
    csum = np.concatenate([[0.0], np.cumsum(wy)[:-1]])  # sum over k < ie
    return h * (csum + 0.5 * wy) / 3.0
