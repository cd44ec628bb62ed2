"""Beer-Pettifor terminator optimisation for Haydock chains.

Host-side re-implementation of the reference ``bpopt`` (``recursion.f90``
:3540-3588) and ``emami`` (:3589-3713): find the asymptotic (a_inf, b_inf)
of a finite tridiagonal chain by iteratively centering the chain and
bisecting for the extremal eigenvalues of the symmetric tridiagonal matrix
(Sturm-sequence counts).  The empirical band-edge handling of
``dos%density`` (:248-370) — the 1.01 beta scaling for s-orbitals — is
applied by the caller.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def emami(a: np.ndarray, b: np.ndarray, n: int) -> Tuple[float, float]:
    """Extremal eigenvalues of the sym. tridiagonal (diag a, offdiag b).

    ``b[i]`` couples levels i-1 and i in the reference's 1-based convention:
    b(1) is ignored (zeroed).  Exact port of the bisection with its 50-step
    cap and relative tolerance.
    """
    a = np.asarray(a, dtype=np.float64)
    bb = np.array(b, dtype=np.float64, copy=True)
    bb = np.concatenate([bb, [0.0]])
    bb[0] = 0.0
    relfeh = 2.0 ** (-39)
    eps = 1.0e-6

    x1 = a[:n] + np.abs(bb[:n]) + np.abs(bb[1 : n + 1])
    x2 = a[:n] - np.abs(bb[:n]) - np.abs(bb[1 : n + 1])
    emax0 = float(x1.max())
    emin0 = float(x2.min())

    def sturm_count(e: float) -> int:
        num = 0
        p = a[0] - e
        if p < 0.0:
            num += 1
        for i in range(1, n):
            if p == 0.0:
                p = (a[i] - e) - abs(bb[i]) / relfeh
            else:
                p = (a[i] - e) - bb[i] ** 2 / p
            if p < 0.0:
                num += 1
        return num

    # phase 1: largest eigenvalue
    emax, emin = emax0, emin0
    e = 0.5 * (emax + emin)
    for _ in range(50):
        e = 0.5 * (emax + emin)
        num = sturm_count(e)
        if num == n:
            emax = e
        if num < n:
            emin = e
        mid = 0.5 * (emax + emin)
        if mid != 0.0 and abs((emax - emin) / mid) <= eps:
            break
    else:
        return emax, emin  # cap hit: reference goto 1000 leaves current vals
    e1 = e
    # phase 2: smallest eigenvalue
    emax, emin = e1, emin0
    for _ in range(50):
        e = 0.5 * (emax + emin)
        num = sturm_count(e)
        if num == 0:
            emin = e
        if num > 0:
            emax = e
        mid = 0.5 * (emax + emin)
        if mid != 0.0 and abs((emax - emin) / mid) <= eps:
            break
    else:
        return emax, emin
    e2 = e
    return e1, e2


def emami_batch(a: np.ndarray, b: np.ndarray, n: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised :func:`emami` over a batch of chains.

    a, b: (C, nl) arrays.  Returns (emax (C,), emin (C,)) with per-lane
    freezing that reproduces the scalar control flow exactly (each lane
    stops bisecting at its own convergence iteration).
    """
    a = np.asarray(a, dtype=np.float64)
    c = a.shape[0]
    bb = np.zeros((c, n + 1))
    bb[:, :n] = b[:, :n]
    bb[:, 0] = 0.0
    relfeh = 2.0 ** (-39)
    eps = 1.0e-6

    x1 = a[:, :n] + np.abs(bb[:, :n]) + np.abs(bb[:, 1 : n + 1])
    x2 = a[:, :n] - np.abs(bb[:, :n]) - np.abs(bb[:, 1 : n + 1])
    emax0 = x1.max(axis=1)
    emin0 = x2.min(axis=1)

    def sturm(e):
        num = np.zeros(c, dtype=np.int64)
        p = a[:, 0] - e
        num += p < 0.0
        for i in range(1, n):
            pz = p == 0.0
            p = np.where(pz, (a[:, i] - e) - np.abs(bb[:, i]) / relfeh,
                         (a[:, i] - e) - bb[:, i] ** 2 / np.where(pz, 1.0, p))
            num += p < 0.0
        return num

    def phase(emax, emin, hi_is_full):
        emax = emax.copy()
        emin = emin.copy()
        e_out = 0.5 * (emax + emin)
        active = np.ones(c, dtype=bool)
        for _ in range(50):
            if not active.any():
                break
            e = 0.5 * (emax + emin)
            num = sturm(e)
            if hi_is_full:
                up = num == n
                dn = num < n
            else:
                up = num > 0
                dn = num == 0
            emax = np.where(active & up, e, emax)
            # phase1: up means all below -> emax=e; dn -> emin=e
            if hi_is_full:
                emin = np.where(active & dn, e, emin)
            else:
                emin = np.where(active & dn, e, emin)
            mid = 0.5 * (emax + emin)
            dele = np.abs(np.where(mid != 0.0, (emax - emin) / mid, np.inf))
            newly = active & (dele <= eps)
            e_out = np.where(active, e, e_out)
            active = active & ~newly
        return emax, emin, e_out, active

    # phase 1 (largest eigenvalue): num==n -> emax=e else emin=e
    emax_1, emin_1, e1, cap1 = phase(emax0, emin0, True)
    # lanes that hit the 50-cap return current emax/emin (reference goto)
    # phase 2 (smallest): num==0 -> emin=e ; num>0 -> emax=e
    emax_2, emin_2, e2, cap2 = phase(e1, emin0, False)
    out_max = np.where(cap1, emax_1, e1)
    out_min = np.where(cap1, emin_1, np.where(cap2, emin_2, e2))
    out_max = np.where(~cap1 & cap2, emax_2, out_max)
    return out_max, out_min


def bpopt_batch(a: np.ndarray, rb: np.ndarray, n: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised :func:`bpopt` over chains: a, rb of shape (C, nl).

    Returns (ainf (C,), rbinf (C,), ifail (C,)).
    """
    a = np.asarray(a, dtype=np.float64)
    rb = np.asarray(rb, dtype=np.float64)
    c, nl = a.shape
    eps = 1.0e-5
    ainf = a[:, n - 1].copy()
    az = np.zeros((c, nl))
    rbz = np.zeros((c, nl))
    bmax_f = np.zeros(c)
    bmin_f = np.zeros(c)
    ifail = np.zeros(c, dtype=np.int64)
    active = np.ones(c, dtype=bool)
    for jiter in range(1, 302):
        az[:, 0] = 0.5 * (a[:, 0] - ainf)
        az[:, 1 : n - 1] = 0.5 * (a[:, 1 : n - 1] - ainf[:, None])
        rbz[:, 1 : n - 1] = 0.5 * rb[:, 1 : n - 1]
        az[:, n - 1] = a[:, n - 1] - ainf
        rbz[:, n - 1] = rb[:, n - 1] / np.sqrt(2.0)
        bmax, bmin = emami_batch(az, rbz, n)
        bm = np.abs(bmax + bmin)
        ainf = np.where(active, ainf + (bmax + bmin), ainf)
        bmax_f = np.where(active, bmax, bmax_f)
        bmin_f = np.where(active, bmin, bmin_f)
        done = active & (bm <= eps)
        active = active & ~done
        if jiter > 300:
            ifail[active] = 1
            break
        if not active.any():
            break
    rbinf = (bmax_f - bmin_f) / 2.0
    return ainf, rbinf, ifail


def bpopt(a: np.ndarray, rb: np.ndarray, n: int) -> Tuple[float, float, int]:
    """Pettifor terminator (a_inf, b_inf) for one chain.

    ``a`` are the lld diagonal coefficients, ``rb`` the lld sqrt(b2)
    off-diagonals, ``n`` the number of levels used (reference passes
    ``lld - 1``).  Returns (ainf, rbinf, ifail).
    """
    a = np.asarray(a, dtype=np.float64)
    rb = np.asarray(rb, dtype=np.float64)
    eps = 1.0e-5
    ainf = a[n - 1]
    az = np.zeros(len(a))
    rbz = np.zeros(len(a))
    ifail = 0
    jiter = 0
    bmax = bmin = 0.0
    while True:
        jiter += 1
        az[0] = 0.5 * (a[0] - ainf)
        az[1 : n - 1] = 0.5 * (a[1 : n - 1] - ainf)
        rbz[1 : n - 1] = 0.5 * rb[1 : n - 1]
        az[n - 1] = a[n - 1] - ainf
        rbz[n - 1] = rb[n - 1] / np.sqrt(2.0)
        bmax, bmin = emami(az, rbz, n)
        bm = abs(bmax + bmin)
        ainf = ainf + (bmax + bmin)
        if bm <= eps:
            break
        if jiter > 300:
            ifail = 1
            break
    rbinf = (bmax - bmin) / 2.0
    return float(ainf), float(rbinf), ifail
