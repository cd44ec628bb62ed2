"""Beer-Pettifor terminator optimisation for Haydock chains.

Host-side re-implementation of the reference ``bpopt`` (``recursion.f90``
:3540-3588) and ``emami`` (:3589-3713): find the asymptotic (a_inf, b_inf)
of a finite tridiagonal chain by iteratively centering the chain and
bisecting for the extremal eigenvalues of the symmetric tridiagonal matrix
(Sturm-sequence counts).  The empirical band-edge handling of
``dos%density`` (:248-370) — the 1.01 beta scaling for s-orbitals — is
applied by the caller, or by :func:`terminf_guards` for the block chains.

:func:`bpopt_fit` is the fit of many chains on the recursion's device: a
CUDA tensor launches the kernel of ``csrc/terminator.cu`` (``sm_90a``,
plain C interface, loaded with ctypes, built with nvcc into ``_build/`` at
first use), one thread a chain, bit for bit :func:`bpopt_batch`; a CPU
tensor runs :func:`bpopt_batch`, its plain version.  The wrapper counts
its launches in ``bpopt_fit.launches``.  :func:`sturm_counts` and
:func:`sturm_steps` serve measurement only.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import numpy as np
import torch

from . import cuda_build
from .haydock_kernels import _check, _ptr, _raise_on, _route, _stream

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "terminator.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libterminator.so")
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use (H100)


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


def terminf_guards(a_inf: np.ndarray, b_inf: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``get_terminf``'s guards on the fits of R blocks (R, ldim, ldim):
    NaN -> 0, a zero diagonal entry -> 0.5, and the s-orbitals' (0 and 9)
    b_inf widened by 1.01 (``recursion.f90`` :2092-2137)."""
    a_inf = np.where(np.isnan(a_inf), 0.0, a_inf)
    b_inf = np.where(np.isnan(b_inf), 0.0, b_inf)
    for n in range(a_inf.shape[0]):
        for j in range(a_inf.shape[1]):
            if a_inf[n, j, j] == 0.0:
                a_inf[n, j, j] = 0.5
            if b_inf[n, j, j] == 0.0:
                b_inf[n, j, j] = 0.5
        b_inf[n, 0, 0] *= 1.01
        b_inf[n, 9, 9] *= 1.01
    return a_inf, b_inf


# ----------------------------------------------------------------------
# the fits on the device
def build_library() -> str:
    """Compile ``csrc/terminator.cu`` into ``_build/libterminator.so``;
    returns nvcc's ``-Xptxas -v`` output."""
    return cuda_build.build(SOURCE, LIBRARY)


@functools.cache
def _library() -> ctypes.CDLL:
    cuda_build.ensure(SOURCE, LIBRARY)
    lib = ctypes.CDLL(LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bpopt_fit.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.bpopt_fit.restype = ci
    lib.bpopt_fit_smem.argtypes = [ci]
    lib.bpopt_fit_smem.restype = ci
    lib.sturm_steps.argtypes = [vp, vp, ctypes.c_double, ci, ci, vp, vp]
    lib.sturm_steps.restype = ci
    return lib


def bpopt_fit_ref(a: torch.Tensor, rb: torch.Tensor, n: int, ldim: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bpopt_fit`: :func:`bpopt_batch` and, with
    ``ldim``, :func:`terminf_guards`, in NumPy on the host."""
    with np.errstate(all="ignore"):
        ainf, binf, ifail = bpopt_batch(a.numpy(), rb.numpy(), n)
    if ldim:
        ainf, binf = (x.reshape(-1) for x in terminf_guards(
            ainf.reshape(-1, ldim, ldim), binf.reshape(-1, ldim, ldim)))
    return (torch.from_numpy(np.stack([ainf, binf])),
            torch.from_numpy(ifail.astype(np.int32)))


def bpopt_fit(a: torch.Tensor, rb: torch.Tensor, n: int, ldim: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pettifor terminators of C chains, bit for bit :func:`bpopt_batch`.

    a, rb: (C, lld) float64, the chains' diagonal and sqrt(b2)
    off-diagonal coefficients; ``n`` the levels fitted (``lld - 1`` for
    ``get_terminf``).  With ``ldim`` the chains are R blocks' (R, ldim,
    ldim) orbital pairs and :func:`terminf_guards` applies.  Returns fit
    (2, C) float64, a_inf then b_inf, and ifail (C,) int32, on a's
    device.
    """
    if _route(a) == "cpu":
        return bpopt_fit_ref(a, rb, n, ldim)
    fit, ifail = _fit(a, rb, n, ldim, None)
    bpopt_fit.launches += 1
    return fit, ifail


bpopt_fit.launches = 0


def sturm_counts(a: torch.Tensor, rb: torch.Tensor, n: int) -> torch.Tensor:
    """Measurement only: the Sturm counts (C,) int32 that each chain's fit
    runs, as :func:`bpopt_fit`'s launch on the card counts them; it counts
    no launch of the fit."""
    if _route(a) == "cpu":
        raise ValueError("sturm_counts: the chains must be on the card")
    sturms = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    _fit(a, rb, n, 0, sturms)
    return sturms


def sturm_steps(z: torch.Tensor, b: torch.Tensor, e: float, reps: int
                ) -> torch.Tensor:
    """Measurement only: ``reps`` passes over the levels 1 .. n-1 of one
    chain ``(z, b)`` ((n,) float64 on the card) at ``e`` on one thread of
    the card, each level's division waiting for the last: the latency of a
    level of the fit's Sturm counts, timed apart from the fit.  Returns (2,)
    float64: the last p and the count of levels with p < 0."""
    if _route(z) == "cpu":
        raise ValueError("sturm_steps: the chain must be on the card")
    n = z.shape[0]
    _check(z, "z", torch.float64, (n,), z.device)
    _check(b, "b", torch.float64, (n,), z.device)
    out = torch.empty((2,), dtype=torch.float64, device=z.device)
    with torch.cuda.device(z.device):
        err = _library().sturm_steps(_ptr(z), _ptr(b), e, n, reps, _ptr(out),
                                     _stream(z.device))
    _raise_on(err, "sturm_steps")
    return out


def _fit(a, rb, n, ldim, sturms):
    """The launch of the fit on the card; returns (fit, ifail)."""
    dev = a.device
    c, lld = a.shape
    if c == 0 or not 1 <= n <= lld or (ldim and (ldim < 10
                                                 or c % (ldim * ldim))):
        raise ValueError(f"bpopt_fit: C={c} chains of lld={lld} at n={n} "
                         f"(1 <= n <= lld), ldim={ldim} (0, or at least 10 "
                         f"and dividing C into blocks)")
    _check(a, "a", torch.float64, (c, lld), dev)
    _check(rb, "rb", torch.float64, (c, lld), dev)
    lib = _library()
    if lib.bpopt_fit_smem(n) > _SMEM_LIMIT:
        raise ValueError(f"bpopt_fit: {n} levels need "
                         f"{lib.bpopt_fit_smem(n)} B of shared memory, over "
                         f"the {_SMEM_LIMIT} B a block may use")
    fit = torch.empty((2, c), dtype=torch.float64, device=dev)
    ifail = torch.empty((c,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bpopt_fit(_ptr(a), _ptr(rb), _ptr(fit), _ptr(ifail),
                            None if sturms is None else _ptr(sturms), c, lld,
                            n, ldim, _stream(dev))
    _raise_on(err, "bpopt_fit")
    return fit, ifail
