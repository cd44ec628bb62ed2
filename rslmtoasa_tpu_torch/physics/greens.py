"""Block Green's functions: terminators + matrix continued fraction.

Implements the block path of ``source/green.f90``:

* :func:`get_terminf` — per-(orbital,orbital) Pettifor terminator fits on
  the block-coefficient chains with the reference's NaN/zero guards and
  s-orbital 1.01 widening (``recursion.f90 get_terminf`` :2092-2137 +
  ``get_cinf`` :2030-2092),
* :func:`bgreen` — per-energy matrix continued fraction with the
  orbital-dependent square-root terminator (``green.f90 bgreen``
  :1191-1339): a chain of 18x18 LU inversions evaluated batched over all
  energies.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.terminator import bpopt_batch


def get_terminf(a_b: np.ndarray, b_b: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Terminator coefficients for block chains.

    a_b, b_b: (lld, R, 18, 18) — b_b must already hold B = sqrt(B^2)
    (i.e. after :func:`~rslmtoasa_tpu_torch.ops.block_lanczos.zsqr`).
    Returns (a_inf, b_inf) of shape (R, 18, 18).
    """
    lld, r = a_b.shape[0], a_b.shape[1]
    ldim = a_b.shape[2]
    # chains: (R*18*18, lld) over the real parts
    aa = np.ascontiguousarray(
        a_b.real.transpose(1, 2, 3, 0).reshape(-1, lld)
    )
    bb = np.ascontiguousarray(
        b_b.real.transpose(1, 2, 3, 0).reshape(-1, lld)
    )
    with np.errstate(all="ignore"):
        ainf, binf, _ = bpopt_batch(aa, bb, lld - 1)
    a_inf = ainf.reshape(r, ldim, ldim)
    b_inf = binf.reshape(r, ldim, ldim)
    a_inf = np.where(np.isnan(a_inf), 0.0, a_inf)
    b_inf = np.where(np.isnan(b_inf), 0.0, b_inf)
    for n in range(r):
        for j in range(ldim):
            if a_inf[n, j, j] == 0.0:
                a_inf[n, j, j] = 0.5
            if b_inf[n, j, j] == 0.0:
                b_inf[n, j, j] = 0.5
        b_inf[n, 0, 0] *= 1.01
        b_inf[n, 9, 9] *= 1.01
    return a_inf, b_inf


def bgreen(a_b: np.ndarray, b_b: np.ndarray, a_inf: np.ndarray,
           b_inf: np.ndarray, ene: np.ndarray, sym_term: bool = False
           ) -> np.ndarray:
    """Matrix continued-fraction onsite Green function for one atom.

    a_b, b_b: (lld, 18, 18) block coefficients (b_b = sqrt(B^2));
    a_inf/b_inf: (18, 18) terminators; ene: (NE,).
    Returns g0 (18, 18, NE) complex.
    """
    lld = a_b.shape[0]
    ldim = a_b.shape[1]
    ne = ene.shape[0]
    e = ene[:, None]  # (NE, 1) for diag broadcasting

    # ---- terminator initialisation (orbital-diagonal) ----------------
    q = np.zeros((ne, ldim, ldim), dtype=np.complex128)
    diag = np.arange(ldim)
    ai = np.diag(a_inf).copy()
    bi = np.diag(b_inf).copy()
    if sym_term:
        a_d = 0.5 * (a_inf[0, 0] + a_inf[9, 9])
        b_d = 0.5 * (b_inf[0, 0] + b_inf[9, 9])
        etop = np.full(ldim, a_d + 2.0 * b_d)
        ebot = np.full(ldim, a_d - 2.0 * b_d)
        det = (e - etop[None, :]) * (e - ebot[None, :])
        zoff = np.sqrt(det.astype(np.complex128))
        q[:, diag, diag] = (e - a_d - zoff) * 0.5
    else:
        widen = np.ones(ldim)
        widen[0] = 1.025  # s-orbitals widened (bgreen :1296-1304)
        widen[9] = 1.025
        etop = ai + 2.0 * bi * widen
        ebot = ai - 2.0 * bi * widen
        det = (e - etop[None, :]) * (e - ebot[None, :])
        zoff = np.sqrt(det.astype(np.complex128))
        q[:, diag, diag] = (e - ai[None, :] - zoff) * 0.5

    # ---- continued fraction down the chain ---------------------------
    z = np.zeros((ldim, ldim))
    np.fill_diagonal(z, 1.0)
    for l in range(lld - 2, -1, -1):
        # small-Q zeroing (bgreen :1315-1317)
        small = (np.abs(q.real) < 1e-12) & (np.abs(q.imag) < 1e-12)
        q[small] = 0.0
        p = e[:, :, None] * z[None, :, :]  # (NE, 18, 18) = E*I
        q = p - a_b[l][None, :, :] - q
        qinv = np.linalg.inv(q)
        b2z = b_b[l]
        q = b2z.conj().T @ qinv @ b2z
    return q.transpose(1, 2, 0)  # (18, 18, NE)
