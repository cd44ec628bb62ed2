"""Frozen copy of the block Green functions and their terminators
(``rslmtoasa_tpu_torch/physics/greens.py`` ``get_terminf``, ``bgreen``;
``ops/block_lanczos.py`` ``zsqr``; ``ops/chebyshev.py`` ``jackson_kernel``,
``chebyshev_green``).

The one departure from the copies: ``bgreen`` and ``chebyshev_green`` take
the complex dtype they compute in (``cdtype``), so that the benchmark's
control can run them a precision below the configuration's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.terminator import bpopt_batch


def zsqr(b2_b: np.ndarray) -> np.ndarray:
    """Replace every B^2 block by its Hermitian square root
    (``zsqr`` :1980-2028).  b2_b: (lld, R, 18, 18), NumPy."""
    ev, u = np.linalg.eigh(b2_b)
    lam = np.sqrt(ev)
    return np.einsum("...ab,...b,...cb->...ac", u, lam, u.conj())


def get_terminf(a_b: np.ndarray, b_b: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Terminator coefficients for block chains.

    a_b, b_b: (lld, R, 18, 18), b_b = sqrt(B^2).  Returns (a_inf, b_inf)
    of shape (R, 18, 18).
    """
    lld, r = a_b.shape[0], a_b.shape[1]
    ldim = a_b.shape[2]
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


def bgreen(a_b, b_b, a_inf, b_inf, ene, device, sym_term: bool = False,
           cdtype=torch.complex128) -> torch.Tensor:
    """Matrix continued-fraction Green functions of R chains on ``device``:
    g0 (R, 18, 18, NE) in ``cdtype``."""
    dev = torch.device(device)
    z = cdtype
    f = torch.float64 if cdtype == torch.complex128 else torch.float32
    as_dev = lambda x, dt: torch.tensor(  # noqa: E731
        np.asarray(x), dtype=dt, device=dev)
    lld, ldim = a_b.shape[0], a_b.shape[2]
    a_b, b_b = as_dev(a_b, z), as_dev(b_b, z)
    a_inf = as_dev(a_inf, f)
    b_inf = as_dev(b_inf, f)
    e = as_dev(ene, f)[None, :, None]
    ep = e
    if sym_term:
        a_d = (0.5 * (a_inf[:, 0, 0] + a_inf[:, 9, 9]))[:, None, None]
        b_d = (0.5 * (b_inf[:, 0, 0] + b_inf[:, 9, 9]))[:, None, None]
        det = (e - (a_d + 2.0 * b_d)) * (e - (a_d - 2.0 * b_d))
        zoff = torch.sqrt(det.to(z))
        diag = ((ep - a_d - zoff) * 0.5).expand(-1, -1, ldim)
    else:
        widen = torch.ones(ldim, dtype=f, device=dev)
        widen[0] = 1.025
        widen[9] = 1.025
        ai = torch.diagonal(a_inf, dim1=-2, dim2=-1)[:, None, :]
        bi = torch.diagonal(b_inf, dim1=-2, dim2=-1)[:, None, :]
        det = (e - (ai + 2.0 * bi * widen)) * (e - (ai - 2.0 * bi * widen))
        zoff = torch.sqrt(det.to(z))
        diag = (ep - ai - zoff) * 0.5
    q = torch.diag_embed(diag)
    eye = ep[..., None] * torch.eye(ldim, dtype=f, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    for l in range(lld - 2, -1, -1):
        small = (q.real.abs() < 1e-12) & (q.imag.abs() < 1e-12)
        q = torch.where(small, 0.0, q)
        qinv, info = torch.linalg.inv_ex(eye - a_b[l][:, None] - q)
        failed |= (info != 0).any()
        b2z = b_b[l][:, None]
        q = b2z.conj().transpose(-1, -2) @ qinv @ b2z
    if bool(failed):
        raise np.linalg.LinAlgError("bgreen: a continued-fraction level is "
                                    "singular")
    return q.permute(0, 2, 3, 1)


def jackson_kernel(n: int) -> np.ndarray:
    """Jackson kernel of order n (math.f90 ``jackson_kernel`` :1641-1661)."""
    ll = np.arange(1, n + 1, dtype=np.float64)
    theta = np.pi * (ll - 1) / (n + 1)
    k = (n - (ll - 1) + 1) * np.cos(theta) \
        + np.sin(theta) / np.tan(np.pi / (n + 1))
    return k / (n + 1)


def chebyshev_green(mu, ene, emin: float, emax: float, device,
                    cdtype=torch.complex128) -> torch.Tensor:
    """Green functions of R chains from block moments mu (nmom, R, 18, 18)
    on ``device``: g0 (R, 18, 18, NE) in ``cdtype``."""
    dev = torch.device(device)
    f = torch.float64 if cdtype == torch.complex128 else torch.float32
    nmom = mu.shape[0]
    a = (emax - emin) / (2.0 - 0.3)
    b = (emax + emin) / 2.0
    e = torch.as_tensor(np.ascontiguousarray(ene), dtype=f, device=dev)
    kern = torch.as_tensor(jackson_kernel(nmom), dtype=f, device=dev)
    mu_ng = torch.as_tensor(np.ascontiguousarray(mu), dtype=cdtype,
                            device=dev) * kern[:, None, None, None]
    mu_ng[1:] *= 2.0
    n_idx = torch.arange(nmom, dtype=f, device=dev)
    acw = torch.arccos(torch.clamp((e - b) / a, -1.0, 1.0))
    expf = -1j * torch.exp(-1j * n_idx[None, :] * acw[:, None])
    g0 = torch.einsum("en,nrab->rabe", expf.to(cdtype), mu_ng)
    return g0 / torch.sqrt(a**2 - (e - b) ** 2)
