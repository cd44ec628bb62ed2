"""Chebyshev/KPM block-moment recursion and Green-function reconstruction.

Port of ``rslmtoasa_tpu/ops/chebyshev.py`` (reference ``recursion.f90``
``chebyshev_recur`` :3057-3135, double-pass moment trick mu_{2n+1} =
2<phi_n|phi_n> - mu_1, mu_{2n+2} = 2<phi_{n+1}|phi_n> - mu_2;
``green.f90 chebyshev_green`` :1030-1115).  ``H psi`` is the block
recursion's operator (:class:`~.block_lanczos.BlockOperator`, kernel K4);
the scaling ``H~ = (H - b)/a`` with a = (emax - emin)/(2 - 0.3),
b = (emax + emin)/2, the three-term update and the Grams are torch ops on
``psi``'s device.  The Green function is torch on the device its caller
names, batched over the rec atoms.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .block_lanczos import BlockOperator, gram_sum, pad_row
from .lanczos import check_stages, grow_rows


def chebyshev_moments(op: BlockOperator, psi0: torch.Tensor, lld: int,
                      a: float, b: float, plain: bool = False,
                      stages: Optional[Sequence[Tuple[int, int]]] = None
                      ) -> torch.Tensor:
    """Block Chebyshev moments mu_n of shape (2 lld + 2, R, d, d) from
    ``psi0`` (kk+1, d, R d), on ``op``'s device; ``plain=True`` runs the
    plain versions.  ``stages`` ``((n, steps), ...)`` runs the lld + 1
    H applications, the first the pre-step ``p1 = H~ p0``, on row prefixes
    of ``op`` as :func:`~.block_lanczos.block_lanczos` does."""
    p0, p1 = psi0, None
    mu = []
    for kk, steps in check_stages(stages, op.kk, psi0.shape[0] - 1, lld + 1):
        op_n = op.prefix(kk)

        def apply_h(psi):
            """(H psi - b psi) / a."""
            hpsi, _ = op_n(psi, plain=plain)
            return (hpsi - b * psi[:kk]) / a

        p0 = grow_rows(p0, kk + 1)
        p1 = None if p1 is None else grow_rows(p1, kk + 1)
        for _ in range(steps):
            if p1 is None:  # the pre-step
                mu0 = gram_sum(p0[:kk].conj(), p0[:kk])
                p1 = pad_row(apply_h(p0))
                mu1 = gram_sum(p0[:kk].conj(), p1[:kk])
                mu += [mu0, mu1]
                continue
            p2 = 2.0 * apply_h(p1) - p0[:kk]
            d1 = gram_sum(p1[:kk].conj(), p1[:kk])
            d2 = gram_sum(p2.conj(), p1[:kk])
            mu += [2.0 * d1 - mu0, 2.0 * d2 - mu1]
            p0, p1 = p1, pad_row(p2)
    return torch.stack(mu)


def jackson_kernel(n: int) -> np.ndarray:
    """Jackson kernel of order n (math.f90 ``jackson_kernel`` :1641-1661)."""
    ll = np.arange(1, n + 1, dtype=np.float64)
    theta = np.pi * (ll - 1) / (n + 1)
    k = (n - (ll - 1) + 1) * np.cos(theta) \
        + np.sin(theta) / np.tan(np.pi / (n + 1))
    return k / (n + 1)


def lorentz_kernel(n: int, lam: float = 4.0) -> np.ndarray:
    """Lorentz kernel (math.f90 :1663-1677)."""
    ll = np.arange(1, n + 1, dtype=np.float64)
    theta = lam * (1.0 - (ll - 1) / n)
    return np.sinh(theta) / np.sinh(lam)


def chebyshev_green(mu: np.ndarray, ene: np.ndarray, emin: float,
                    emax: float, device, host: bool = True):
    """Green functions of R chains (the rec atoms, or an exchange run's
    pair chains) from block moments, computed on ``device`` (``green.f90
    chebyshev_green`` :1030-1115).

    mu: (nmom, R, 18, 18); returns g0 (R, 18, 18, NE) complex128 on the
    host, or with ``host=False`` the tensor on ``device``.
    """
    dev = torch.device(device)
    nmom = mu.shape[0]
    a = (emax - emin) / (2.0 - 0.3)
    b = (emax + emin) / 2.0
    e = torch.as_tensor(np.ascontiguousarray(ene), dtype=torch.float64,
                        device=dev)
    kern = torch.as_tensor(jackson_kernel(nmom), device=dev)
    mu_ng = torch.as_tensor(np.ascontiguousarray(mu), dtype=torch.complex128,
                            device=dev) * kern[:, None, None, None]
    mu_ng[1:] *= 2.0
    n_idx = torch.arange(nmom, dtype=torch.float64, device=dev)
    # exp factor: -i exp(-i n arccos(w)), (NE, nmom)
    acw = torch.arccos(torch.clamp((e - b) / a, -1.0, 1.0))
    # the reference computes arccos without clipping; |w| stays < 1 by the
    # (2 - 0.3) scaling margin, so the clip is inert on valid meshes
    expf = -1j * torch.exp(-1j * n_idx[None, :] * acw[:, None])
    g0 = torch.einsum("en,nrab->rabe", expf, mu_ng)
    g0 = g0 / torch.sqrt(a**2 - (e - b) ** 2)
    return g0.cpu().numpy() if host else g0
