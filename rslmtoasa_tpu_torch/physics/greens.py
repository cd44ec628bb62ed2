"""Block Green's functions: terminators + matrix continued fraction.

Implements the block path of ``source/green.f90``:

* :func:`get_terminf` — per-(orbital,orbital) Pettifor terminator fits on
  the block-coefficient chains with the reference's NaN/zero guards and
  s-orbital 1.01 widening (``recursion.f90 get_terminf`` :2092-2137 +
  ``get_cinf`` :2030-2092),
* :func:`bgreen` — per-energy matrix continued fraction with the
  orbital-dependent square-root terminator (``green.f90 bgreen``
  :1191-1339): a chain of 18x18 inversions, each level one batched torch
  inverse over all rec atoms and energies on the recursion's device.

The terminator fits run where their inputs live: on tensors of the
recursion's card one kernel launch fits every chain (``ops/terminator.py
bpopt_fit``), bit for bit the NumPy fits that NumPy arrays and CPU
tensors take.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.terminator import bpopt_fit


def get_terminf(a_b, b_b) -> Tuple[np.ndarray, np.ndarray]:
    """Terminator coefficients for block chains.

    a_b, b_b: (lld, R, 18, 18) NumPy arrays or tensors, complex or real
    (the fits read the real parts) — b_b must already hold B = sqrt(B^2)
    (i.e. after :func:`~rslmtoasa_tpu_torch.ops.block_lanczos.zsqr`).
    The fits run on the inputs' device (:func:`bpopt_fit`: one launch on
    the card, NumPy on the host).  Returns (a_inf, b_inf) of shape
    (R, 18, 18), host NumPy.
    """
    lld, r, ldim = a_b.shape[:3]

    def chains(x):  # (R*18*18, lld) over the real parts
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))  # a copy: x may be read-only
        return x.real.permute(1, 2, 3, 0).reshape(-1, lld).to(
            torch.float64).contiguous()

    fit, _ = bpopt_fit(chains(a_b), chains(b_b), lld - 1, ldim)
    fit = fit.view(2, r, ldim, ldim).cpu().numpy()
    return fit[0], fit[1]


def bgreen(a_b: np.ndarray, b_b: np.ndarray, a_inf: np.ndarray,
           b_inf: np.ndarray, ene: np.ndarray, device,
           sym_term: bool = False, eta=None, host: bool = True):
    """Matrix continued-fraction Green functions of R chains (the rec
    atoms, or an exchange run's pair chains), computed on ``device``.

    a_b, b_b: (lld, R, 18, 18) block coefficients (b_b = sqrt(B^2));
    a_inf/b_inf: (R, 18, 18) terminators; ene: (NE,).  The inputs go to
    ``device`` once; each level of the fraction is one batched inverse over
    (R, NE), its ``info`` checked once after the loop.

    ``eta``, a scalar or one value per energy, shifts E in the continued
    fraction (``p = (E + eta) I``) and in the terminator's diagonal, while
    the terminator's square root stays at the real E (the imaginary-axis
    path of ``block_green_ij_eta``, as the JAX package's ``bgreen``).
    Returns g0 (R, 18, 18, NE) complex128 on the host, or with
    ``host=False`` the tensor on ``device``.
    """
    dev = torch.device(device)
    z = torch.complex128
    as_dev = lambda x, dt: torch.tensor(  # noqa: E731
        np.asarray(x), dtype=dt, device=dev)
    lld, ldim = a_b.shape[0], a_b.shape[2]
    a_b, b_b = as_dev(a_b, z), as_dev(b_b, z)
    a_inf = as_dev(a_inf, torch.float64)
    b_inf = as_dev(b_inf, torch.float64)
    e = as_dev(ene, torch.float64)[None, :, None]  # (1, NE, 1)
    # E + eta where the fraction and the terminator's diagonal take it
    ep = e if eta is None else e + as_dev(
        np.broadcast_to(eta, np.shape(ene)), z)[None, :, None]

    # ---- terminator initialisation (orbital-diagonal) ----------------
    if sym_term:
        a_d = (0.5 * (a_inf[:, 0, 0] + a_inf[:, 9, 9]))[:, None, None]
        b_d = (0.5 * (b_inf[:, 0, 0] + b_inf[:, 9, 9]))[:, None, None]
        det = (e - (a_d + 2.0 * b_d)) * (e - (a_d - 2.0 * b_d))
        zoff = torch.sqrt(det.to(z))
        diag = ((ep - a_d - zoff) * 0.5).expand(-1, -1, ldim)
    else:
        widen = torch.ones(ldim, dtype=torch.float64, device=dev)
        widen[0] = 1.025  # s-orbitals widened (bgreen :1296-1304)
        widen[9] = 1.025
        # (R, 1, 18)
        ai = torch.diagonal(a_inf, dim1=-2, dim2=-1)[:, None, :]
        bi = torch.diagonal(b_inf, dim1=-2, dim2=-1)[:, None, :]
        det = (e - (ai + 2.0 * bi * widen)) * (e - (ai - 2.0 * bi * widen))
        zoff = torch.sqrt(det.to(z))
        diag = (ep - ai - zoff) * 0.5
    q = torch.diag_embed(diag)  # (R, NE, 18, 18)

    # ---- continued fraction down the chain ---------------------------
    eye = ep[..., None] * torch.eye(ldim, dtype=torch.float64, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    for l in range(lld - 2, -1, -1):
        # small-Q zeroing (bgreen :1315-1317)
        small = (q.real.abs() < 1e-12) & (q.imag.abs() < 1e-12)
        q = torch.where(small, 0.0, q)
        qinv, info = torch.linalg.inv_ex(eye - a_b[l][:, None] - q)
        failed |= (info != 0).any()
        b2z = b_b[l][:, None]
        q = b2z.conj().transpose(-1, -2) @ qinv @ b2z
    if bool(failed):
        raise np.linalg.LinAlgError("bgreen: a continued-fraction level is "
                                    "singular")
    g0 = q.permute(0, 2, 3, 1)  # (R, 18, 18, NE)
    return g0.cpu().numpy() if host else g0
