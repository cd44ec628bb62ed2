"""Batched scalar (Haydock) Lanczos recursion on the block-ELL Hamiltonian.

Port of ``rslmtoasa_tpu/ops/lanczos.py`` (reference ``source/recursion.f90``
``recur`` :3485, ``crecal`` :3423, ``hop`` :3310) in complex128 PyTorch:

* the per-(atom, orbital) chain loop is the last axis of ``psi``
  (``C`` chains, ``c = atom * 9 + orbital``);
* the recursion-depth loop is a Python loop of ``lld - 1`` steps, each
  one SpMV+dot kernel and one :func:`~.haydock_kernels.update_norm`, with
  the normalisation deferred: the chain is kept unnormalised, ``u_n = b_n
  psi_n`` (``b_0 = 1``, ``u_{-1} = 0``), so that

      u_{n+1} = y_n / b_n - (a_n / b_n) u_n - (b_n / b_{n-1}) u_{n-1},
      y_n = H u_n,  a_n = Re<u_n|y_n> / b_n^2,  b_{n+1}^2 = |u_{n+1}|^2,

  and K3' writes ``u_{n+1}`` over ``u_{n-1}``, ``a[n]`` and ``b2[n+1]``
  in one launch: two vectors of kk + 1 rows (row kk zero) and ``y``, and
  no pass after the update.  The SpMVs are linear, so they run unchanged
  on ``u_n``.  Two engines, chosen as the JAX package's
  ``lanczos_coefficients_flat_df64`` chooses its Pallas kernels
  (``roll``, default from ``RSLMTO_ROLL``): K1'
  :func:`~.haydock_kernels.spmv_dot`, whose row-block partials are folded
  here into the raw dot, or K2'
  :func:`~.haydock_kernels.spmv_dot_pipelined`, which returns it finished;
* missing neighbours use the sentinel column ``kk``; ``psi`` carries one
  extra zero row so gathers need no masking.

Layouts match the JAX package: ``hs (ntype, nslots, 9, 9)``, ``iz (kk,)``,
``cols (kk, nslots)``, ``psi (kk+1, 9, C)``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import haydock_kernels as hk
from .haydock_kernels import block_spmv  # noqa: F401  (re-export)


def as_table(a, dtype) -> torch.Tensor:
    """A host array or a tensor (left on its device) as a contiguous
    ``dtype`` tensor."""
    if not torch.is_tensor(a):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, dtype=dtype).contiguous()


class HaydockOperator(nn.Module):
    """The ELL Hamiltonian of one spin channel as device buffers, so that
    ``.to(device)`` moves the tables."""

    def __init__(self, hs, iz, cols):
        super().__init__()
        self.register_buffer("hs", as_table(hs, torch.complex128))
        self.register_buffer("iz", as_table(iz, torch.int32))
        self.register_buffer("cols", as_table(cols, torch.int32))

    @property
    def kk(self) -> int:
        return self.cols.shape[0]

    def forward(self, psi: torch.Tensor) -> torch.Tensor:
        return block_spmv(self.hs, self.iz, self.cols, psi)

    def coefficients(self, psi0: torch.Tensor, lld: int,
                     plain: bool = False, roll: Optional[bool] = None,
                     stages=None):
        return lanczos_coefficients(self.hs, self.iz, self.cols, psi0, lld,
                                    plain=plain, roll=roll, stages=stages)


def roll_selected(roll: Optional[bool] = None) -> bool:
    """Whether the recursion runs K2' (``roll``): ``roll=None`` reads
    ``RSLMTO_ROLL`` as ``pallas_conv.lanczos_coefficients_flat_df64`` of
    the JAX package does (any non-empty value selects it)."""
    if roll is None:
        return bool(os.environ.get("RSLMTO_ROLL"))
    return bool(roll)


def _folded(spmv_dot):
    """The contract of K1' turned into that of K2': the row-block
    partials summed into the chain's raw dot ``Re<u|y>``."""
    def step(hs, iz, cols, psi):
        v, apart = spmv_dot(hs, iz, cols, psi)
        return v, apart.sum(0)
    return step


def lanczos_coefficients(
    hs: torch.Tensor,
    iz: torch.Tensor,
    cols: torch.Tensor,
    psi0: torch.Tensor,
    lld: int,
    plain: bool = False,
    roll: Optional[bool] = None,
    stages: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``lld`` Haydock recursion steps for a batch of start vectors.

    ``psi0`` is (kk+1, 9, C) with unit start vectors in the chain columns
    (row kk must be zero).  Returns ``(a, b2)`` of shape (lld, C) float64
    on ``psi0``'s device, with the reference's conventions ``b2[0] = 1``,
    ``a[lld-1] = 0`` and ``b2[lld-1] = |r|^2`` of the last residual
    (``crecal`` :3423-3483).  ``a`` and ``b2`` use ``Re<.|.>`` only.

    The kernels are reached through the device dispatch of
    :mod:`.haydock_kernels`; ``plain=True`` runs the plain versions on any
    device (the reference a card run is checked against).  ``roll``
    picks the SpMV engine (:func:`roll_selected`): K2' on ``True``, K1'
    on ``False``, ``RSLMTO_ROLL`` on ``None``.

    ``stages`` ``((n, steps), ...)`` runs the steps on row prefixes: each
    stage's SpMVs on the first n rows (:func:`~.haydock_kernels.
    prefix_tables`), the vectors grown by zero rows between stages (the
    active-set wavefront, :mod:`.wavefront`); ``psi0`` then holds the first
    stage's n + 1 rows.  By default one stage of all kk rows.
    """
    if roll_selected(roll):
        spmv_dot = (hk.spmv_dot_pipelined_ref if plain
                    else hk.spmv_dot_pipelined)
    else:
        spmv_dot = _folded(hk.spmv_dot_ref if plain else hk.spmv_dot)
    update_norm = hk.update_norm_ref if plain else hk.update_norm
    kk1, _, c = psi0.shape
    dev = psi0.device
    stages = check_stages(stages, cols.shape[0], kk1 - 1, lld - 1)
    u = psi0.clone()  # u_n
    w = torch.zeros_like(psi0)  # u_{n-1}, overwritten by u_{n+1}
    a = torch.zeros((lld, c), dtype=torch.float64, device=dev)
    b2 = torch.zeros((lld, c), dtype=torch.float64, device=dev)
    b2[0] = 1.0
    ll = 0
    for kk, steps in stages:
        iz_n, cols_n = hk.prefix_tables(iz, cols, kk)
        u, w = grow_rows(u, kk + 1), grow_rows(w, kk + 1)
        for _ in range(steps):
            y, r = spmv_dot(hs, iz_n, cols_n, u)
            update_norm((r, b2[ll], b2[max(ll - 1, 0)]), y, u, w,
                        b2[ll + 1], a[ll])
            u, w = w, u
            ll += 1
    return a, b2


def grow_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def check_stages(stages, kk: int, n0: int, nsteps: int):
    """``stages`` ((n, steps), ...) of a recursion of ``nsteps`` steps on
    ``kk`` rows whose start vectors hold ``n0`` rows (one stage of all of
    them when None): growing prefixes up to kk, the first of n0 rows."""
    if stages is None:
        stages = ((kk, nsteps),)
    ns = [n for n, _ in stages]
    if (ns[0] != n0 or ns != sorted(ns) or ns[-1] > kk
            or sum(s for _, s in stages) != nsteps):
        raise ValueError(f"stages {list(stages)}: want growing prefixes "
                         f"from the start vectors' {n0} rows up to kk={kk} "
                         f"and {nsteps} steps in all")
    return stages


def scalar_start_vectors(kk: int, atom_indices: Sequence[int],
                         device: torch.device) -> torch.Tensor:
    """Unit start vectors for the scalar recursion: one chain per
    (atom, orbital) pair; orbital runs fastest (matches ``recur``'s l-loop).

    Returns (kk+1, 9, C) complex128 on ``device`` with C = 9 *
    len(atom_indices), laid out as chain ``c = a * 9 + l`` for atom ``a``,
    orbital ``l``.
    """
    n = len(atom_indices)
    psi0 = torch.zeros((kk + 1, 9, 9 * n), dtype=torch.complex128,
                       device=device)
    rows = torch.as_tensor(np.repeat(np.asarray(atom_indices), 9),
                           device=device)
    orb = torch.arange(9, device=device).repeat(n)
    psi0[rows, orb, torch.arange(9 * n, device=device)] = 1.0
    return psi0
