"""Two-sided Chebyshev moments of the Kubo-Bastin conductivity.

Port of ``rslmtoasa_tpu/ops/kubo.py`` (``kubo_moments`` :71-165; reference
``recursion.f90 compute_moments_stochastic`` :979-1234):

    mu[n, m] = sum_k (T_m(H~)|r>)[k]^H (v_a T_n(H~) v_b |r>)[k]

for R start blocks side by side, ``psi0`` in the block recursion's layout
``(kk+1, 18, 18 R)``.  Every application of H and of a velocity table is
K4 (:func:`~.block_kernels.block_step`): ``H~ psi = (H psi - b psi) / a``
through :class:`~.block_lanczos.BlockOperator`, and ``v psi`` through
:class:`VelocityOperator`, which holds the tables as buffers.  With HoH
(``ham_hoh_vec_matmul`` / ``velo_hoh_vec_matmul``) H is the operator's two
launches and a velocity application ``v psi - vo (hs psi)``; the right
chain computes ``hs psi`` of each vector once, for its velocity and for
the next H application (the same product, so the same bits).

The left chain is stored in blocks of ``block_size`` vectors (non-HoH
``v_a T_m|r>``, v_a being Hermitian; HoH the raw ``T_m|r>``), and the right
chain is replayed once per left block, as the JAX package's scan does.
The contraction is a batched ``torch.matmul`` over the start blocks: the
stored block, conjugated and laid out ``(R, block_size 18, kk 18)``, times
``group`` right vectors at once ``(R, kk 18, group 18)``, so that each read
of the store serves ``group`` right vectors.  The JAX package computes it
as an einsum outside any Pallas kernel.  :func:`plan` sizes the store and
the groups of start blocks from the memory the device has free.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import block_kernels as bk
from .block_lanczos import BlockOperator, pad_row
from .haydock_kernels import GATHER_BYTES

GROUP = 16  # right vectors per contraction
CPU_BUDGET = 4 << 30  # bytes for the store and the chains on the CPU
# vectors of the chains and their temporaries beside the store and the
# right group, and the share of free device memory left unplanned
WORK_VECS = 12
MARGIN = 0.1


class VelocityOperator(nn.Module):
    """A Kubo operator table ``v`` (ELL, on the Hamiltonian's ``iz`` and
    ``cols``) as device buffers, and with HoH its overlap image ``vo``:
    ``v psi`` is one K4 launch; with ``vo``, ``v psi - vo (hs psi)`` is two,
    given ``hs psi`` (:meth:`BlockOperator.hs_apply`)."""

    def __init__(self, v, iz, cols, vo=None):
        super().__init__()
        as_c = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=torch.complex128)
        as_i = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=torch.int32)
        self.register_buffer("v", as_c(v))
        self.register_buffer("iz", as_i(iz))
        self.register_buffer("cols", as_i(cols))
        if vo is None:
            self.vo_neg = None
        else:
            self.register_buffer("vo_neg", as_c(-np.asarray(vo)))

    def forward(self, psi: torch.Tensor, hpsi: Optional[torch.Tensor] = None,
                pad: bool = False, plain: bool = False) -> torch.Tensor:
        """``v psi``, or with ``vo`` ``v psi - vo hpsi``: (kk + pad, d, C)."""
        step = bk.block_step_ref if plain else bk.block_step
        if self.vo_neg is None:
            return step(self.v, self.iz, self.cols, psi, pad=pad)[0]
        vpsi, _ = step(self.v, self.iz, self.cols, psi)
        return step(self.vo_neg, self.iz, self.cols, hpsi, add=vpsi,
                    pad=pad)[0]


def _next(op: BlockOperator, w1, w0, a: float, b: float, plain: bool,
          hpsi=None) -> torch.Tensor:
    """``T_{m+1}|r>`` from ``w1 = T_m|r>`` and ``w0 = T_{m-1}|r>`` (None
    for m = 0), padded: ``H~ w1``, or ``2 H~ w1 - w0``."""
    kk = w1.shape[0] - 1
    h, _ = op(w1, plain=plain, hpsi=hpsi)
    t = (h - b * w1[:kk]) / a
    return pad_row(t if w0 is None else 2.0 * t - w0[:kk])


def kubo_moments(op: BlockOperator, va: VelocityOperator,
                 vb: VelocityOperator, psi0: torch.Tensor, n_moments: int,
                 a: float, b: float, block_size: int, group: int = GROUP,
                 plain: bool = False) -> torch.Tensor:
    """mu (R, n, m, 18, 18) of the R start blocks of ``psi0`` (kk+1, 18,
    18 R) on its device: ``mu[r, n, m] = sum_k L_m[k]^H R_n[k]`` in the
    JAX package's convention.  ``op.hoh`` selects the HoH chains (then
    ``va`` and ``vb`` carry their ``vo``).  ``plain=True`` runs the plain
    versions of K4."""
    kk, d, c = psi0.shape[0] - 1, psi0.shape[1], psi0.shape[2]
    r, n_mom = c // d, n_moments
    hoh = op.hoh
    dev, z = psi0.device, psi0.dtype
    mb_max = min(block_size, n_mom)
    g_max = min(group, n_mom)
    mu = torch.empty((r, n_mom, n_mom, d, d), dtype=z, device=dev)
    # per start block: the conjugated left block, row (m, a) and column
    # (k, b), and the right group, row (k, b) and column (n, c)
    store = torch.empty((r, mb_max * d, kk * d), dtype=z, device=dev)
    right = torch.empty((r, kk * d, g_max * d), dtype=z, device=dev)
    store_v = store.view(r, mb_max, d, kk, d)
    right_v = right.view(r, kk, d, g_max, d)

    def velocity(vop, x, pad=False):
        """(v x, hs x or None): with HoH also the hs x it needed."""
        if not hoh:
            return vop(x, pad=pad, plain=plain), None
        hx = op.hs_apply(x, plain)
        return vop(x, hpsi=hx, pad=pad, plain=plain), hx

    w0 = w1 = None
    for m0 in range(0, n_mom, mb_max):
        mb = min(mb_max, n_mom - m0)
        for i in range(mb):
            w = psi0 if m0 + i == 0 else _next(op, w1, w0, a, b, plain)
            w0, w1 = w1, w
            left = w[:kk] if hoh else velocity(va, w)[0]
            store_v[:, i].copy_(left.view(kk, d, r, d).permute(2, 3, 0, 1)
                                .conj())
        # the right chain, replayed against this block
        v0, hv = None, None
        v1, _ = velocity(vb, psi0, pad=True)
        for n in range(n_mom):
            if n > 0:
                v0, v1 = v1, _next(op, v1, v0, a, b, plain, hpsi=hv)
            if hoh:
                rvec, hv = velocity(va, v1)
            else:
                rvec = v1[:kk]
            g = n % g_max
            right_v[:, :, :, g].copy_(rvec.view(kk, d, r, d).permute(
                2, 0, 1, 3))
            if g == g_max - 1 or n == n_mom - 1:
                ng = g + 1
                blk = torch.matmul(store[:, :mb * d], right[:, :, :ng * d])
                mu[:, n - g:n + 1, m0:m0 + mb] = blk.view(
                    r, mb, d, ng, d).permute(0, 3, 1, 2, 4)
    return mu


def launches(n_moments: int, block_size: int, hoh: bool) -> int:
    """K4 launches of one :func:`kubo_moments` call.  Without HoH: the
    left chain's n - 1 H applications and n velocities, and per left block
    the right chain's v_b and n - 1 H applications, one launch each.  With
    HoH: two launches per left H application; per left block three for
    v_b, three for each of the right chain's n velocities (its hs among
    them) and one for each of its n - 1 H applications, which reuse that
    hs."""
    n = n_moments
    nblocks = -(-n // min(block_size, n))
    if not hoh:
        return (n - 1) + n + nblocks * (1 + (n - 1))
    return 2 * (n - 1) + nblocks * (3 + 3 * n + (n - 1))


def plan(kk: int, n_units: int, n_moments: int, device: torch.device,
         plain: bool = False, group: int = GROUP) -> Tuple[int, int]:
    """(start blocks per group, block_size) for ``n_units`` start blocks on
    ``device``: the most start blocks side by side whose whole left chain
    (``n_moments`` vectors) fits beside the chains, else one at a time with
    the largest store that fits.  The memory is the device's free memory
    (with what torch's allocator holds unused) less a margin, or
    :data:`CPU_BUDGET` on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        budget = int(free * (1.0 - MARGIN))
    else:
        budget = CPU_BUDGET
    unit = (kk + 1) * 18 * 18 * 16  # bytes of one start block's vector
    extra = GATHER_BYTES if plain else 0  # the plain K4's gather

    def fits(r):
        per_vec = r * unit
        spare = budget - extra - (WORK_VECS + min(group, n_moments)) * per_vec
        return spare // per_vec

    for r in range(n_units, 0, -1):
        if fits(r) >= n_moments:
            return r, n_moments
    if fits(1) < 1:
        raise MemoryError(f"Kubo moments: one start block's chains at "
                          f"kk={kk} do not fit {budget} bytes")
    return 1, int(fits(1))
