"""Row slabs of the ELL tables with a halo: the recursions of a cluster
larger than one card, split over ranks.

The port's counterpart of ``rslmtoasa_tpu/ops/msconv_shard.py``
(``block_lanczos_ms_sharded`` :414, ``chebyshev_moments_ms_sharded`` :476)
and of the row-sharded functions of ``rslmtoasa_tpu/parallel/mesh.py``.
On the TPU the cell grid is cut into x-slabs whose stencil taps cross into
the neighbours' planes, with gather-correction tables for surface layers
and an impurity's ``hall`` rows.  The port keeps the ELL layout, in which
layers and local rows are just more rows, so a slab is a contiguous range
of rows of the tables:

* **The plan** (:class:`SlabPlan`): slab boundaries on multiples of
  :data:`TILE` rows, a whole number of the kernels' row tiles
  (``haydock_kernels.ROWS_PER_BLOCK``, ``block_kernels.rows_per_tile``),
  and each slab's halo, the rows outside it that its columns reach.
* **The local tables** (:class:`Slab`): own rows first, then the halo
  rows, then the zero sentinel row ``nx``; ``cols`` renumbered into them.
  K1'/K3' and K4 compute the own rows and read all ``nx + 1``.
* **The exchange** (:meth:`Slab.exchange`): before each application of H
  each rank sends each neighbour the rows of its slab that the neighbour's
  columns reach (``isend``/``irecv``); with HoH, H reaches two hops, and
  ``hs psi`` is exchanged again before the second K4 launch (the halo is
  not widened).
* **The reductions**: Gram, dot and norm partials cover own rows only and
  are combined over the ranks in rank order (:meth:`.Mesh.sum_in_order`);
  the scalar recursion gathers K1'/K3''s row-block partials in the global
  order, which gives the single rank's ``a`` and ``b2`` bit for bit where
  its SpMV rows are.  ``eig_sqrt`` and the products of the recursion's
  coefficients run replicated, so every rank holds the same results.

An impurity's per-atom rows (``nmax`` of them) lead the table, so in every
slab that holds some of them they lead its own rows: :meth:`Slab.nmax`
gives that count, and only such a slab (the first, unless the zone spans
slab boundaries) takes K4's ``zone`` route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import haydock_kernels as hk
from .block_lanczos import BlockOperator, block_times, eig_sqrt, gram_sum
from .lanczos import as_table, roll_selected

TILE = 32  # rows: hk.ROWS_PER_BLOCK and a multiple of rows_per_tile(9, 18)


def host(x) -> np.ndarray:
    """``x`` (a host array or a tensor) as a host array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SlabPlan:
    """Slab boundaries and halos of a row table ``cols`` (kk, nslots)
    (sentinel columns >= kk) over ``world`` ranks: rank r owns the rows
    ``bounds[r]:bounds[r + 1]``, cut on multiples of ``tile`` as near
    ``r kk / world`` as they fall, and ``halos[r]`` (sorted) are the rows
    of other slabs that its columns reach."""

    def __init__(self, cols, world: int, tile: int = TILE):
        cols = host(cols)
        kk = cols.shape[0]
        cuts = [min(kk, int(round(kk * r / world / tile)) * tile)
                for r in range(world)] + [kk]
        if any(b <= a for a, b in zip(cuts, cuts[1:])):
            raise ValueError(f"{kk} rows do not make {world} slabs of "
                             f"whole {tile}-row tiles")
        self.kk, self.world, self.bounds = kk, world, cuts
        self.halos = []
        for r in range(world):
            lo, hi = cuts[r], cuts[r + 1]
            c = cols[lo:hi].ravel()
            self.halos.append(np.unique(c[(c < kk) & ((c < lo) | (c >= hi))]))

    def sizes(self):
        """Rows of each slab."""
        return [b - a for a, b in zip(self.bounds, self.bounds[1:])]


class Slab:
    """This rank's slab of the tables: the local ``cols`` (own rows, halo
    rows, sentinel ``nx``), the rows each neighbour sends and receives, and
    the exchange.  ``exchanges`` counts the halo exchanges made."""

    def __init__(self, mesh, cols, device, plan: Optional[SlabPlan] = None):
        cols = host(cols)
        self.mesh, self.device = mesh, torch.device(device)
        self.plan = plan or SlabPlan(cols, mesh.world)
        r, kk = mesh.rank, self.plan.kk
        lo, hi = self.plan.bounds[r], self.plan.bounds[r + 1]
        halo = self.plan.halos[r]
        self.lo, self.hi, self.n_own = lo, hi, hi - lo
        self.nx = self.n_own + halo.size
        c = cols[lo:hi]
        own = (c >= lo) & (c < hi)
        far = (c < kk) & ~own
        loc = np.full(c.shape, self.nx, np.int32)
        loc[own] = c[own] - lo
        loc[far] = self.n_own + np.searchsorted(halo, c[far])
        self.cols = torch.as_tensor(loc, device=self.device)
        self.sends, self.recvs = {}, {}
        for s in range(mesh.world):
            if s == r:
                continue
            want = self.plan.halos[s]
            mine = want[(want >= lo) & (want < hi)]
            if mine.size:
                self.sends[s] = torch.as_tensor(mine - lo,
                                                device=self.device)
            a, b = np.searchsorted(halo, self.plan.bounds[s:s + 2])
            if b > a:
                self.recvs[s] = (self.n_own + int(a), self.n_own + int(b))
        self.exchanges = 0

    def rows(self, table, dtype=torch.int32) -> torch.Tensor:
        """The own rows of a per-row table (``iz``, ``iz_onsite``) on the
        slab's device."""
        if torch.is_tensor(table):
            return table[self.lo:self.hi].to(self.device, dtype).contiguous()
        return as_table(np.asarray(table)[self.lo:self.hi],
                        dtype).to(self.device)

    def nmax(self, nmax: int) -> int:
        """The per-atom rows (an impurity's local zone) that lead this
        slab's own rows: those of the first ``nmax`` table rows it owns."""
        return max(0, min(nmax, self.hi) - self.lo)

    def extend(self, own: torch.Tensor) -> torch.Tensor:
        """(n_own, ...) -> (nx + 1, ...): the own rows, zero halo rows (to
        be filled by :meth:`exchange`) and the zero sentinel row."""
        out = own.new_zeros((self.nx + 1,) + own.shape[1:])
        out[:self.n_own] = own
        return out

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Fill the halo rows of ``x`` (nx + 1, ...) in place from the
        neighbours' own rows, and send them the rows they need."""
        sends = {s: x[idx] for s, idx in self.sends.items()}
        recvs = {s: ((b - a,) + x.shape[1:], x)
                 for s, (a, b) in self.recvs.items()}
        got = self.mesh.exchange(sends, recvs)
        for s, (a, b) in self.recvs.items():
            x[a:b] = got[s]
        self.exchanges += 1
        return x


# ----------------------------------------------------------------------
# the block recursions on slabs
def slab_operator(slab: Slab, hs, lsham, iz, *, hoh: bool = False, hso=None,
                  enim=None, iz_onsite=None, nmax: int = 0) -> BlockOperator:
    """The block recursion's operator on ``slab``: the replicated type and
    onsite tables, the slab's own rows of ``iz`` and ``iz_onsite`` and its
    local ``cols``, and the local zone's rows that lead it."""
    izo = iz if iz_onsite is None else iz_onsite
    return BlockOperator(hs, slab.rows(iz), slab.cols, lsham,
                         iz_onsite=slab.rows(izo), hoh=hoh, hso=hso,
                         enim=enim, nmax=slab.nmax(nmax)).to(slab.device)


def _apply(slab: Slab, op: BlockOperator, x: torch.Tensor, gram: bool,
           plain: bool):
    """``H x`` on the slab's own rows (and the Gram partials): the halo of
    ``x`` exchanged first, and with HoH the halo of ``hs x`` before the
    second K4 launch."""
    slab.exchange(x)
    hx = None
    if op.hoh:
        hx = slab.extend(op.hs_apply(x, plain)[:slab.n_own])
        slab.exchange(hx)
    return op(x, gram=gram, plain=plain, hpsi=hx)


def block_lanczos_rowsharded(mesh, hs, lsham, iz, cols, psi0: torch.Tensor,
                             lld: int, *, hoh: bool = False, hso=None,
                             enim=None, iz_onsite=None, nmax: int = 0,
                             plain: bool = False,
                             slab: Optional[Slab] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block recursion of the R start blocks of ``psi0`` (kk+1, d, R d)
    with the rows split into slabs (``msconv_shard.py
    block_lanczos_ms_sharded`` :414): each rank runs K4 on its slab, the
    Gram partials are combined over the ranks, and ``eig_sqrt`` and the
    block products run replicated.  Returns (a_b, b2_b) of shape
    (lld, R, d, d) on ``psi0``'s device, the same on every rank."""
    slab = slab or Slab(mesh, cols, psi0.device)
    op = slab_operator(slab, hs, lsham, iz, hoh=hoh, hso=hso, enim=enim,
                       iz_onsite=iz_onsite, nmax=nmax)
    n, (_, d, c) = slab.n_own, psi0.shape
    r = c // d
    dev = psi0.device
    a_b = torch.zeros((lld, r, d, d), dtype=psi0.dtype, device=dev)
    b2_b = torch.zeros_like(a_b)
    sum_b = torch.eye(d, dtype=psi0.dtype, device=dev).expand(r, d, d)
    psi = slab.extend(psi0[slab.lo:slab.hi])
    pmn = torch.zeros((n, d, c), dtype=psi0.dtype, device=dev)
    for ll in range(lld - 1):
        hpsi, g = _apply(slab, op, psi, True, plain)
        a_ll = mesh.sum_in_order(g.sum(0))
        pmn = hpsi - pmn
        pmn = pmn - block_times(psi[:n], a_ll)
        b2 = mesh.sum_in_order(gram_sum(pmn.conj(), pmn))
        b, b_i = eig_sqrt(b2)
        psi_new = slab.extend(block_times(pmn, b_i))
        pmn = block_times(psi[:n], b)
        psi = psi_new
        a_b[ll] = a_ll
        b2_b[ll] = sum_b
        sum_b = b2
    b2_b[lld - 1] = sum_b
    return a_b, b2_b


def chebyshev_moments_rowsharded(mesh, hs, lsham, iz, cols,
                                 psi0: torch.Tensor, lld: int, a: float,
                                 b: float, *, hoh: bool = False, hso=None,
                                 enim=None, iz_onsite=None, nmax: int = 0,
                                 plain: bool = False,
                                 slab: Optional[Slab] = None
                                 ) -> torch.Tensor:
    """Chebyshev block moments (2 lld + 2, R, d, d) with the rows split
    into slabs (``msconv_shard.py chebyshev_moments_ms_sharded`` :476), as
    :func:`~.chebyshev.chebyshev_moments` computes them, each moment's
    Gram combined over the ranks in rank order; the same on every rank."""
    slab = slab or Slab(mesh, cols, psi0.device)
    op = slab_operator(slab, hs, lsham, iz, hoh=hoh, hso=hso, enim=enim,
                       iz_onsite=iz_onsite, nmax=nmax)
    n = slab.n_own

    def apply_h(p):
        """(H p - b p) / a on the own rows."""
        hp, _ = _apply(slab, op, p, False, plain)
        return (hp - b * p[:n]) / a

    def gram(x, y):
        return mesh.sum_in_order(gram_sum(x.conj(), y))

    p0 = slab.extend(psi0[slab.lo:slab.hi])
    p1 = slab.extend(apply_h(p0))
    mu0 = gram(p0[:n], p0[:n])
    mu1 = gram(p0[:n], p1[:n])
    mu = [mu0, mu1]
    for _ in range(lld):
        p2 = 2.0 * apply_h(p1) - p0[:n]
        d1, d2 = gram(p1[:n], p1[:n]), gram(p2, p1[:n])
        mu += [2.0 * d1 - mu0, 2.0 * d2 - mu1]
        p0, p1 = p1, slab.extend(p2)
    return torch.stack(mu)


# ----------------------------------------------------------------------
# the scalar recursion on slabs
def lanczos_rowsharded(mesh, hs, iz, cols, psi0: torch.Tensor, lld: int, *,
                       plain: bool = False, roll: Optional[bool] = None,
                       slab: Optional[Slab] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Haydock recursion of the C chains of ``psi0`` (kk+1, 9, C) with the
    rows split into slabs (``mesh.py lanczos_rowsharded`` :219): K1' (K2'
    with ``roll``) and K3' on each slab, the halo exchanged before each
    SpMV.  K1''s and K3''s row-block partials are gathered in the global
    order and summed as one rank sums them, so ``a`` and ``b2`` are the
    single rank's where the SpMV rows are; K2''s per-slab ``a`` is summed
    in rank order.  Returns (a, b2) of shape (lld, C) on ``psi0``'s device,
    the same on every rank."""
    slab = slab or Slab(mesh, cols, psi0.device)
    dev = psi0.device
    hs = as_table(hs, torch.complex128).to(dev)
    iz_l = slab.rows(iz)
    blocks = [hk.nrowblk(s) for s in slab.plan.sizes()]
    if roll_selected(roll):
        spmv = hk.spmv_dot_pipelined_ref if plain else hk.spmv_dot_pipelined

        def spmv_dot(x):
            v, a_part = spmv(hs, iz_l, slab.cols, x)
            return v, mesh.sum_in_order(a_part)
    else:
        spmv = hk.spmv_dot_ref if plain else hk.spmv_dot

        def spmv_dot(x):
            v, apart = spmv(hs, iz_l, slab.cols, x)
            return v, mesh.gather_rows(apart, blocks).sum(0)
    update_norm = hk.update_norm_ref if plain else hk.update_norm
    n, (_, nb, c) = slab.n_own, psi0.shape
    psi = slab.extend(psi0[slab.lo:slab.hi])
    pmn = torch.zeros((n, nb, c), dtype=psi0.dtype, device=dev)
    summ = torch.ones(c, dtype=torch.float64, device=dev)
    a = torch.zeros((lld, c), dtype=torch.float64, device=dev)
    b2 = torch.zeros((lld, c), dtype=torch.float64, device=dev)
    psi_rows = torch.view_as_real(psi)[:n]
    for ll in range(lld - 1):
        slab.exchange(psi)
        v, a_ll = spmv_dot(psi)
        a[ll] = a_ll
        b2[ll] = summ
        pmn, nrm = update_norm(a_ll, psi, v, pmn)
        summ = mesh.gather_rows(nrm, blocks).sum(0)
        s = torch.sqrt(summ)
        pmn_new = psi[:n] * (-s)
        torch.div(torch.view_as_real(pmn), s[:, None], out=psi_rows)
        pmn = pmn_new
    b2[lld - 1] = summ
    return a, b2
