"""Active-set wavefront: the recursions on the rows the chains have reached.

Port of ``rslmtoasa_tpu/ops/wavefront.py`` (reference ``create_ll_map`` /
``izeroll`` / ``irlist``, ``source/recursion.f90`` :3277-3303,
:2570-2577).  After ``ll`` applications of H a chain reaches only the
atoms within ``ll`` hops of its start atom, so each step's SpMV needs only
those rows:

1. a level-synchronous BFS over the neighbour table gives each atom its
   hop distance to the nearest start atom (:func:`hop_distances`);
2. the atoms are ordered by that distance (a stable sort), so that the rows
   a step reads are a prefix of the permuted cluster;
3. the steps are grouped into *stages* of one power-of-two prefix length
   (multiples of ``granularity`` = 512, as the JAX package's plan), and the
   carried vectors grow by zero rows between stages.

The plan (:class:`WavefrontPlan`, :func:`make_plan`,
:func:`make_plan_chebyshev`) is the JAX package's, bit for bit, so both
packages run the same stages.  It is made on the device of the
neighbour table it is given: the dispatch uploads ``cols`` once to the
recursion's device, runs the BFS (one ``nonzero`` a level) and the stable
sort there, and copies back only ``n_read``, from which the host builds
the stages; the recursion then permutes the same uploaded table with the
plan's ``perm`` and ``inv`` where they lie.
NumPy arrays give a plan on the CPU in NumPy arrays.  :data:`plan_counts`
counts the plans by where they were made, and the BFS levels they took.

The recursions run each stage's steps through the kernels on the row
prefix: K1' ``spmv_dot`` (or K2' where ``roll`` selects it) and K3'
``update_norm`` for the scalar recursion, K4 ``block_step`` for the block
and Chebyshev ones.  The tables are permuted once per call, on the card,
into one operator; a stage launches on its first n rows with every column
beyond them sent to the zero row n
(:func:`~.haydock_kernels.prefix_tables`).  There is nothing to trace: the
stages only cut the SpMV's rows, and the glue is the full-width route's
own (:func:`~.lanczos.lanczos_coefficients`,
:func:`~.block_lanczos.block_lanczos`,
:func:`~.chebyshev.chebyshev_moments` with ``stages``).  The rows left out
are exact zeros, so the results differ from the full-width route only by
the summation order of the permuted rows.

An impurity's combined row table keeps its per-atom rows where the
permutation puts them: the operator's local zone (K4's global-memory
route, :func:`~.block_kernels.local_zone`) covers the permuted rows up to
the last of them.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .block_lanczos import (BlockOperator, StartBlocks, block_lanczos,
                           pad_row)
from .chebyshev import chebyshev_moments
from .lanczos import HaydockOperator

#: the plans made: ``device_plans`` from a tensor table (the BFS and the
#: sort on its device), ``host_plans`` from NumPy arrays, and ``levels``,
#: the BFS levels they took; callers zero it to see what a run planned
plan_counts: Counter = Counter()


# ----------------------------------------------------------------------
# the plan (the JAX package's create_ll_map analogue, one BFS per batch)
def device_table(t, device) -> torch.Tensor:
    """An index table (``cols``, ``iz``) as int32 on ``device``: a tensor
    already there as it is, anything else in one copy."""
    if torch.is_tensor(t):
        return t.to(device, torch.int32)
    return torch.as_tensor(np.ascontiguousarray(t),
                           dtype=torch.int32).to(device)


def _bfs(cols: torch.Tensor, kk: int, starts) -> Tuple[torch.Tensor, int]:
    """(kk,) int32 hop distances on ``cols``' device (``kk + 1`` where
    unreachable) and the levels the BFS took (the first level that reached
    no atom).  Each level gathers the frontier's rows of ``cols``, flags
    the atoms among them that have no distance yet (the sentinel ``kk``
    counts as having one), gives them the level and takes them as the next
    frontier: one ``nonzero`` a level, no sort."""
    far = kk + 1
    dist = torch.full((kk + 1,), far, dtype=torch.int32, device=cols.device)
    dist[kk] = 0
    frontier = torch.as_tensor(starts, dtype=torch.long, device=cols.device)
    dist[frontier] = 0
    flag = torch.empty(kk + 1, dtype=torch.bool, device=cols.device)
    level = 0
    while frontier.numel():
        level += 1
        flag.zero_()
        flag[cols[frontier].flatten()] = True
        flag &= dist == far
        dist.masked_fill_(flag, level)
        frontier = flag.nonzero().squeeze(1)
    return dist[:kk], level


def hop_distances(cols, kk: int, starts: Sequence[int]):
    """Hop distance of every atom to the nearest start atom.

    ``cols`` is the (kk, nslots) ELL neighbour table with sentinel ``kk``
    for missing neighbours (slot 0 = onsite).  Level-synchronous BFS, on
    the table's device for a tensor (an int32 tensor there), on the CPU
    for an array (an int64 array); unreachable atoms get ``kk + 1``."""
    dist = _bfs(torch.as_tensor(cols), kk, starts)[0]
    return dist if torch.is_tensor(cols) else dist.numpy().astype(np.int64)


class WavefrontPlan:
    """Distance ordering + staged prefix sizes for one start-atom batch.

    ``reach`` is the per-step hop reach of the SpMV *output* rows: the
    step-``i`` SpMV only needs the rows within ``reach[i]`` hops of a
    start atom.  Steps are grouped into stages of identical
    power-of-two-ish prefix length.

    Made from a tensor ``cols``, the BFS, the stable sort of the distances
    (``perm``) and its inverse (``inv``) run on the tensor's device and
    stay there; only ``n_read`` comes to the host.  Made from an array,
    ``perm`` and ``inv`` are NumPy arrays.  Either way they equal the JAX
    package's."""

    def __init__(self, cols, kk: int, starts: Sequence[int],
                 reach: Sequence[int], granularity: int = 512):
        host = not torch.is_tensor(cols)
        dist, levels = _bfs(torch.as_tensor(cols), kk, starts)
        plan_counts["host_plans" if host else "device_plans"] += 1
        plan_counts["levels"] += levels
        dist_sorted, perm = torch.sort(dist, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(kk, device=perm.device)
        self.perm, self.inv = ((perm.numpy(), inv.numpy()) if host
                               else (perm, inv))
        self.n_read = torch.searchsorted(
            dist_sorted, torch.as_tensor(np.asarray(reach), dtype=dist.dtype,
                                         device=dist.device),
            right=True).cpu().numpy()

        # power-of-two-ish buckets, multiples of `granularity`
        def _bucket(n):
            n = max(int(n), granularity)
            b = granularity
            while b < n:
                b *= 2
            return min(b, kk)

        self.stages: List[Tuple[int, int]] = []  # (prefix N, step count)
        for n in self.n_read:
            nb = _bucket(n)
            if self.stages and self.stages[-1][0] == nb:
                self.stages[-1] = (nb, self.stages[-1][1] + 1)
            else:
                self.stages.append((nb, 1))
        self.work = sum(n * s for n, s in self.stages)
        self.dense_work = kk * len(list(reach))
        self.kk = kk

    def permute_tables(self, iz, cols, iz_onsite=None):
        """Row-permuted, column-remapped ELL tables (sentinel kept): torch
        on the tables' device for tensors (the recursion permutes them on
        the card), NumPy for arrays."""
        if not torch.is_tensor(cols):
            return tuple(None if t is None else t.numpy()
                         for t in self.permute_tables(
                             torch.as_tensor(np.asarray(iz)),
                             torch.as_tensor(np.asarray(cols)),
                             None if iz_onsite is None
                             else torch.as_tensor(np.asarray(iz_onsite))))
        kk, dev = self.kk, cols.device
        perm = torch.as_tensor(self.perm, device=dev)
        inv = torch.as_tensor(self.inv, device=dev).to(cols.dtype)
        cols_w = torch.where(cols < kk, inv[cols.clamp(max=kk - 1).long()],
                             kk)[perm]
        return (iz[perm], cols_w,
                None if iz_onsite is None else iz_onsite[perm])


def make_plan(cols, kk: int, starts, lld: int, *, hops_per_step: int = 1,
              granularity: int = 512) -> WavefrontPlan:
    """Staged plan for the ``lld - 1``-step Lanczos recursions; the
    step-``i`` SpMV reaches ``hops_per_step * (i + 2)`` hops
    (``hops_per_step=2`` for HoH: H = h - h*obar*h spreads two hops
    per application)."""
    reach = hops_per_step * (np.arange(1, lld) + 1)
    return WavefrontPlan(cols, kk, starts, reach, granularity=granularity)


def make_plan_chebyshev(cols, kk: int, starts, lld: int, *,
                        hops_per_step: int = 1,
                        granularity: int = 512) -> WavefrontPlan:
    """Staged plan for the Chebyshev moment recursion: one pre-step
    (psi1 = H~ psi0, reach 1 application) plus ``lld`` scan steps
    producing p_{i+2} (reach i+2 applications)."""
    reach = hops_per_step * np.concatenate(
        [[1], np.arange(lld) + 2])
    return WavefrontPlan(cols, kk, starts, reach, granularity=granularity)


# ----------------------------------------------------------------------
# the recursions on the plan
def permuted_start(psi0, plan: WavefrontPlan) -> torch.Tensor:
    """The first stage's rows of ``psi0`` (kk+1, d, C), in the plan's
    order, with a zero row appended; raises where ``psi0`` has a nonzero
    row beyond them.  :class:`~.block_lanczos.StartBlocks` are built on
    those n0 + 1 rows directly, the same bits as the tensor's rows.  Of
    ``inv`` only the start rows' entries are read."""
    kk, n0 = plan.kk, plan.stages[0][0]
    if psi0.shape[0] != kk + 1:
        raise ValueError(f"psi0 has {psi0.shape[0]} rows, the plan kk + 1 "
                         f"= {kk + 1}")
    if isinstance(psi0, StartBlocks):
        return psi0.on_rows(plan.inv, n0)
    rows = (psi0 != 0).flatten(1).any(1).nonzero().squeeze(1).tolist()
    if rows and (rows[-1] >= kk or max(plan.inv[rows].tolist()) >= n0):
        raise ValueError("psi0 has nonzero rows outside the plan's first "
                         "stage")
    perm = torch.as_tensor(plan.perm[:n0], device=psi0.device)
    return pad_row(psi0[perm])


def _device_tables(plan, device, *tables):
    """The plan's permutation of the row tables (None passes), on
    ``device``; a table already there (the dispatch's uploaded ``cols``)
    is not copied again."""
    return plan.permute_tables(*(
        None if t is None else device_table(t, device) for t in tables))


def lanczos_coefficients_wavefront(
        hs, iz, cols, psi0: torch.Tensor, lld: int, plan: WavefrontPlan, *,
        plain: bool = False, roll: Optional[bool] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar recursion with active-set staging.  Same contract as
    :func:`.lanczos.lanczos_coefficients` on the host tables ``hs``,
    ``iz``, ``cols``; ``psi0`` (kk+1, 9, C) in the original atom order on
    the recursion's device.  Returns host (a, b2), (lld, C)."""
    iz_w, cols_w, _ = _device_tables(plan, psi0.device, iz, cols, None)
    op = HaydockOperator(hs, iz_w, cols_w).to(psi0.device)
    a, b2 = op.coefficients(permuted_start(psi0, plan), lld, plain=plain,
                            roll=roll, stages=plan.stages)
    return a.cpu().numpy(), b2.cpu().numpy()


def _block_operator(hs, lsham, iz, cols, plan, hoh, hso, enim, iz_onsite,
                    nmax, device) -> BlockOperator:
    """The block recursion's operator on the permuted tables.  The first
    ``nmax`` rows of an impurity's combined table are per-atom; the local
    zone of the permuted operator runs up to the last of them."""
    iz_w, cols_w, izo_w = _device_tables(plan, device, iz, cols, iz_onsite)
    zone = int(plan.inv[:nmax].max()) + 1 if nmax else 0
    return BlockOperator(hs, iz_w, cols_w, lsham, iz_onsite=izo_w, hoh=hoh,
                         hso=hso, enim=enim, nmax=zone).to(device)


def block_lanczos_wavefront(
        hs, lsham, iz, cols, psi0: torch.Tensor, lld: int,
        plan: WavefrontPlan, *, hoh: bool = False, hso=None, enim=None,
        iz_onsite=None, nmax: int = 0, plain: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Block recursion with active-set staging.  Same contract as
    :func:`.block_lanczos.block_lanczos` on a :class:`BlockOperator` of
    these host tables; ``psi0`` (kk+1, d, R d) in the original atom order
    on the recursion's device.  With HoH the plan must reach two hops per
    step (:func:`make_plan` ``hops_per_step=2``).  ``psi0`` may be
    :class:`~.block_lanczos.StartBlocks`.  Returns host (a_b, b2_b),
    (lld, R, d, d)."""
    op = _block_operator(hs, lsham, iz, cols, plan, hoh, hso, enim,
                         iz_onsite, nmax, psi0.device)
    a_b, b2_b = block_lanczos(op, permuted_start(psi0, plan), lld,
                              plain=plain, stages=plan.stages)
    return a_b.cpu().numpy(), b2_b.cpu().numpy()


def chebyshev_moments_wavefront(
        hs, lsham, iz, cols, psi0: torch.Tensor, lld: int, a: float,
        b: float, plan: WavefrontPlan, *, hoh: bool = False, hso=None,
        enim=None, iz_onsite=None, nmax: int = 0, plain: bool = False
) -> np.ndarray:
    """Chebyshev block moments with active-set staging (``izeroll`` of
    ``chebyshev_recur_ll``, recursion.f90:2570-2577).  Same contract as
    :func:`.chebyshev.chebyshev_moments`; the plan must come from
    :func:`make_plan_chebyshev`: its step 0 is the ``psi1 = H~ psi0``
    pre-step, folded into the first stage.  Returns host mu
    (2 lld + 2, R, d, d)."""
    op = _block_operator(hs, lsham, iz, cols, plan, hoh, hso, enim,
                         iz_onsite, nmax, psi0.device)
    mu = chebyshev_moments(op, permuted_start(psi0, plan), lld, a, b,
                           plain=plain, stages=plan.stages)
    return mu.cpu().numpy()
