"""Dispatch of the scalar, block, Chebyshev and Kubo recursions over the
ranks and on each rank's device.

Port of ``rslmtoasa_tpu/parallel/dispatch.py`` (``lanczos_auto`` :687,
``block_lanczos_auto`` :295, ``chebyshev_moments_auto`` :480): when the
block problem decouples into
collinear spin sectors (``nsp`` 1, no spin-orbit coupling) the recursion
runs once per 9-wide sector, otherwise once at the full width 18.  Each
recursion (each sector for itself) runs through the active-set wavefront
(:mod:`..ops.wavefront`) where :func:`_wavefront_plan` engages, as the JAX
package's rule does: above ``RSLMTO_WAVEFRONT_KK`` atoms (default 30 000)
and where the plan's work is under 0.7 of the full width's; else at the
full width.  Either way it runs on ``device``, through K1'/K3' (scalar) or
K4.  The Kubo moments (:func:`kubo_moments_auto`) always run at width 18
over the whole cluster, as the JAX package's ``models/conductivity.py``
runs them, in groups of start blocks that fit the device's memory.

With more than one rank (:func:`get_mesh`, a process group from
:func:`.mesh.init_distributed`) the JAX package's mesh branches come
first, and the wavefront only where no mesh is taken (``lanczos_auto``
:700-713):

* **row slabs** (:mod:`..ops.rowslab`) where the recursion state does not
  fit one rank's budget (:func:`_rowshard_wanted`, :func:`_rowslab_wanted`);
* else **chain sharding** (:mod:`.mesh`) where there are at least as many
  chains as ranks (:func:`_mesh_for`): R or C padded to a multiple of the
  world size with copies of chain 0, each rank's share recurred, the
  results gathered and the padding dropped; the Kubo moments split their
  start units over the ranks (``models/conductivity.py`` :397-421).

Every route returns the full result on every rank.  The TPU engines (the
multi-site conv engines, df64) are not ported.

The tables come as host arrays (complex128, the JAX package's layouts),
``psi0`` as a tensor in the port's layout ``(kk+1, d, R d)`` or, for the
block and Chebyshev recursions, as :class:`~..ops.block_lanczos.StartBlocks`,
of which each route builds only the rows and chains it recurs; results
come back as host arrays in the JAX package's layouts.  An impurity's
tables are the combined rows ``[hall; ee]`` with ``iz`` the per-row index
into them, ``iz_onsite`` the species of each row and ``nmax`` the per-atom
rows in front; the spin sectors cut them like any table.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..ops import rowslab, wavefront
from ..ops.block_lanczos import (BlockOperator, StartBlocks, block_lanczos,
                                  dense_start)
from ..ops.chebyshev import chebyshev_moments
from ..ops.kubo import VelocityOperator, kubo_moments, plan
from ..ops.lanczos import HaydockOperator
from ..utils.logger import g_logger
from ..utils.timer import g_timer
from . import mesh as mesh_mod

MAX_STARTS = 4096  # start rows beyond which the wavefront is not planned

_mesh_cache = {"mesh": None, "checked": False}

#: the routes over the ranks this process has taken, by name: ``slab_`` or
#: ``chains_`` and the recursion (``scalar``, ``block``, ``cheb``), and
#: ``units_kubo``; callers zero it to see where a run went
ROUTES = ("slab_scalar", "chains_scalar", "slab_block", "chains_block",
          "slab_cheb", "chains_cheb", "units_kubo")
routes: Counter = Counter()
#: the routes taken where no mesh is, by name: ``wavefront_`` or ``full_``
#: (the full width) and the recursion, one a recursion (each spin sector
#: counts), so that a run on one card sees which route each job took
local_routes: Counter = Counter()


def get_mesh() -> Optional[mesh_mod.Mesh]:
    """The mesh of all ranks, or ``None`` with one rank, without a process
    group, or with ``RSLMTO_NO_MESH`` set (the JAX package's
    ``get_mesh``)."""
    if _mesh_cache["checked"]:
        return _mesh_cache["mesh"]
    _mesh_cache["checked"] = True
    if os.environ.get("RSLMTO_NO_MESH"):
        return None
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    _mesh_cache["mesh"] = mesh_mod.make_mesh()
    return _mesh_cache["mesh"]


def _mesh_for(n_chains: int) -> Optional[mesh_mod.Mesh]:
    """The mesh, or None where there are fewer chains than ranks (the
    reference leaves surplus ranks idle there)."""
    mesh = get_mesh()
    return mesh if mesh is not None and n_chains >= mesh.world else None


def rowshard_budget(device: torch.device) -> int:
    """Bytes of recursion state one rank may hold: ``RSLMTO_ROWSHARD_BYTES``,
    else half the card's memory (the state model below counts psi, pmn,
    H psi and headroom; the other half holds the tables, K4's packed
    tables, the Green functions and the allocator's slack), else 8 GiB on
    the CPU (the JAX package's default, sized for a TPU v5e's 16 GiB)."""
    env = os.environ.get("RSLMTO_ROWSHARD_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return 8 << 30


def _state_bytes(kk: int, b: int, c: int) -> int:
    """The JAX package's model of the recursion state: 6 complex128
    (kk, b, c) buffers (psi, pmn, H psi and headroom)."""
    return 6 * kk * b * c * 16


def _rowshard_wanted(mesh, kk: int, b: int, c: int,
                     device: torch.device) -> bool:
    """The scalar recursion's gate (``dispatch.py`` :672): row slabs where
    the state of all C chains exceeds one rank's budget."""
    return (mesh is not None
            and _state_bytes(kk, b, c) > rowshard_budget(device))


def _rowslab_wanted(mesh, kk: int, d: int, device: torch.device) -> bool:
    """The block and Chebyshev gate (``_ms_engine_for``'s ``grid_shard``,
    ``dispatch.py`` :188-219): row slabs where one chain's state exceeds
    one rank's budget and its share on ``world`` ranks fits."""
    if mesh is None:
        return False
    one, budget = _state_bytes(kk, d, d), rowshard_budget(device)
    if one > budget and one // mesh.world <= budget:
        g_logger.info(f"row slabs: ~{one / 2**30:.1f} GiB per chain "
                      f"exceeds one rank's {budget / 2**30:.1f} GiB; "
                      f"splitting the rows over {mesh.world} ranks")
        return True
    return False


def _wavefront_plan(cols, psi0, lld: int, hoh: bool,
                    kind: str = "lanczos"
                    ) -> Optional[wavefront.WavefrontPlan]:
    """Active-set plan for large clusters (create_ll_map analogue,
    recursion.f90:3277-3303), or ``None`` where the full width is taken:
    below ``RSLMTO_WAVEFRONT_KK`` atoms (default 30 000), with no start
    row or more than :data:`MAX_STARTS` (the nonzero rows of ``psi0``, a
    tensor, or the start rows of :class:`StartBlocks`), or
    where the plan's work is not under 0.7 of the full width's (the JAX
    package's ``_wavefront_plan``, ``parallel/dispatch.py`` :131).  With
    ``hoh`` H reaches two hops per application; ``kind="chebyshev"`` plans
    the moments' pre-step too.  The plan is made on the device of
    ``cols``, the caller's table uploaded once to ``psi0``'s device and
    handed on to the recursion: the BFS and the sort run there, and only
    the prefix lengths come back to the host."""
    kk = psi0.shape[0] - 1
    if kk < int(os.environ.get("RSLMTO_WAVEFRONT_KK", "30000")):
        return None
    if isinstance(psi0, StartBlocks):
        starts = psi0.rows
    else:
        starts = (psi0[:kk] != 0).flatten(1).any(1).nonzero().squeeze(1)
    if len(starts) == 0 or len(starts) > MAX_STARTS:
        return None
    mk = (wavefront.make_plan_chebyshev if kind == "chebyshev"
          else wavefront.make_plan)
    with g_timer.section("wavefront-plan"):
        p = mk(cols, kk, starts, lld, hops_per_step=2 if hoh else 1)
    if p.work >= 0.7 * p.dense_work:
        return None
    g_logger.debug(f"wavefront: stages {p.stages}, "
                   f"work {p.work / p.dense_work:.3f} of the full width")
    return p


def lanczos_auto(hs, iz, cols, psi0: torch.Tensor, lld: int, *,
                 plain: bool = False, roll: Optional[bool] = None):
    """Scalar Haydock recursion of the C chains of ``psi0`` (kk+1, 9, C)
    on its device (the JAX package's ``lanczos_auto`` :687): over the
    ranks on row slabs or chain-sharded, else through the wavefront where
    :func:`_wavefront_plan` engages.  Returns host (a, b2) of shape
    (lld, C)."""
    kk1, b, c = psi0.shape
    mesh = _mesh_for(c)
    if mesh is not None:
        slabs = _rowshard_wanted(mesh, kk1 - 1, b, c, psi0.device)
        routes["slab_scalar" if slabs else "chains_scalar"] += 1
        run = rowslab.lanczos_rowsharded if slabs else mesh_mod.lanczos_sharded
        a, b2 = run(mesh, hs, iz, cols, psi0, lld, plain=plain, roll=roll)
        return a.cpu().numpy(), b2.cpu().numpy()
    cols = wavefront.device_table(cols, psi0.device)
    p = _wavefront_plan(cols, psi0, lld, False)
    local_routes["full_scalar" if p is None else "wavefront_scalar"] += 1
    if p is not None:
        return wavefront.lanczos_coefficients_wavefront(
            hs, iz, cols, psi0, lld, p, plain=plain, roll=roll)
    op = HaydockOperator(hs, iz, cols).to(psi0.device)
    a, b2 = op.coefficients(psi0, lld, plain=plain, roll=roll)
    return a.cpu().numpy(), b2.cpu().numpy()


def _spin_diag(m) -> bool:
    """True when every 18x18 block of ``m`` has exactly zero
    spin-off-diagonal (up-down / down-up) 9x9 blocks."""
    if m is None:
        return True
    m = np.asarray(m)
    return (not np.count_nonzero(m[..., :9, 9:])
            and not np.count_nonzero(m[..., 9:, :9]))


def _spin_sectors(hs, lsham, hso, enim, psi0):
    """Collinear spin-sector decoupling (nsp <= 2, no SOC).

    When H, eeo, enim, the SOC table and the start blocks are all
    spin-block-diagonal, the 18-wide block recursion decouples exactly
    into two 9-wide recursions: a_ll, B^2, B, B^-1 and psi stay
    spin-block-diagonal at every step, so running the 9x9 sectors
    separately reproduces the 18x18 recursion to roundoff, for a quarter
    of the SpMV work.  Returns [(hs, lsham, hso, enim, psi0)] per sector,
    or ``None`` when the problem does not decouple.  :class:`StartBlocks`
    (multiples of I) are spin-block-diagonal and cut into 9-wide ones."""
    if psi0.shape[1] != 18:
        return None
    n = psi0.shape[0]
    blocks = isinstance(psi0, StartBlocks)
    if not blocks:
        p = psi0.view(n, 18, -1, 18)  # p[i, :, r]: row i of start block r
    if not (_spin_diag(hs) and _spin_diag(lsham) and _spin_diag(hso)
            and _spin_diag(enim)
            and (blocks or not bool(p[:, :9, :, 9:].any()
                                    or p[:, 9:, :, :9].any()))):
        return None

    def cut(m, sl):
        return None if m is None else np.ascontiguousarray(
            np.asarray(m)[..., sl, sl])

    out = []
    for s in range(2):
        sl = slice(9 * s, 9 * s + 9)
        ps = (psi0.sector(9) if blocks
              else p[:, sl, :, sl].reshape(n, 9, -1))
        out.append((cut(hs, sl), cut(lsham, sl), cut(hso, sl),
                    cut(enim, sl), ps))
    return out


def _spin_assemble(xu, xd):
    """Reassemble per-sector (..., 9, 9) results into spin-block-diagonal
    (..., 18, 18) arrays (the off-diagonal blocks are exactly zero)."""
    xu = np.asarray(xu)
    out = np.zeros(xu.shape[:-2] + (18, 18), xu.dtype)
    out[..., :9, :9] = xu
    out[..., 9:, 9:] = np.asarray(xd)
    return out


def block_lanczos_auto(hs, lsham, iz, cols, psi0, lld: int, *,
                       hoh: bool = False, hso=None, enim=None,
                       iz_onsite=None, nmax: int = 0, plain: bool = False):
    """Block recursion of the R start blocks of ``psi0`` on its device, per
    spin sector where the problem decouples, each through the wavefront
    where :func:`_wavefront_plan` engages.  Returns host (a_b, b2_b) of
    shape (lld, R, 18, 18) (or d wide for a d-wide ``psi0``).  Over the
    ranks each sector runs on row slabs where :func:`_rowslab_wanted`, else
    chain-sharded where :func:`_mesh_for` gives the mesh.  ``psi0`` is the
    (kk+1, d, R d) tensor or :class:`StartBlocks`, of which each route
    builds what it recurs: the wavefront its first stage's rows, chain
    sharding the rank's chains, the row slabs and the full width the whole
    tensor."""
    sec = _spin_sectors(hs, lsham, hso, enim, psi0)
    if sec is not None:
        outs = [block_lanczos_auto(h_, l_, iz, cols, p_, lld, hoh=hoh,
                                   hso=o_, enim=e_, iz_onsite=iz_onsite,
                                   nmax=nmax, plain=plain)
                for (h_, l_, o_, e_, p_) in sec]
        return (_spin_assemble(outs[0][0], outs[1][0]),
                _spin_assemble(outs[0][1], outs[1][1]))
    tables = dict(hoh=hoh, hso=hso, enim=enim, iz_onsite=iz_onsite,
                  nmax=nmax)
    kk, d = psi0.shape[0] - 1, psi0.shape[1]
    if _rowslab_wanted(get_mesh(), kk, d, psi0.device):
        routes["slab_block"] += 1
        a_b, b2_b = rowslab.block_lanczos_rowsharded(
            get_mesh(), hs, lsham, iz, cols, dense_start(psi0), lld,
            plain=plain, **tables)
        return a_b.cpu().numpy(), b2_b.cpu().numpy()
    mesh = _mesh_for(psi0.shape[2] // d)
    if mesh is not None:
        routes["chains_block"] += 1
        op = BlockOperator(hs, iz, cols, lsham, **tables).to(psi0.device)
        a_b, b2_b = mesh_mod.block_lanczos_sharded(mesh, op, psi0, lld,
                                                   plain=plain)
        return a_b.cpu().numpy(), b2_b.cpu().numpy()
    cols = wavefront.device_table(cols, psi0.device)
    p = _wavefront_plan(cols, psi0, lld, hoh)
    local_routes["full_block" if p is None else "wavefront_block"] += 1
    if p is not None:
        return wavefront.block_lanczos_wavefront(
            hs, lsham, iz, cols, psi0, lld, p, hoh=hoh, hso=hso, enim=enim,
            iz_onsite=iz_onsite, nmax=nmax, plain=plain)
    op = BlockOperator(hs, iz, cols, lsham, iz_onsite=iz_onsite, hoh=hoh,
                       hso=hso, enim=enim, nmax=nmax).to(psi0.device)
    a_b, b2_b = block_lanczos(op, dense_start(psi0), lld, plain=plain)
    return a_b.cpu().numpy(), b2_b.cpu().numpy()


def _diverged(mu: np.ndarray) -> bool:
    """The reference's divergence test (recursion.f90:2594-2596): the
    SIGNED real sum of the newest even-moment block per start block above
    1000 means the spectrum leaks outside the scaled energy window."""
    last = mu[-1].real.reshape(mu.shape[1], -1).sum(axis=1)
    return bool((last > 1.0e3).any())


def chebyshev_moments_auto(hs, lsham, iz, cols, psi0, lld: int, a: float,
                           b: float, *, hoh: bool = False, hso=None, enim=None,
                           iz_onsite=None, nmax: int = 0,
                           guard: bool = True,
                           plain: bool = False) -> np.ndarray:
    """Chebyshev block moments of the start blocks of ``psi0`` on its
    device, per spin sector where the problem decouples, each through the
    wavefront where :func:`_wavefront_plan` engages.  Returns host mu
    (2 lld + 2, R, 18, 18).  The routes over the ranks are those of
    :func:`block_lanczos_auto`.  The divergence guard sees the gathered,
    assembled 18 x 18 blocks, as the reference sums the full block.
    ``psi0`` is a tensor or :class:`StartBlocks`, as there."""
    sec = _spin_sectors(hs, lsham, hso, enim, psi0)
    if sec is not None:
        outs = [chebyshev_moments_auto(h_, l_, iz, cols, p_, lld, a, b,
                                       hoh=hoh, hso=o_, enim=e_,
                                       iz_onsite=iz_onsite, nmax=nmax,
                                       guard=False, plain=plain)
                for (h_, l_, o_, e_, p_) in sec]
        mu = _spin_assemble(outs[0], outs[1])
    elif _rowslab_wanted(get_mesh(), psi0.shape[0] - 1, psi0.shape[1],
                         psi0.device):
        routes["slab_cheb"] += 1
        mu = rowslab.chebyshev_moments_rowsharded(
            get_mesh(), hs, lsham, iz, cols, dense_start(psi0), lld, a, b,
            hoh=hoh, hso=hso, enim=enim, iz_onsite=iz_onsite, nmax=nmax,
            plain=plain).cpu().numpy()
    elif (mesh := _mesh_for(psi0.shape[2] // psi0.shape[1])) is not None:
        routes["chains_cheb"] += 1
        op = BlockOperator(hs, iz, cols, lsham, iz_onsite=iz_onsite,
                           hoh=hoh, hso=hso, enim=enim,
                           nmax=nmax).to(psi0.device)
        mu = mesh_mod.chebyshev_moments_sharded(
            mesh, op, psi0, lld, a, b, plain=plain).cpu().numpy()
    else:
        cols = wavefront.device_table(cols, psi0.device)
        p = _wavefront_plan(cols, psi0, lld, hoh, "chebyshev")
        local_routes["full_cheb" if p is None else "wavefront_cheb"] += 1
        if p is not None:
            mu = wavefront.chebyshev_moments_wavefront(
                hs, lsham, iz, cols, psi0, lld, a, b, p, hoh=hoh, hso=hso,
                enim=enim, iz_onsite=iz_onsite, nmax=nmax, plain=plain)
        else:
            op = BlockOperator(hs, iz, cols, lsham, iz_onsite=iz_onsite,
                               hoh=hoh, hso=hso, enim=enim,
                               nmax=nmax).to(psi0.device)
            mu = chebyshev_moments(op, dense_start(psi0), lld, a, b,
                                   plain=plain).cpu().numpy()
    if not np.isfinite(mu).all() or (guard and _diverged(mu)):
        g_logger.fatal("Chebyshev moments did not converge. Check energy "
                       "limits energy_min and energy_max")
    return mu


def kubo_moments_auto(hs, lsham, iz, cols, va, vb, psi0: torch.Tensor,
                      n_moments: int, a: float, b: float, *,
                      hoh: bool = False, hso=None, enim=None, vo_a=None,
                      vo_b=None, plain: bool = False) -> torch.Tensor:
    """Kubo moments mu (R, n, m, 18, 18) of the R start blocks of ``psi0``
    (kk+1, 18, 18 R) on its device, as a tensor there.  The start blocks
    recur side by side in groups, and the left chain is stored in blocks,
    both sized by :func:`~..ops.kubo.plan`; with ``hoh`` the velocities
    carry ``vo_a``/``vo_b`` (zeros if None).  Over the ranks the start
    units are split (:func:`_mesh_for`) and the moments gathered."""
    dev = psi0.device
    kk, r = psi0.shape[0] - 1, psi0.shape[2] // 18
    op = BlockOperator(hs, iz, cols, lsham, hoh=hoh, hso=hso,
                       enim=enim).to(dev)

    def velocity(v, vo):
        if hoh and vo is None:
            vo = np.zeros_like(v)
        return VelocityOperator(v, iz, cols, vo if hoh else None).to(dev)

    va_op, vb_op = velocity(va, vo_a), velocity(vb, vo_b)
    mesh = _mesh_for(r)
    if mesh is not None:
        # the type / random-vector partition over the ranks (the
        # reference's get_mpi_variables(rank, ntype), calculation.f90:1002)
        routes["units_kubo"] += 1
        psi0, n_units = mesh_mod.shard_chains(mesh, psi0, 18)
        r = psi0.shape[2] // 18
    per, size = plan(kk, r, n_moments, dev, plain)
    g_logger.info(f"Kubo moments: {r} start blocks in groups of {per}, "
                  f"left chain in blocks of {size} of {n_moments}")
    mu = torch.cat([
        kubo_moments(op, va_op, vb_op,
                     psi0[:, :, 18 * s:18 * min(r, s + per)].contiguous(),
                     n_moments, a, b, size, plain=plain)
        for s in range(0, r, per)])
    if mesh is not None:
        mu = mesh_mod.gather_chains(mesh, mu, n_units, dim=0)
    return mu
