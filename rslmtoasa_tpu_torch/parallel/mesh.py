"""Distribution of the recursions over ranks with ``torch.distributed``.

Port of ``rslmtoasa_tpu/parallel/mesh.py``.  The reference distributes
over atoms/chains only (MPI, ``source/mpi.f90:32-58``): every rank holds
the whole Hamiltonian and the collectives are allreduce-sums, so its
results do not depend on the rank count.  Here one process is one rank
(``torchrun``, or :mod:`.launch`), and two layouts carry over:

* **chain sharding** -- the batch of independent chains is split over the
  ranks and the tables are replicated (:func:`lanczos_sharded`,
  :func:`block_lanczos_sharded`, :func:`chebyshev_moments_sharded`).
  Each rank runs its share through K1'/K3' or K4 on its device; the
  results are gathered, so every rank holds all of them.
* **row sharding** -- for clusters beyond one card the rows are split
  into slabs with a halo (:mod:`..ops.rowslab`).  :func:`rowsharded_spmv_step`
  all-gathers the vector; :func:`rowsharded_spmv_halo` and the recursion
  on slabs (the JAX ``lanczos_rowsharded`` :219 is
  :func:`..ops.rowslab.lanczos_rowsharded`) send each neighbour only the
  rows its columns reach (``batch_isend_irecv``), where the JAX package
  passes every chunk around a ``ppermute`` ring.

:class:`Mesh` holds the process group, the rank, the world size and the
rank's device.  The backend is NCCL for CUDA ranks and gloo for CPU ranks,
or for CUDA ranks that share cards (NCCL refuses two ranks on one device);
gloo's collectives then take host tensors, and :meth:`Mesh._wire` is the
one place where CUDA tensors are staged through the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.logger import g_logger

_RANK_DEVICE: Dict[str, Optional[torch.device]] = {"device": None}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     addr: Optional[str] = None, port: Optional[int] = None,
                     *, device="cuda", share_cards: Optional[bool] = None,
                     init_method: Optional[str] = None
                     ) -> Optional[torch.device]:
    """Join the process group (the reference's ``MPI_INIT``,
    ``main.f90:26-49``; the JAX package's ``dispatch.init_distributed``
    :73) and return this rank's device.

    The arguments default to ``torchrun``'s ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Without a world
    size it does nothing and returns None, so single-rank runs never pay
    for it.  ``device="cuda"`` puts the rank on ``cuda:LOCAL_RANK`` over
    NCCL; more ranks than cards raise unless ``share_cards`` (default: the
    ``RSLMTO_SHARE_CARDS`` variable) asks for ranks to share the cards,
    which runs them over gloo.  ``device="cpu"`` runs gloo on the host.
    ``init_method`` overrides the rendezvous (``file://...`` or
    ``tcp://host:port``)."""
    if dist.is_initialized():
        return _RANK_DEVICE["device"]
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if world_size is None:
        return None
    rank = _env_int("RANK") if rank is None else rank
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    if share_cards is None:
        share_cards = bool(os.environ.get("RSLMTO_SHARE_CARDS"))
    kind = torch.device(device).type
    if kind == "cuda":
        from ..utils.device import resolve_device

        resolve_device("cuda")  # raises without a card
        ncard = torch.cuda.device_count()
        if local_rank >= ncard and not share_cards:
            raise ValueError(
                f"local rank {local_rank} has no card of its own ({ncard} "
                f"visible); let ranks share cards (share_cards=True or "
                f"RSLMTO_SHARE_CARDS=1), which runs them over gloo")
        dev = torch.device("cuda", local_rank % ncard)
        torch.cuda.set_device(dev)
        backend = "gloo" if share_cards else "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or "
                         f"'cpu')")
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR") if addr is None else addr
        port = _env_int("MASTER_PORT") if port is None else port
        init_method = (f"tcp://{addr}:{port}" if addr and port
                       else "env://")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(minutes=10))
    _RANK_DEVICE["device"] = dev
    if backend == "nccl":
        # a first collective of the whole group, so that no batch of
        # point-to-point sends among some ranks opens the communicator
        dist.barrier(device_ids=[dev.index])
    if backend == "gloo" and dev.type == "cuda":
        g_logger.info(f"rank {rank}: {world_size} ranks share the cards "
                      f"over gloo; collectives stage CUDA tensors through "
                      f"the host (Mesh._wire)")
    return dev


def rank_device() -> Optional[torch.device]:
    """The device :func:`init_distributed` gave this rank, or None."""
    return _RANK_DEVICE["device"]


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE["device"] = None


@dataclass(frozen=True)
class Mesh:
    """The ranks of one process group and this rank's place in it."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str

    # -- the wire ------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: real (complex viewed as pairs),
        contiguous, on the host where gloo meets a CUDA tensor (the one
        place where ranks that share cards stage through the host) and on
        the rank's card where NCCL meets a host tensor."""
        if t.is_complex():
            t = torch.view_as_real(t)
        if self.backend == "gloo" and t.is_cuda:
            t = t.cpu()
        elif self.backend == "nccl" and not t.is_cuda:
            t = t.to(self.device)
        return t.contiguous()

    def _unwire(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        w = w.to(like.device)
        return torch.view_as_complex(w) if like.is_complex() else w

    # -- collectives ---------------------------------------------------
    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (equal shapes), in rank order."""
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(out, w, group=self.group)
        return [self._unwire(o, t) for o in out]

    def gather_rows(self, t: torch.Tensor,
                    sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0 in rank order; the ranks'
        row counts may differ (``sizes``, exchanged when not given)."""
        if sizes is None:
            n = torch.tensor([t.shape[0]], dtype=torch.int64)
            sizes = [int(s) for s in self.all_gather(n)]
        top = max(sizes)
        pad = t if t.shape[0] == top else torch.cat(
            [t, t.new_zeros((top - t.shape[0],) + t.shape[1:])])
        parts = self.all_gather(pad)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    def sum_in_order(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order: the same
        bits on every rank and from run to run (an ``all_reduce`` leaves
        the order to the backend)."""
        parts = self.all_gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``all_reduce`` (SUM) of ``t``, returned as a new tensor."""
        w = self._wire(t.clone())
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
        return self._unwire(w, t)

    def _wire_empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        """An empty receive buffer of ``shape`` (in ``like``'s dtype) as
        :meth:`_wire` would hand it to the backend."""
        if like.is_complex():
            shape = tuple(shape) + (2,)
        dtype = like.real.dtype if like.is_complex() else like.dtype
        dev = (torch.device("cpu") if self.backend == "gloo"
               else like.device)
        return torch.empty(shape, dtype=dtype, device=dev)

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, Tuple[Tuple[int, ...], torch.Tensor]]
                 ) -> Dict[int, torch.Tensor]:
        """Point-to-point: send ``sends[peer]`` to each peer and receive a
        tensor of shape ``recvs[peer][0]`` like ``recvs[peer][1]`` from
        each; returns the received tensors by peer.  The sends and
        receives go out as one ``batch_isend_irecv``: NCCL then launches
        them together, where a receive posted alone would wait on its
        stream for a send the peer has queued behind its own receive."""
        ops, got = [], {}
        for peer, (shape, like) in recvs.items():
            w = self._wire_empty(shape, like)
            ops.append(dist.P2POp(dist.irecv, w, peer, self.group))
            got[peer] = (w, like)
        for peer, t in sends.items():
            ops.append(dist.P2POp(dist.isend, self._wire(t), peer,
                                  self.group))
        for r in (dist.batch_isend_irecv(ops) if ops else []):
            r.wait()
        return {peer: self._unwire(w, like)
                for peer, (w, like) in got.items()}

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(group=None) -> Mesh:
    """The :class:`Mesh` of ``group`` (default: the whole world) for this
    rank; needs :func:`init_distributed` first."""
    dev = rank_device()
    if not dist.is_initialized() or dev is None:
        raise RuntimeError("make_mesh needs the process group and the "
                           "rank's device of init_distributed")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev,
                dist.get_backend(group))


# ----------------------------------------------------------------------
# chain sharding
def shard_chains(mesh: Mesh, psi0: torch.Tensor, width: int = 1
                 ) -> Tuple[torch.Tensor, int]:
    """This rank's share of the chains of ``psi0`` (last axis, ``width``
    columns per chain: 1 for the scalar recursion, d for a start block).

    The chain count is padded to a multiple of the world size with copies
    of chain 0 (exact: chains are independent; the JAX package's
    ``_pad_axis`` and copy of chain 0); returns (share, real chain
    count)."""
    n = psi0.shape[-1] // width
    per = -(-n // mesh.world)
    idx = torch.arange(mesh.rank * per, (mesh.rank + 1) * per)
    idx = torch.where(idx < n, idx, 0)
    cols = (idx[:, None] * width + torch.arange(width)).reshape(-1)
    return psi0[..., cols.to(psi0.device)].contiguous(), n


def gather_chains(mesh: Mesh, x: torch.Tensor, n: int, dim: int = 1
                  ) -> torch.Tensor:
    """Every rank's share of ``x`` (chains along ``dim``) put together in
    rank order, the padding dropped: the full result on every rank."""
    full = torch.cat(mesh.all_gather(x), dim=dim)
    return full.narrow(dim, 0, n)


def lanczos_sharded(mesh: Mesh, hs, iz, cols, psi0: torch.Tensor, lld: int,
                    *, plain: bool = False, roll: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chain-sharded scalar Haydock recursion (``mesh.py lanczos_sharded``
    :50): each rank recurs its share of the C chains of ``psi0`` (kk+1, 9,
    C) through K1'/K3' (K2' with ``roll``) on its device.  Returns (a, b2)
    of shape (lld, C) on ``psi0``'s device, the same on every rank."""
    from ..ops.lanczos import HaydockOperator

    share, n = shard_chains(mesh, psi0)
    op = HaydockOperator(hs, iz, cols).to(psi0.device)
    a, b2 = op.coefficients(share, lld, plain=plain, roll=roll)
    return gather_chains(mesh, a, n), gather_chains(mesh, b2, n)


def block_lanczos_sharded(mesh: Mesh, op, psi0: torch.Tensor, lld: int, *,
                          plain: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chain-sharded block recursion (``mesh.py block_lanczos_sharded``
    :282, the MPI nrec/njij partitions of ``recur_b``/``recur_b_ij``): the
    R start blocks of ``psi0`` (kk+1, d, R d) split over the ranks, each
    share through K4 on the replicated operator ``op``.  Returns (a_b,
    b2_b) of shape (lld, R, d, d) on ``psi0``'s device on every rank."""
    from ..ops.block_lanczos import block_lanczos

    d = psi0.shape[1]
    share, n = shard_chains(mesh, psi0, d)
    a_b, b2_b = block_lanczos(op, share, lld, plain=plain)
    return gather_chains(mesh, a_b, n), gather_chains(mesh, b2_b, n)


def chebyshev_moments_sharded(mesh: Mesh, op, psi0: torch.Tensor, lld: int,
                              a: float, b: float, *, plain: bool = False
                              ) -> torch.Tensor:
    """Chain-sharded Chebyshev block moments (the mesh branch of the JAX
    package's ``chebyshev_moments_auto``, ``dispatch.py`` :626-669):
    (2 lld + 2, R, d, d) on every rank."""
    from ..ops.chebyshev import chebyshev_moments

    d = psi0.shape[1]
    share, n = shard_chains(mesh, psi0, d)
    mu = chebyshev_moments(op, share, lld, a, b, plain=plain)
    return gather_chains(mesh, mu, n)


def total_dos_psum(mesh: Mesh, dens_chains: torch.Tensor) -> torch.Tensor:
    """The reference's ALLREDUCE of the DOS (``bands.f90:271-274``):
    this rank's per-chain DOS (NE, C_local) summed over its chains, then
    over the ranks.  Returns (NE,) on every rank."""
    return mesh.all_reduce_sum(dens_chains.sum(1))


# ----------------------------------------------------------------------
# row sharding
def rowsharded_spmv_step(mesh: Mesh, hs, iz, cols,
                         psi: torch.Tensor) -> torch.Tensor:
    """One SpMV ``y = H psi`` with the rows split over the ranks
    (``mesh.py rowsharded_spmv_step`` :103): each rank holds the rows of
    its slab of ``psi`` (kk, 9, C), all-gathers the vector and runs K1'
    on its rows against it.  ``cols`` (kk, nslots) has the sentinel kk.
    Returns the full y (kk, 9, C) on every rank."""
    from ..ops import haydock_kernels as hk
    from ..ops.lanczos import as_table
    from ..ops.rowslab import SlabPlan, host

    dev = psi.device
    cols = host(cols)
    plan = SlabPlan(cols, mesh.world)
    lo, hi = plan.bounds[mesh.rank], plan.bounds[mesh.rank + 1]
    full = mesh.gather_rows(psi[lo:hi].contiguous(), plan.sizes())
    x = torch.cat([full, full.new_zeros((1,) + full.shape[1:])])
    y, _ = hk.spmv_dot(as_table(hs, torch.complex128).to(dev),
                as_table(host(iz)[lo:hi], torch.int32).to(dev),
                as_table(cols[lo:hi], torch.int32).to(dev), x)
    return mesh.gather_rows(y, plan.sizes())


def rowsharded_spmv_halo(mesh: Mesh, hs, iz, cols,
                         psi: torch.Tensor) -> torch.Tensor:
    """One SpMV with the rows and the vector split over the ranks
    (``mesh.py rowsharded_spmv_halo`` :187): each rank holds its slab of
    ``psi`` (kk, 9, C), receives from its neighbours only the halo rows its
    columns reach, and runs K1' on the slab's local tables.  Returns the
    full y (kk, 9, C) on every rank (gathered for the caller; the
    recursion keeps its rows sharded)."""
    from ..ops import haydock_kernels as hk
    from ..ops.lanczos import as_table
    from ..ops.rowslab import Slab

    slab = Slab(mesh, cols, psi.device)
    x = slab.exchange(slab.extend(psi[slab.lo:slab.hi]))
    y, _ = hk.spmv_dot(as_table(hs, torch.complex128).to(psi.device),
                       slab.rows(iz), slab.cols, x)
    return mesh.gather_rows(y, slab.plan.sizes())

