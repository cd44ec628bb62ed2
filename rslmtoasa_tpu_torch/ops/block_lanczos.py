"""Block-Lanczos recursion with d x d block coefficients (d = 18, or 9 per
collinear spin sector).

Port of ``rslmtoasa_tpu/ops/block_lanczos.py`` (reference
``source/recursion.f90`` ``recur_b`` :1807, ``crecal_b`` :1873, ``hop_b``
:1560, ``hop_b_hoh`` :1411) in complex128 PyTorch:

* per level: ``apply_h`` and ``A_n = sum_i psi_i^H (H psi)_i`` in K4
  (:func:`~.block_kernels.block_step`, the Gram as its epilogue); the
  residual update, ``B^2``, ``B = sqrt(B^2)`` by ``torch.linalg.eigh`` and
  the psi update with ``B^-1`` as torch ops on ``psi``'s device;
* the R start blocks recur side by side; the depth loop is a Python loop;
* the HoH overlap correction ``H = h - h obar h + enim + l.s`` is two K4
  launches: ``h psi``, then ``h psi - eeo (h psi) + (enim + lsham) psi``.

Layout: ``psi`` is ``(kk+1, d, R d)``, the scalar path's ``(kk+1, 9, C)``
with the R start blocks' d columns side by side (``psi[i, b, r d + c]`` is
the JAX package's ``psi[r, i, b, c]``); row kk is zero.  :func:`port_layout`
converts.  The tables keep the JAX package's layout:
``hs (ntype, nslots, d, d)``, ``iz (kk,)``, ``cols (kk, nslots)``.  An
impurity's ``hs`` is the combined row table ``[hall; ee]`` (its ``_spmv18``
semantics): ``iz`` indexes its rows, the first ``nmax`` of them per-atom,
and ``iz_onsite`` the species of the onsite tables.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import block_kernels as bk
from .haydock_kernels import prefix_tables
from .lanczos import as_table, check_stages, grow_rows
from ..utils.timer import g_timer


def port_layout(psi: np.ndarray) -> np.ndarray:
    """(R, n, d, d) (the JAX package's layout) -> (n, d, R d)."""
    r, n, d, _ = psi.shape
    return np.ascontiguousarray(psi.transpose(1, 2, 0, 3).reshape(n, d, r * d))


class BlockOperator(nn.Module):
    """``H`` of the block recursion as device buffers, so that
    ``.to(device)`` moves the tables.

    Non-HoH: ``H psi = hs psi + lsham psi``.  HoH: ``H psi = hs psi -
    hso (hs psi) + (enim + lsham) psi``; ``-hso`` and ``enim + lsham`` are
    built here once per operator.  With ``nmax`` per-atom rows in front of
    ``hs``, K4 takes the route of :func:`~.block_kernels.local_zone`,
    planned once per device."""

    def __init__(self, hs, iz, cols, lsham, iz_onsite=None, hoh: bool = False,
                 hso=None, enim=None, nmax: int = 0):
        super().__init__()
        as_c = lambda a: as_table(a, torch.complex128)  # noqa: E731
        as_i = lambda a: as_table(a, torch.int32)  # noqa: E731
        self.hoh = bool(hoh)
        self.nmax = int(nmax)
        self._zone = None
        self.register_buffer("hs", as_c(hs))
        self.register_buffer("iz", as_i(iz))
        self.register_buffer("cols", as_i(cols))
        self.register_buffer("izo", as_i(iz if iz_onsite is None
                                          else iz_onsite))
        lsham = np.asarray(lsham)
        if self.hoh:
            self.register_buffer("onsite", as_c(np.asarray(enim) + lsham))
            self.register_buffer("hso_neg", as_c(-np.asarray(hso)))
        else:
            self.register_buffer("onsite", as_c(lsham))
            self.hso_neg = None

    @property
    def kk(self) -> int:
        return self.cols.shape[0]

    def zone(self) -> Optional[bk.LocalZone]:
        """K4's route for the local zone on the tables' device, or None."""
        dev = self.iz.device
        if self._zone is None or self._zone[0] != dev:
            self._zone = (dev, bk.local_zone(
                self.nmax, self.hs.shape[-1], self.iz, self.hs.shape[0],
                self.izo, self.onsite.shape[0]))
        return self._zone[1]

    def prefix(self, n: int) -> "BlockOperator":
        """The operator on the first ``n`` rows, every column beyond them
        sent to the zero row ``n`` (a wavefront stage).  It shares the
        tables, so that K4 packs them once for all stages, and takes the
        local zone's route on the same rows."""
        if n == self.kk:
            return self
        op = BlockOperator.__new__(BlockOperator)
        nn.Module.__init__(op)
        op.hoh, op.nmax = self.hoh, self.nmax
        for name, buf in self._buffers.items():
            op.register_buffer(name, buf)
        if not self.hoh:
            op.hso_neg = None
        op.iz, op.cols = prefix_tables(self.iz, self.cols, n)
        op.izo = self.izo[:n]
        zone = self.zone()
        op._zone = (self.iz.device, None if zone is None
                    else zone.prefix(n))
        return op

    def hs_apply(self, psi: torch.Tensor, plain: bool = False
                 ) -> torch.Tensor:
        """``hs psi`` with a zero row kk: the first K4 launch of an HoH
        application, which a caller may keep and pass as ``hpsi``."""
        step = bk.block_step_ref if plain else bk.block_step
        return step(self.hs, self.iz, self.cols, psi, pad=True,
                    zone=None if plain else self.zone())[0]

    def forward(self, psi: torch.Tensor, gram: bool = False,
                plain: bool = False, hpsi: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(H psi, Gram partials of psi^H H psi or None)``: one K4 launch,
        or two with HoH (one where the caller gives ``hpsi``, the
        :meth:`hs_apply` of this ``psi``); the plain versions with
        ``plain``."""
        step = bk.block_step_ref if plain else bk.block_step
        zone = None if plain else self.zone()
        if not self.hoh:
            return step(self.hs, self.iz, self.cols, psi, self.onsite,
                        self.izo, psi, gram=gram, zone=zone)
        if hpsi is None:
            hpsi = self.hs_apply(psi, plain)
        return step(self.hso_neg, self.iz, self.cols, hpsi, self.onsite,
                    self.izo, psi, add=hpsi[:self.kk], gram=gram, zone=zone)


def gram_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gram blocks ``out[r, a, c] = sum_{i,b} x[i, b, r d + a] y[i, b,
    r d + c]`` of (n, d, R d) arrays, one fused contraction; callers pass
    ``x`` already conjugated (the JAX package's convention)."""
    n, d, c = y.shape
    return torch.einsum("ibra,ibrc->rac", x.reshape(n, d, c // d, d),
                        y.reshape(n, d, c // d, d))


def block_times(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x[:, :, r] @ m[r]`` for every start block r: (n, d, R d) times
    (R, d, d)."""
    n, d, c = x.shape
    return torch.einsum("ibrc,rcx->ibrx", x.reshape(n, d, c // d, d),
                        m).reshape(n, d, c)


def pad_row(x: torch.Tensor) -> torch.Tensor:
    """(kk, d, C) -> (kk+1, d, C) with a zero row kk."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def eig_sqrt(b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``B = U sqrt(ev) U^H`` and ``B^-1`` from the Hermitian
    eigendecomposition (``crecal_b`` :1977-1999), with the JAX package's
    clamp of (near-)zero eigenvalues at Lanczos breakdown."""
    ev, u = torch.linalg.eigh(b2)
    ev = torch.maximum(ev, 1e-300 + 1e-14 * ev[..., -1:])
    lam = torch.sqrt(ev).to(b2.dtype)
    uh = u.conj().transpose(-1, -2)
    return (u * lam[..., None, :]) @ uh, (u / lam[..., None, :]) @ uh


def block_lanczos(op: BlockOperator, psi0: torch.Tensor, lld: int,
                  plain: bool = False,
                  stages: Optional[Sequence[Tuple[int, int]]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the block recursion from ``psi0`` (kk+1, d, R d) on ``op``'s
    device.  Returns (a_b, b2_b) of shape (lld, R, d, d) with the reference
    conventions: b2_b[0] = I, a_b[lld-1] = 0, b2_b[lld-1] = the last
    residual Gram.  ``plain=True`` runs the plain versions.  ``stages``
    ``((n, steps), ...)`` runs the steps on row prefixes of ``op``
    (:meth:`BlockOperator.prefix`), the vectors grown by zero rows between
    stages (the wavefront, :mod:`.wavefront`); ``psi0`` then holds the
    first stage's n + 1 rows."""
    kk1, d, c = psi0.shape
    r = c // d
    dev = psi0.device
    a_b = torch.zeros((lld, r, d, d), dtype=psi0.dtype, device=dev)
    b2_b = torch.zeros_like(a_b)
    sum_b = torch.eye(d, dtype=psi0.dtype, device=dev).expand(r, d, d)
    psi = psi0
    pmn = torch.zeros((kk1 - 1, d, c), dtype=psi0.dtype, device=dev)
    ll = 0
    for kk, steps in check_stages(stages, op.kk, kk1 - 1, lld - 1):
        op_n = op.prefix(kk)
        psi, pmn = grow_rows(psi, kk + 1), grow_rows(pmn, kk)
        for _ in range(steps):
            hpsi, g = op_n(psi, gram=True, plain=plain)
            a_ll = g.sum(0)
            pmn = hpsi - pmn
            pmn = pmn - block_times(psi[:kk], a_ll)
            b2 = gram_sum(pmn.conj(), pmn)
            b, b_i = eig_sqrt(b2)
            psi_new = pad_row(block_times(pmn, b_i))
            pmn = block_times(psi[:kk], b)
            psi = psi_new
            a_b[ll] = a_ll
            b2_b[ll] = sum_b
            sum_b = b2
            ll += 1
    b2_b[lld - 1] = sum_b
    return a_b, b2_b


def block_start_vectors(kk: int, atom_indices: Sequence[int],
                        device: torch.device) -> torch.Tensor:
    """Identity start blocks, one per atom: (kk+1, 18, 18 R) complex128 on
    ``device``, ``psi0[j_r, :, 18 r:18 (r+1)] = I`` (the JAX package's
    ``block_start_vectors`` in the port's layout)."""
    r = len(atom_indices)
    psi0 = torch.zeros((kk + 1, 18, 18 * r), dtype=torch.complex128,
                       device=device)
    eye = torch.eye(18, dtype=torch.complex128, device=device)
    for n, j in enumerate(atom_indices):
        psi0[j, :, 18 * n:18 * (n + 1)] = eye
    return psi0


class StartBlocks:
    """Start blocks in compact form: R chains of d x d blocks, chain r
    holding ``coef * I`` on each row of ``chains[r]`` (``[(row, coef),
    ...]``, written in that order) and zeros elsewhere on a (kk+1)-row
    cluster.  The recursion's routes materialise only what they recur
    (:meth:`dense`, :meth:`on_rows`, :meth:`select`), each in the timer's
    span ``start-blocks``; every block is written as ``coef * I``, so each
    form holds the dense tensor's bits on its rows.  ``shape`` and
    ``device`` are the dense tensor's, so the dispatch reads either."""

    def __init__(self, kk: int, chains, device, d: int = 18):
        self.kk, self.d = int(kk), int(d)
        self.chains = [tuple((int(row), coef) for row, coef in ch)
                       for ch in chains]
        self.device = torch.device(device)
        if any(not 0 <= row < self.kk for ch in self.chains
               for row, _ in ch):
            raise ValueError(f"start rows outside the cluster's {self.kk}")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.kk + 1, self.d, self.d * len(self.chains))

    @property
    def rows(self) -> np.ndarray:
        """The rows where some chain's block is nonzero, ascending."""
        return np.unique(np.array([row for ch in self.chains
                                   for row, coef in ch if coef != 0],
                                  dtype=np.int64))

    def sector(self, d: int) -> "StartBlocks":
        """The same chains d wide: a spin sector's cut of ``coef * I`` is
        ``coef`` times the sector's I."""
        return StartBlocks(self.kk, self.chains, self.device, d)

    def select(self, idx: Sequence[int]) -> "StartBlocks":
        """The chains ``idx`` (repeats allowed), in that order."""
        return StartBlocks(self.kk, [self.chains[int(i)] for i in idx],
                           self.device, self.d)

    def __getitem__(self, idx) -> "StartBlocks":
        """``[:, :, a:b]`` as on the dense tensor, where a and b bound whole
        chains: those chains."""
        rows, width, cols = idx
        a, b, step = cols.indices(self.shape[2])
        if ((rows, width) != (slice(None),) * 2 or step != 1
                or a % self.d or b % self.d):
            raise IndexError(f"start blocks take [:, :, a:b] of whole "
                             f"chains, not {idx!r}")
        return self.select(range(a // self.d, b // self.d))

    def _place(self, n: int, where) -> torch.Tensor:
        """(n, d, R d) zeros with each block at row ``where(row)``."""
        with g_timer.section("start-blocks"):
            out = torch.zeros((n, self.d, self.d * len(self.chains)),
                              dtype=torch.complex128, device=self.device)
            eye = torch.eye(self.d, dtype=torch.complex128,
                            device=self.device)
            for r, chain in enumerate(self.chains):
                cs = slice(self.d * r, self.d * (r + 1))
                for row, coef in chain:
                    out[where(row), :, cs] = coef * eye
            return out

    def dense(self) -> torch.Tensor:
        """(kk+1, d, R d) on ``device``: the full width's start tensor."""
        return self._place(self.kk + 1, lambda row: row)

    def on_rows(self, index, n: int) -> torch.Tensor:
        """(n+1, d, R d): row ``index[row]`` of the result holds row
        ``row``'s blocks, row n is zero (a wavefront's first stage, in the
        plan's order); raises where a start row lies beyond the first n.
        ``index`` is an array or a tensor on any device, of which only the
        chains' rows are read."""
        rows = sorted({row for ch in self.chains for row, _ in ch})
        at = dict(zip(rows, index[rows].tolist()))
        if any(at[row] >= n for row in self.rows.tolist()):
            raise ValueError("psi0 has nonzero rows outside the plan's "
                             "first stage")
        return self._place(n + 1, at.__getitem__)


def dense_start(psi0) -> torch.Tensor:
    """``psi0`` as the (kk+1, d, R d) tensor: a tensor as it is,
    :class:`StartBlocks` made dense."""
    return psi0.dense() if isinstance(psi0, StartBlocks) else psi0


def zsqr(b2_b: np.ndarray) -> np.ndarray:
    """Replace every B^2 block by its Hermitian square root
    (``zsqr`` :1980-2028).  b2_b: (lld, R, 18, 18), NumPy."""
    ev, u = np.linalg.eigh(b2_b)
    lam = np.sqrt(ev)
    return np.einsum("...ab,...b,...cb->...ac", u, lam, u.conj())
