"""The block recursion's device kernel K4, its plain version and its build.

:func:`block_step` (K4) computes, for a block width d in {9, 18} and R
start blocks side by side (C = R d columns),

    y[i] = add[i] + sum_m T[iz[i], m] x[cols[i, m]] + O[izo[i]] p[i]

and the per-row-tile partials of the Gram blocks ``p^H y``:
``G[t, r] = sum_{i in tile t} p[i, :, r]^H y[i, :, r]``, shape
``(nrowblk, R, d, d)``, where ``[:, r]`` is the d columns of start block r.
The caller folds the partials with ``.sum(0)``, as K1''s caller does.
``O`` (with ``izo`` and ``p``), ``add`` and the Gram are optional; ``pad``
returns y with a zero row kk appended, ready to be the next ``x``.

It replaces the XLA ops of ``rslmtoasa_tpu/ops/block_lanczos.py``
``_spmv18`` (:27), ``_onsite18`` (:66) and ``gram_sum`` (:73), as
``apply_h`` composes them (:147-159); the TPU had no Pallas kernel for the
step.  The CUDA source is ``csrc/block_step.cu`` (``sm_90a``, plain C
interface, loaded with ctypes), built with nvcc into ``_build/`` at first
use.

The kernel multiplies on the FP64 tensor cores (``mma.sync`` m16n8k8 f64):
each (row, column) pair is one GEMM row, its K axis the d inputs of every
slot and of the onsite block in quads of 4, its N axis the 2d real outputs.
It reads the type and onsite tables realified and cut into the MMA's B
fragments (``haydock_kernels.pack_table`` at width d, built once per table
and cached); ``haydock_kernels.spmv_packed_ref`` multiplies through them
as the fragments combine, so the CPU tests hold the packing against the
plain product.  A tile is :func:`rows_per_tile` rows of one start block, and
the Gram partials are per tile; the blocks draw tiles from a counter
(``haydock_kernels._ticket``), so that one slow tile holds up no block.
Where the tables of all types do not fit shared memory (two types at
d = 18), the kernel walks the slot quads in chunks (:func:`chunks`).

An impurity's combined row table ``[hall; ee]`` (one type per atom of its
local zone, then the species) takes a route of its own, planned once per
operator by :func:`local_zone`: the row tiles that hold the zone read the
combined tables from global memory, and every other tile the shared-memory
route on tables compacted to the types present there.  The plain version
takes the combined table as it is.

Dispatch: a CPU tensor goes to :func:`block_step_ref` (gather + einsum); a
CUDA tensor launches the kernel or raises.  The wrapper counts its launches
in ``block_step.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from . import cuda_build
from .haydock_kernels import _check, _ptr, _raise_on, _route, _stream, \
    _ticket, block_spmv, pack_table, packed_table

TILE_PAIRS = 288  # (row, column) pairs of a tile (= TILE_PAIRS in the .cu)
WIDTHS = (9, 18)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "block_step.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libblockstep.so")


def rows_per_tile(d: int) -> int:
    """Rows of one Gram partial: the kernel's tile of TILE_PAIRS / d rows."""
    return TILE_PAIRS // d


def nrowblk(kk: int, d: int) -> int:
    return -(-kk // rows_per_tile(d))


# ----------------------------------------------------------------------
# plain version
def gram_partials(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(nrowblk, R, d, d) tile sums of ``p[i, :, r]^H y[i, :, r]`` over the
    first kk = ``y.shape[0]`` rows of ``p``."""
    kk, d, c = y.shape
    r = c // d
    rows = torch.einsum("ibra,ibrc->irac", p[:kk].view(kk, d, r, d).conj(),
                        y.view(kk, d, r, d))
    rt = rows_per_tile(d)
    pad = nrowblk(kk, d) * rt - kk
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
    return rows.view(-1, rt, r, d, d).sum(1)


def block_step_ref(tab, iz, cols, x, onsite=None, izo=None, p=None,
                   add=None, gram: bool = False, pad: bool = False,
                   zone=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of :func:`block_step`: gather + einsum (``zone``, the
    kernel's route, changes nothing here)."""
    kk = cols.shape[0]
    y = block_spmv(tab, iz, cols, x)
    if onsite is not None:
        y = y + torch.einsum("iab,ibc->iac", onsite[izo.long()], p[:kk])
    if add is not None:
        y = add + y
    g = gram_partials(p, y) if gram else None
    if pad:
        y = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
    return y, g


# ----------------------------------------------------------------------
# the packed tables (haydock_kernels.pack_table, generic in d)
def pack_onsite(onsite: torch.Tensor) -> torch.Tensor:
    """:func:`pack_table` of the onsite table (nto, d, d) as one slot."""
    return pack_table(onsite[:, None])


# ----------------------------------------------------------------------
# the route of a table with a local zone
class LocalZone:
    """K4's plan for a row table whose first ``nmax`` rows are per-atom
    (an impurity's local zone in the combined table ``[hall; ee]``).

    The first ``nl`` rows, ``nmax`` rounded up to whole row tiles, read the
    tables as they are.  The rows from ``nl`` on read tables compacted to
    the types they use: ``types`` (sorted) of the row table with ``iz``
    renumbered into it, ``otypes`` of the onsite table with ``izo``
    (both 0 below ``nl``, where they are not read).

    ``pack`` and ``pack_onsite`` pack the rows of a table that the tiles
    past the zone read; K4's table cache keys on them, and a zone's
    :meth:`prefix` shares them, so that the stages of a wavefront pack
    each table once."""

    def __init__(self, nl, types, iz, otypes, izo, packs=None):
        self.nl, self.types, self.iz = nl, types, iz
        self.otypes, self.izo = otypes, izo
        self.pack, self.pack_onsite = packs or (
            lambda tab: pack_table(tab[types]),
            lambda onsite: pack_onsite(onsite[otypes]))

    def prefix(self, n: int) -> "LocalZone":
        """The same route on the first ``n`` rows."""
        return LocalZone(self.nl, self.types, self.iz[:n], self.otypes,
                         self.izo[:n], (self.pack, self.pack_onsite))


def local_zone(nmax: int, d: int, iz: torch.Tensor, ntab: int,
               izo: torch.Tensor, nto: int) -> Optional[LocalZone]:
    """The plan of :class:`LocalZone` for ``nmax`` per-atom rows at width
    ``d``, a row table of ``ntab`` types indexed by ``iz`` and an onsite
    table of ``nto`` types indexed by ``izo``; None without a zone."""
    if nmax <= 0:
        return None
    nl = -(-nmax // rows_per_tile(d)) * rows_per_tile(d)

    def compact(idx, n):
        types = torch.unique(idx[nl:].long())
        renum = torch.zeros(n, dtype=torch.int32, device=idx.device)
        renum[types] = torch.arange(types.numel(), dtype=torch.int32,
                                    device=idx.device)
        out = renum[idx.long()]
        out[:nl] = 0
        return types, out.contiguous()

    types, iz_b = compact(iz, ntab)
    otypes, izo_b = compact(izo, nto)
    return LocalZone(nl, types, iz_b, otypes, izo_b)


# ----------------------------------------------------------------------
# build and load
def build_library() -> str:
    """Compile ``csrc/block_step.cu`` into ``_build/libblockstep.so``;
    returns nvcc's ``-Xptxas -v`` output."""
    return cuda_build.build(SOURCE, LIBRARY)


@functools.cache
def _library() -> ctypes.CDLL:
    if not cuda_build.is_current(SOURCE, LIBRARY):
        build_library()
    lib = ctypes.CDLL(LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.block_step.argtypes = [ci] + [vp] * 15 + [ci] * 9 + [vp]
    lib.block_step.restype = ci
    lib.block_step_chunks.argtypes = [ci] * 6
    lib.block_step_chunks.restype = ci
    lib.block_step_tile_pairs.argtypes = []
    lib.block_step_tile_pairs.restype = ci
    if lib.block_step_tile_pairs() != TILE_PAIRS:
        raise RuntimeError("csrc/block_step.cu TILE_PAIRS differs from "
                           "block_kernels.TILE_PAIRS")
    return lib


def chunks(d: int, ntype: int, nto: int, nslots: int, onsite: bool,
           gram: bool) -> int:
    """Chunks of slot quads a launch of this shape walks on the current
    card: 1 when every type's table stays in shared memory."""
    n = _library().block_step_chunks(d, ntype, nto, nslots, int(onsite),
                                     int(gram))
    if n < 1:
        raise ValueError(f"block_step: {ntype} types of width {d} do not "
                         f"fit shared memory")
    return n


# ----------------------------------------------------------------------
# wrapper
def block_step(tab, iz, cols, x, onsite=None, izo=None, p=None, add=None,
               gram: bool = False, pad: bool = False,
               zone: Optional[LocalZone] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K4: ``y = add + H x + O p`` and the Gram partials of ``p^H y``.

    tab (ntype, nslots, d, d) complex128, iz (kk,) int32, cols (kk, nslots)
    int32 with sentinel kk, x (kk+1, d, C) complex128 whose row kk is zero;
    optional onsite (nto, d, d) with izo (kk,) int32, p (kk+1, d, C) (needed
    by the onsite term and the Gram), add (kk, d, C), and the route
    ``zone`` of a table with a local zone (:func:`local_zone` of these
    iz and izo).  Returns y (kk + pad, d, C), its row kk zero with ``pad``,
    and with ``gram`` the partials (nrowblk, R, d, d) complex128, else None.
    """
    if _route(x) == "cpu":
        return block_step_ref(tab, iz, cols, x, onsite, izo, p, add, gram,
                              pad)
    dev = x.device
    ntype, nslots, d = tab.shape[0], tab.shape[1], tab.shape[2]
    kk, c = cols.shape[0], x.shape[2]
    if d not in WIDTHS or c % d or kk == 0 or c == 0:
        raise ValueError(f"block_step: d={d} must be 9 or 18, C={c} a "
                         f"positive multiple of d, kk={kk} > 0")
    if gram and pad:
        raise ValueError("block_step: gram and pad do not combine")
    if (onsite is None) != (izo is None):
        raise ValueError("block_step: onsite and izo come together")
    if (onsite is not None or gram) and p is None:
        raise ValueError("block_step: the onsite term and the Gram need p")
    z = torch.complex128
    _check(tab, "tab", z, (ntype, nslots, d, d), dev)
    _check(iz, "iz", torch.int32, (kk,), dev)
    _check(cols, "cols", torch.int32, (kk, nslots), dev)
    _check(x, "x", z, (kk + 1, d, c), dev)
    nto = 0
    if onsite is not None:
        nto = onsite.shape[0]
        _check(onsite, "onsite", z, (nto, d, d), dev)
        _check(izo, "izo", torch.int32, (kk,), dev)
    if p is not None:
        _check(p, "p", z, (kk + 1, d, c), dev)
    if add is not None:
        _check(add, "add", z, (kk, d, c), dev)
    lib = _library()
    packed = packed_table(tab, pack_table)
    packed_on = None if onsite is None else packed_table(onsite, pack_onsite)
    # the local zone's tables (in global memory) and the compacted ones
    loc = (None,) * 4
    ntl, ntol, nl = 0, 0, 0
    if zone is not None:
        _check(zone.iz, "zone.iz", torch.int32, (kk,), dev)
        loc = (packed, iz, packed_on, izo)
        ntl, ntol, nl = ntype, nto, zone.nl
        packed, iz, ntype = packed_table(tab, zone.pack), zone.iz, \
            zone.types.numel()
        if onsite is not None:
            _check(zone.izo, "zone.izo", torch.int32, (kk,), dev)
            packed_on, izo, nto = packed_table(onsite, zone.pack_onsite), \
                zone.izo, zone.otypes.numel()
    y = torch.empty((kk + pad, d, c), dtype=z, device=dev)
    g = (torch.empty((nrowblk(kk, d), c // d, d, d), dtype=z, device=dev)
         if gram else None)
    opt = lambda t: None if t is None else _ptr(t)  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.block_step(
            d, _ptr(packed), _ptr(iz), _ptr(cols), _ptr(x), opt(packed_on),
            opt(izo), opt(p), opt(add), _ptr(y), opt(g), *map(opt, loc),
            _ptr(_ticket(dev, 2)), ntype, nto, ntl, ntol, nl, nslots, kk,
            int(pad), c, _stream(dev))
    _raise_on(err, "block_step")
    block_step.launches += 1
    return y, g


block_step.launches = 0
