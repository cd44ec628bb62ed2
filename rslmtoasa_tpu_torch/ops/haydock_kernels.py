"""The Haydock recursion's three device kernels, their plain versions and
their build.

* :func:`spmv_dot` (K1') -- ``y = H psi`` on the ELL/BSR layout plus the
  per-row-block partials of ``Re<psi|y>`` that give the Lanczos ``a``.
  Replaces ``rslmtoasa_tpu/ops/pallas_conv.py`` ``_spmv_kernel`` (via
  ``conv_spmv_df64_pallas``).
* :func:`spmv_dot_pipelined` (K2') -- the same ``y``, with the gathered
  rows of ``psi`` streamed through a 3-stage ring of ``cp.async`` copies
  in shared memory, and the finished per-chain ``a``: the last block to
  finish adds the row blocks' partials in index order.  Its ``y`` equals
  that of K1' bit for bit.  Replaces ``pallas_conv.py``
  ``_spmv_kernel_roll`` (via ``conv_spmv_df64_pallas_roll``), whose dot
  also leaves the kernel summed over the whole cluster.
* :func:`update_norm` (K3') -- one recursion step with the normalisation
  deferred, in one launch: the chain is kept unnormalised (``u_n = b_n
  psi_n``), and from ``v = H u_n``, ``u_n``, ``u_{n-1}`` and the chain's
  raw dot ``r = Re<u_n|v>``, ``b_n^2`` and ``b_{n-1}^2`` it writes
  ``u_{n+1} = v / b_n - (a_n / b_n) u_n - (b_n / b_{n-1}) u_{n-1}`` over
  ``u_{n-1}``, ``a_n = r / b_n^2`` and ``b_{n+1}^2 = |u_{n+1}|^2``,
  finished on the card (the last block to finish adds the row blocks'
  partials in the order of :func:`fold_norm`), and returns the row-block
  partials.  Or, given ``(alpha, beta, gamma)``, the generalised update
  ``alpha v + beta psi + gamma pmn``: at ``(1, -a, 1)`` the contract of
  ``pallas_conv.py`` ``_update_kernel`` (via ``lanczos_update_pallas``),
  which it replaces together with the normalisation the JAX loop runs
  after it.

Both SpMVs multiply on the FP64 tensor cores (``mma.sync`` m16n8k8 f64).
They read the type table realified and cut into the MMA's B fragments
(:func:`pack_table`, built once per operator and cached by
:func:`packed_table`).  :func:`spmv_packed_ref` multiplies through the
packed table as the kernels' fragments do, so the CPU tests hold the
packing against the plain product.

The CUDA sources are ``csrc/haydock.cu`` (``sm_90a``, plain C interface,
loaded with ctypes).  The library is built with nvcc into ``_build/`` at
first use, and again whenever the source is newer than the library.

Dispatch: a CPU tensor goes to the plain PyTorch version
(:func:`spmv_dot_ref`, :func:`spmv_dot_pipelined_ref`,
:func:`update_norm_ref`); a CUDA tensor launches the kernel or raises.
Each wrapper counts its kernel launches in its ``launches`` attribute.

K1' and K3' (kernels and plain versions) produce partials over the same
blocks of :data:`ROWS_PER_BLOCK` rows, shape ``(nrowblk, C)``; the caller
folds K1''s with ``.sum(0)``.  K2' returns the folded ``(C,)`` sum, and
K3' writes its own (a row slab's caller folds the gathered partials of
every slab with :func:`fold_norm`, as K3' folds one rank's).

The rows computed and the rows read may differ: ``psi`` holds ``nx + 1``
rows, ``nx >= kk``, its last row zero and ``nx`` the sentinel column, and
the kernels compute the first ``kk`` of them (a row slab of
:mod:`.rowslab`: its own rows, then the halo rows its columns reach).
The dots and norms cover the ``kk`` computed rows only.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import weakref
from typing import Tuple

import torch

from . import cuda_build
from .cuda_build import BUILD_DIR

ROWS_PER_BLOCK = 32  # = ROWS_PER_BLOCK in csrc/haydock.cu
NORB = 9
QUAD = 4  # complex inputs per MMA k-step (= QUAD in csrc/haydock.cu)
NTILE = 3  # n8 tiles over the 18 real outputs (= NTILE)
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use (H100)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "haydock.cu")
LIBRARY = os.path.join(BUILD_DIR, "libhaydock.so")


# ----------------------------------------------------------------------
# plain versions
def nrowblk(kk: int) -> int:
    return -(-kk // ROWS_PER_BLOCK)


def _block_partials(contrib: torch.Tensor) -> torch.Tensor:
    """(kk, C) per-row contributions -> (nrowblk, C) block sums."""
    kk, c = contrib.shape
    pad = nrowblk(kk) * ROWS_PER_BLOCK - kk
    if pad:
        contrib = torch.cat([contrib, contrib.new_zeros(pad, c)])
    return contrib.view(-1, ROWS_PER_BLOCK, c).sum(1)


GATHER_BYTES = 1 << 31  # the plain SpMV's largest gather of psi[cols]


def block_spmv(hs: torch.Tensor, iz: torch.Tensor, cols: torch.Tensor,
               psi: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_m hs[iz[i], m] @ psi[cols[i, m]]  ->  (kk, d, C).

    Plain gather + einsum, one einsum per type over that type's rows, in
    chunks of columns whose gather stays under :data:`GATHER_BYTES` (each
    output column reads only its own input column)."""
    kk, nslots = cols.shape
    d, c = psi.shape[1], psi.shape[2]
    step = max(1, GATHER_BYTES
               // max(1, kk * nslots * d * psi.element_size()))
    if step < c:
        return torch.cat([block_spmv(hs, iz, cols, psi[..., s:s + step])
                          for s in range(0, c, step)], dim=2)
    cols = cols.long()
    ntype = hs.shape[0]
    if ntype == 1:
        return torch.einsum("mab,imbc->iac", hs[0], psi[cols])
    y = psi.new_empty((kk,) + psi.shape[1:])
    iz = iz.long()
    for t in range(ntype):
        rows = torch.nonzero(iz == t).squeeze(1)
        y[rows] = torch.einsum("mab,imbc->iac", hs[t], psi[cols[rows]])
    return y


def prefix_tables(iz: torch.Tensor, cols: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row tables of the first ``n`` rows, with every column beyond
    them sent to the sentinel ``n``: the SpMV of an (n+1)-row ``psi`` whose
    rows from ``n`` on would be exact zeros (the wavefront's stage,
    ``rslmtoasa_tpu/ops/wavefront.py`` ``_clamp_cols``)."""
    if n == cols.shape[0]:
        return iz, cols
    c = cols[:n]
    return iz[:n], torch.where(c < n, c, n).to(cols.dtype).contiguous()


def _spmv_contrib(hs, iz, cols, psi) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = H psi and the per-row contributions (kk, C) to Re<psi|y>."""
    kk = cols.shape[0]
    y = block_spmv(hs, iz, cols, psi)
    p = psi[:kk]
    return y, (p.real * y.real + p.imag * y.imag).sum(1)


def spmv_dot_ref(hs, iz, cols, psi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`spmv_dot`."""
    y, contrib = _spmv_contrib(hs, iz, cols, psi)
    return y, _block_partials(contrib)


def spmv_dot_pipelined_ref(hs, iz, cols,
                           psi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`spmv_dot_pipelined`."""
    y, contrib = _spmv_contrib(hs, iz, cols, psi)
    return y, contrib.sum(0)


def run_length(n: int) -> int:
    """ceil(sqrt(n)): the row blocks of one run of :func:`fold_norm`."""
    r = math.isqrt(n)
    return r if r * r == n else r + 1


def fold_norm(part: torch.Tensor) -> torch.Tensor:
    """(nrowblk, C) row-block partials -> (C,), added in K3''s order: runs
    of :func:`run_length` row blocks, each in row-block order, then the
    runs in order.  On the same partials it gives K3''s bits."""
    nrb, c = part.shape
    ln = run_length(nrb)
    nrun = -(-nrb // ln)
    pad = nrun * ln - nrb  # zeros added last change no bit of a sum >= 0
    if pad:
        part = torch.cat([part, part.new_zeros(pad, c)])
    p = part.view(nrun, ln, c)
    runs = p[:, 0].clone()
    for j in range(1, ln):
        runs += p[:, j]
    total = runs[0].clone()
    for k in range(1, nrun):
        total += runs[k]
    return total


def update_coefficients(r, b2, b2_prev):
    """The deferred step's ``a`` and ``(alpha, beta, gamma)`` per chain from
    the raw dot ``r = Re<u_n|H u_n>``, ``b2 = |u_n|^2`` and ``b2_prev =
    |u_{n-1}|^2``, in K3''s order of operations."""
    a = r / b2
    sb = torch.sqrt(b2)
    return a, (1.0 / sb, -(a / sb), -(sb / torch.sqrt(b2_prev)))


def update_norm_ref(s, v, psi, pmn, b2_out, a_out=None) -> torch.Tensor:
    """Plain version of :func:`update_norm`, with its contract: the
    generalised update ``alpha v + beta psi[:kk] + gamma pmn[:kk]`` per
    chain written over ``pmn[:kk]``, its norm into ``b2_out`` and its
    row-block partials returned (``s`` the coefficients, or with
    ``a_out`` the deferred step's scalars)."""
    kk = v.shape[0]
    coef = s
    if a_out is not None:
        a, coef = update_coefficients(*s)
        a_out.copy_(a)
    alpha, beta, gamma = coef
    out = alpha * v + beta * psi[:kk] + gamma * pmn[:kk]
    part = _block_partials((out.real ** 2 + out.imag ** 2).sum(1))
    pmn[:kk] = out
    b2_out.copy_(fold_norm(part))
    return part


# ----------------------------------------------------------------------
# the SpMV kernels' packed type table
def nquads(nslots: int) -> int:
    return -(-NORB * nslots // QUAD)


def pack_table(hs: torch.Tensor) -> torch.Tensor:
    """The type table (ntype, nslots, d, d) realified and cut into
    ``mma.m16n8k8`` B fragments (d = 9 here, 9 or 18 for K4).

    Returns (ntype, nquad, NT, 32, 2) float64, nquad = ceil(d nslots / 4),
    NT = ceil(2 d / 8): entry ``[ty, j, nt, lane]`` is the pair (b0, b1)
    that lane ``lane = 4 g + t`` holds for quad j and n-tile nt.  Quad j
    takes the complex inputs q = 4 j + t, input q being orbital ``q % d``
    of slot ``q // d``; b0 weighs its real part, b1 its imaginary part,
    into real output n = 8 nt + g, which is orbital ``n // 2``, real part
    for even n.  That is the realified block [[Hr, -Hi], [Hi, Hr]].
    Padding (q >= d nslots, orbital >= d) is zero."""
    ntype, nslots, d = hs.shape[0], hs.shape[1], hs.shape[-1]
    dev = hs.device
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    nquad, ntile = -(-d * nslots // QUAD), -(-2 * d // 8)
    q = QUAD * torch.arange(nquad, device=dev)[:, None, None] + t
    n = 8 * torch.arange(ntile, device=dev)[None, :, None] + g
    m, b, a, ro = q // d, q % d, n // 2, n % 2
    valid = (q < d * nslots) & (a < d)  # (nquad, NT, 32)
    h = hs[:, m.clamp(max=nslots - 1), a.clamp(max=d - 1), b]
    b0 = torch.where(ro == 0, h.real, h.imag)
    b1 = torch.where(ro == 0, -h.imag, h.real)
    tab = torch.stack([b0, b1], -1)
    return torch.where(valid[..., None], tab, 0.0).contiguous()


_TABLES: dict = {}


def packed_table(hs: torch.Tensor, pack=pack_table) -> torch.Tensor:
    """``pack(hs)`` on its device (:func:`pack_table` by default), built
    once and cached while ``hs`` lives unchanged (the recursion passes the
    same ``hs`` at every step); ``packed_table.builds`` counts the packs."""
    key = (id(hs), pack)
    hit = _TABLES.get(key)
    if hit is not None:
        ref, ver, table = hit
        if ref() is hs and ver == hs._version:
            return table
    table = pack(hs)
    packed_table.builds += 1
    if len(_TABLES) >= 8:
        _TABLES.clear()
    _TABLES[key] = (weakref.ref(hs), hs._version, table)
    return table


packed_table.builds = 0  # tables packed (cache misses)


def spmv_packed_ref(table: torch.Tensor, iz: torch.Tensor,
                    cols: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """``y = H psi`` through the packed table, as the kernels' fragments
    combine it: the gathered inputs cut in quads, times the B fragments of
    each row's type, summed over quads and lanes t.  (kk, d, C)."""
    kk, nslots = cols.shape
    d, c = psi.shape[1], psi.shape[2]
    ntype, nquad, ntile = table.shape[:3]
    x = psi[cols.long()].reshape(kk, nslots * d, c)
    x = torch.cat([x, x.new_zeros(kk, QUAD * nquad - nslots * d, c)], 1)
    x = x.view(kk, nquad, QUAD, c)
    tab = table.view(ntype, nquad, ntile, 8, QUAD, 2)  # [.., nt, g, t, half]
    out = torch.zeros((kk, ntile, 8, c), dtype=torch.float64,
                      device=psi.device)
    iz = iz.long()
    for ty in range(ntype):
        rows = torch.nonzero(iz == ty).squeeze(1)
        xr = x[rows]
        out[rows] = (torch.einsum("rjtc,jngt->rngc", xr.real, tab[ty, ..., 0])
                     + torch.einsum("rjtc,jngt->rngc", xr.imag,
                                    tab[ty, ..., 1]))
    out = out.reshape(kk, ntile * 8, c)[:, :2 * d].view(kk, d, 2, c)
    return torch.complex(out[:, :, 0], out[:, :, 1])


# ----------------------------------------------------------------------
# build and load
def build_library() -> str:
    """Compile ``csrc/haydock.cu`` into ``_build/libhaydock.so``; returns
    nvcc's ``-Xptxas -v`` output."""
    return cuda_build.build(SOURCE, LIBRARY)


@functools.cache
def _library() -> ctypes.CDLL:
    cuda_build.ensure(SOURCE, LIBRARY)
    lib = ctypes.CDLL(LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.haydock_spmv_dot.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.haydock_spmv_dot.restype = ci
    lib.haydock_spmv_dot_pipelined.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.haydock_spmv_dot_pipelined.restype = ci
    lib.haydock_spmv_part.argtypes = [ci] + [vp] * 6 + [ci] * 5 + [vp]
    lib.haydock_spmv_part.restype = ci
    lib.haydock_spmv_smem.argtypes = [ci] * 4
    lib.haydock_spmv_smem.restype = ctypes.c_longlong
    lib.haydock_update_norm.argtypes = [ci] + [vp] * 12 + [ci] * 6 + [vp]
    lib.haydock_update_norm.restype = ci
    lib.haydock_rows_per_block.argtypes = []
    lib.haydock_rows_per_block.restype = ci
    if lib.haydock_rows_per_block() != ROWS_PER_BLOCK:
        raise RuntimeError("csrc/haydock.cu ROWS_PER_BLOCK differs from "
                           "haydock_kernels.ROWS_PER_BLOCK")
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def rows_read(x: torch.Tensor, kk: int) -> int:
    """``nx``, the sentinel of a kernel's input ``x`` of ``nx + 1`` rows,
    which must cover the ``kk`` rows the kernel computes."""
    nx = x.shape[0] - 1
    if nx < kk:
        raise ValueError(f"the input holds {nx + 1} rows, fewer than the "
                         f"{kk} + 1 the kernel needs")
    return nx


def _spmv_shape(hs, iz, cols, psi, what: str):
    """Checks the SpMV kernels' inputs; returns (device, ntype, nslots,
    kk, nx, C)."""
    dev = psi.device
    ntype, nslots = hs.shape[:2]
    kk = cols.shape[0]
    c = psi.shape[2]
    nx = rows_read(psi, kk)
    _check(hs, "hs", torch.complex128, (ntype, nslots, NORB, NORB), dev)
    _check(iz, "iz", torch.int32, (kk,), dev)
    _check(cols, "cols", torch.int32, (kk, nslots), dev)
    _check(psi, "psi", torch.complex128, (nx + 1, NORB, c), dev)
    if kk == 0 or c == 0:
        raise ValueError(f"{what} needs kk > 0 and C > 0")
    return dev, ntype, nslots, kk, nx, c


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no Haydock kernel for device {t.device}")


# ----------------------------------------------------------------------
# wrappers
def _spmv_setup(hs, iz, cols, psi, what: str, pipelined: bool):
    """Checks an SpMV's inputs and its shared memory; returns (device,
    ntype, nslots, kk, nx, C, library, packed table)."""
    dev, ntype, nslots, kk, nx, c = _spmv_shape(hs, iz, cols, psi, what)
    lib = _library()
    smem = lib.haydock_spmv_smem(int(pipelined), ntype, nslots, c)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: type table and buffers need {smem} B of "
                         f"shared memory, over the {_SMEM_LIMIT} B a block "
                         f"may use")
    return dev, ntype, nslots, kk, nx, c, lib, packed_table(hs)


def spmv_dot(hs, iz, cols, psi) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = H psi`` and the per-row-block partials of ``Re<psi|y>``.

    hs (ntype, nslots, 9, 9) complex128, iz (kk,) int32, cols
    (kk, nslots) int32 with sentinel nx, psi (nx+1, 9, C) complex128 whose
    row nx is zero (nx = kk but for a row slab).  Returns y (kk, 9, C) complex128 and apart
    (nrowblk, C) float64; ``apart.sum(0)`` is the chain's Lanczos ``a``.
    """
    if _route(psi) == "cpu":
        return spmv_dot_ref(hs, iz, cols, psi)
    dev, ntype, nslots, kk, nx, c, lib, table = _spmv_setup(
        hs, iz, cols, psi, "spmv_dot", False)
    y = torch.empty((kk, NORB, c), dtype=torch.complex128, device=dev)
    apart = torch.empty((nrowblk(kk), c), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.haydock_spmv_dot(
            _ptr(table), _ptr(iz), _ptr(cols), _ptr(psi),
            _ptr(y), _ptr(apart), ntype, nslots, kk, nx, c, _stream(dev))
    _raise_on(err, "haydock_spmv_dot")
    spmv_dot.launches += 1
    return y, apart


spmv_dot.launches = 0

_HALVES = {"gather": 2, "mma": 3}  # Mode in csrc/haydock.cu


def spmv_dot_half(hs, iz, cols, psi, half: str) -> None:
    """Measurement only: K1' on the card with only its gathers
    (``half="gather"``) or only its MMAs (``"mma"``), on the same grid,
    tiles and epilogue, for timing its two halves apart.  Its outputs mean
    nothing and are dropped; it counts no launch of K1'."""
    dev, ntype, nslots, kk, nx, c, lib, table = _spmv_setup(
        hs, iz, cols, psi, "spmv_dot_half", False)
    y = torch.empty((kk, NORB, c), dtype=torch.complex128, device=dev)
    apart = torch.empty((nrowblk(kk), c), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.haydock_spmv_part(
            _HALVES[half], _ptr(table), _ptr(iz), _ptr(cols),
            _ptr(psi), _ptr(y), _ptr(apart), ntype, nslots, kk, nx, c,
            _stream(dev))
    _raise_on(err, "haydock_spmv_part")


_TICKETS: dict = {}


def _ticket(dev: torch.device, n: int = 1) -> torch.Tensor:
    """``n`` int32 ticket counters for the current stream of ``dev`` (K2'
    takes one, K4 two, K3' one and one per row block and chain tile):
    zeroed once, and left zero by every launch (the blocks that take the
    last tickets reset them), so launches in stream order share them."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, n)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def spmv_dot_pipelined(hs, iz, cols,
                       psi) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = H psi`` and the finished per-chain ``a = Re<psi|y>``.

    Takes :func:`spmv_dot`'s inputs.  Returns y (kk, 9, C) complex128,
    equal to :func:`spmv_dot`'s bit for bit on the card, and a (C,)
    float64, the chain's Lanczos ``a``; reruns give the same bits.
    """
    if _route(psi) == "cpu":
        return spmv_dot_pipelined_ref(hs, iz, cols, psi)
    if psi.data_ptr() % 16:
        raise ValueError("psi: cp.async needs a 16-byte aligned start")
    dev, ntype, nslots, kk, nx, c, lib, table = _spmv_setup(
        hs, iz, cols, psi, "spmv_dot_pipelined", True)
    y = torch.empty((kk, NORB, c), dtype=torch.complex128, device=dev)
    a = torch.empty(c, dtype=torch.float64, device=dev)
    bpart = torch.empty((nrowblk(kk), c), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.haydock_spmv_dot_pipelined(
            _ptr(table), _ptr(iz), _ptr(cols), _ptr(psi),
            _ptr(y), _ptr(a), _ptr(bpart), _ptr(_ticket(dev)), ntype,
            nslots, kk, nx, c, _stream(dev))
    _raise_on(err, "haydock_spmv_dot_pipelined")
    spmv_dot_pipelined.launches += 1
    return y, a


spmv_dot_pipelined.launches = 0


# K3's launch shape (update_plan)
UPD_THREADS = 288  # threads a block at most (= UPD_THREADS in csrc)
UPD_CHAIN_TILE = 256  # chains a block at most
UPD_KR = (3, 2, 1)  # threads per chain, the kernel's instances
PIECE_ROWS = 2  # rows a piece (= UPD_PIECE in csrc)
UPD_EPT = 9  # a thread's elements a block at least, where the rows allow
UPD_BLOCKS_PER_SM = 2  # blocks per SM at least


def update_plan(kk: int, c: int, nsm: int) -> Tuple[int, int, int]:
    """K3''s launch shape for kk rows and C chains on a card of ``nsm``
    SMs: ``(ct, kr, rows)``, a block taking ``rows`` rows of ``ct`` chains
    with ``kr`` threads per chain.  The chains split into equal tiles of
    at most :data:`UPD_CHAIN_TILE`; ``kr`` is the largest of
    :data:`UPD_KR` that keeps a block within :data:`UPD_THREADS` (each
    thread then holds 6 to 18 elements of a piece, so a piece's partial
    costs a few adds); the rows are the fewest that give a thread
    :data:`UPD_EPT` elements, halved while the grid holds fewer than
    :data:`UPD_BLOCKS_PER_SM` blocks per SM, down to one piece (a 512-row
    prefix at C = 9: 256 blocks of 2 rows).  ``tools/k3_plans.py`` times
    every shape at the sizes the port launches (PERF.md §6)."""
    nct = -(-c // UPD_CHAIN_TILE)
    ct = -(-c // nct)
    kr = next(k for k in UPD_KR if k * ct <= UPD_THREADS)
    rows = PIECE_ROWS
    while rows < ROWS_PER_BLOCK and NORB * rows < UPD_EPT * kr:
        rows *= 2
    while (rows > PIECE_ROWS and nrowblk(kk) * (ROWS_PER_BLOCK // rows)
           * nct < UPD_BLOCKS_PER_SM * nsm):
        rows //= 2
    return ct, kr, rows


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_UPDATE_SETUPS: dict = {}


def _update_setup(kk: int, c: int, dev: torch.device, stream: int, plan):
    """K3''s launch shape (``plan`` or :func:`update_plan`), its scratch
    sizes and its zeroed counters (:func:`_ticket`) for kk rows and C
    chains on ``dev``'s ``stream``, made once."""
    key = (kk, c, dev.index, stream, plan)
    hit = _UPDATE_SETUPS.get(key)
    if hit is None:
        ct, kr, rows = plan or update_plan(kk, c, _sm_count(dev.index))
        nrb, ln, nct = nrowblk(kk), run_length(nrowblk(kk)), -(-c // ct)
        nrun = -(-nrb // ln)
        npieces = (nrb * (ROWS_PER_BLOCK // PIECE_ROWS)
                   if rows < ROWS_PER_BLOCK else 0)
        counter = _ticket(dev, 1 + (nrb + nrun) * nct)
        hit = (ct, kr, rows, ln, nrb * c, nrun * c, npieces * c, counter)
        if len(_UPDATE_SETUPS) >= 64:
            _UPDATE_SETUPS.clear()
        _UPDATE_SETUPS[key] = hit
    return hit


def update_norm(s, v, psi, pmn, b2_out, a_out=None,
                plan=None) -> torch.Tensor:
    """K3': ``out = alpha v + beta psi[:kk] + gamma pmn[:kk]`` per chain,
    written IN PLACE over ``pmn[:kk]``, in one launch.

    ``s`` is three (C,) float64 tensors: with ``a_out`` (C,) float64 the
    recursion's step with its normalisation deferred, ``s = (r, b2,
    b2_prev)``: the raw dot ``r = Re<psi|v>`` of the unnormalised chain,
    ``b2 = |psi|^2`` and ``b2_prev = |pmn|^2`` (any positive value where
    ``pmn`` is zero), and (:func:`update_coefficients`) ``a_out = r / b2``,
    ``alpha = 1 / sqrt(b2)``, ``beta = -a_out / sqrt(b2)``, ``gamma =
    -sqrt(b2) / sqrt(b2_prev)``; without it ``s = (alpha, beta, gamma)``.
    v (kk, 9, C) complex128; psi and pmn complex128 of at least kk rows
    (their first kk are read; pmn is another tensor than psi and v).
    Writes ``|out|^2`` into ``b2_out`` (C,) float64, summed on the card in
    :func:`fold_norm`'s order, and returns the row-block partials
    (nrowblk, C) float64.  ``plan`` overrides :func:`update_plan`
    (measurement only); the row-block partials do not depend on it.
    """
    if _route(psi) == "cpu":
        return update_norm_ref(s, v, psi, pmn, b2_out, a_out)
    dev = psi.device
    index = dev.index
    kk, c = v.shape[0], v.shape[2]
    scalars = (*s, b2_out) if a_out is None else (*s, b2_out, a_out)
    if not (kk and c and v.shape[1] == NORB
            and psi.shape[0] >= kk and pmn.shape[0] >= kk
            and psi.shape[1:] == v.shape[1:] == pmn.shape[1:]
            and all(t.dtype == torch.complex128 and t.is_contiguous()
                    and t.get_device() == index for t in (v, psi, pmn))
            and all(t.dtype == torch.float64 and t.shape == (c,)
                    and t.is_contiguous() and t.get_device() == index
                    for t in scalars)):
        raise ValueError(
            "update_norm: want v (kk, 9, C), psi and pmn (>= kk rows, 9, C) "
            f"complex128 and the scalars and outputs (C,) float64, all "
            f"contiguous on {dev}, kk, C > 0; got v {tuple(v.shape)}, psi "
            f"{tuple(psi.shape)}, pmn {tuple(pmn.shape)}, scalars "
            f"{[tuple(t.shape) for t in scalars]}")
    if pmn.data_ptr() in (psi.data_ptr(), v.data_ptr()):
        raise ValueError("update_norm: pmn must be another tensor than "
                         "psi and v")
    stream = torch._C._cuda_getCurrentRawStream(index)
    ct, kr, rows, ln, npart, nruns, npieces, counter = _update_setup(
        kk, c, dev, stream, plan)
    # one allocation: the partials, the runs' sums, the pieces' partials
    scratch = torch.empty(npart + nruns + npieces, dtype=torch.float64,
                          device=dev)
    base = scratch.data_ptr()
    args = (int(a_out is not None), s[0].data_ptr(), s[1].data_ptr(),
            s[2].data_ptr(), v.data_ptr(), psi.data_ptr(), pmn.data_ptr(),
            base, base + 8 * (npart + nruns) if npieces else base,
            base + 8 * npart, None if a_out is None else a_out.data_ptr(),
            b2_out.data_ptr(), counter.data_ptr(), kk, c, ct, kr, rows, ln,
            stream)
    lib = _library()
    if torch.cuda.current_device() == index:
        err = lib.haydock_update_norm(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.haydock_update_norm(*args)
    _raise_on(err, "haydock_update_norm")
    update_norm.launches += 1
    return scratch[:npart].view(-1, c)


update_norm.launches = 0
