"""Stages that run on every rank of a :mod:`.launch`: the multi-rank
routes of the port, each beside its single-rank counterpart on the same
inputs, with rank 0's results returned as numpy arrays.

The dry run (:mod:`..dryrun`), the CPU tests and the card's smoke run call
them by name (``"rslmtoasa_tpu_torch.parallel.stages:<name>"``).  The
inputs are made from seeds or passed in, so that the caller can hold the
results against the JAX package on the same tables
(:func:`layered_tables`, :func:`impurity_tables`).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..ops import rowslab
from ..ops.block_lanczos import BlockOperator, block_lanczos
from ..ops.chebyshev import chebyshev_moments
from ..ops.lanczos import HaydockOperator, block_spmv, scalar_start_vectors
from . import dispatch
from .mesh import (
    block_lanczos_sharded,
    chebyshev_moments_sharded,
    lanczos_sharded,
    make_mesh,
    rank_device,
    rowsharded_spmv_halo,
    rowsharded_spmv_step,
    total_dos_psum,
)

CHEB_WINDOW = (-1.5, 1.0)  # the bcc preset's moments stay bounded here
EXCHANGE_CHANNELS = 300  # energy points of the exchange runs


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _device(device=None) -> torch.device:
    """``device``, else the rank's; a stage run outside a launch must be
    given one."""
    if device is None:
        device = rank_device()
        if device is None:
            raise ValueError("no process group: pass the device")
    return torch.device(device)


class single_rank:
    """Within the block the dispatch takes no mesh (the JAX tests'
    ``_mesh_cache`` toggle)."""

    def __enter__(self):
        dispatch._mesh_cache.update(mesh=None, checked=True)

    def __exit__(self, *exc):
        dispatch._mesh_cache.update(mesh=None, checked=False)


def per_rank(mesh, *values) -> list:
    """Every rank's ``values`` (floats), in rank order."""
    t = torch.tensor(values, dtype=torch.float64)
    return [tuple(float(v) for v in x) for x in mesh.all_gather(t)]


def cheb_scale(window=CHEB_WINDOW):
    """(a, b) of the Chebyshev scaling for an energy window."""
    lo, hi = window
    return (hi - lo) / (2.0 - 0.3), (hi + lo) / 2.0


# ----------------------------------------------------------------------
# tables
def perturbed(rng, tab, scale=0.05):
    return tab + scale * (rng.standard_normal(tab.shape)
                          + 1j * rng.standard_normal(tab.shape))


def layered_tables(ee, lsham, cr, seed: int = 11, ntypes: int = 4):
    """A layered table of ``ntypes`` types (the surface's layer types):
    rows binned by their x coordinate, type k > 0 the bulk blocks
    perturbed.  Returns (hs, lsham, iz)."""
    rng = np.random.default_rng(seed)
    edges = np.quantile(cr[:, 0], np.linspace(0, 1, ntypes + 1)[1:-1])
    iz = np.digitize(cr[:, 0], edges).astype(np.int32)
    hs = np.concatenate([ee] + [perturbed(rng, ee) for _ in
                                range(ntypes - 1)])
    return hs, np.concatenate([lsham] * ntypes), iz


def impurity_tables(ee, iz, nmax: int = 6, seed: int = 11):
    """An impurity's combined table ``[hall; ee]``: the first ``nmax``
    rows per-atom (their species' blocks perturbed), then the species.
    Returns (hs, iz_rows, iz_onsite)."""
    rng = np.random.default_rng(seed)
    iz = np.asarray(iz, np.int32)
    hall = perturbed(rng, ee[iz[:nmax]])
    iz_rows = np.concatenate([np.arange(nmax), nmax + iz[nmax:]])
    return np.concatenate([hall, ee]), iz_rows.astype(np.int32), iz


def many(calls):
    """Several stages in one launch: ``calls`` is a list of (name of a
    function of this module, its keyword arguments); returns their
    results in order."""
    return [globals()[name](**kw) for name, kw in calls]


# ----------------------------------------------------------------------
# chain sharding
def chain_suite(lld: int = 6, nrec: int = 5, window=CHEB_WINDOW,
                single: bool = True):
    """Chain-sharded scalar and block recursions, the DOS all-reduce, and
    ``run_block``, ``run_chebyshev``, the exchange pairs and the
    conductivity units through the dispatch, each with ``single`` its
    single-rank result under the key with ``_1`` (the bcc preset, rc 8;
    the B2 preset, rc 6, for the conductivity)."""
    from ..models.conductivity import (
        ConductivityCalculation,
        build_velocity_operators,
    )
    from ..models.exchange import ExchangeCalculation
    from ..models.scf import ANG2AU
    from ..models.presets import build_synthetic_b2, build_synthetic_bcc
    from ..physics.energy_mesh import EnergyMesh

    dev = _device()
    mesh = make_mesh()
    out = {}

    def one(key, fn):
        """``fn()`` with no mesh, as ``out[key + "_1"]``."""
        if single:
            with single_rank():
                out[key + "_1"] = fn()

    bcc = build_synthetic_bcc(rc=8.0, ndim=2000, lld=lld, device=dev)
    hb, kk = bcc.ham, bcc.cluster.kk
    hs9 = hb.ee[:, :, :9, :9]
    psi0 = scalar_start_vectors(kk, [0, 1], dev)[:, :, :16].contiguous()
    out["scalar"] = tuple(map(_np, lanczos_sharded(
        mesh, hs9, hb.iz, hb.cols, psi0, lld)))
    one("scalar", lambda: tuple(map(_np, HaydockOperator(
        hs9, hb.iz, hb.cols).to(dev).coefficients(psi0, lld))))

    from ..ops.block_lanczos import block_start_vectors

    lsham = np.zeros((hb.ee.shape[0], 18, 18), np.complex128)
    op = BlockOperator(hb.ee, hb.iz, hb.cols, lsham).to(dev)
    p0 = block_start_vectors(kk, list(range(8)), dev)
    out["block"] = tuple(map(_np, block_lanczos_sharded(mesh, op, p0,
                                                         lld)))
    one("block", lambda: tuple(map(_np, block_lanczos(op, p0, lld))))
    ca, cb = cheb_scale(window)
    out["cheb"] = _np(chebyshev_moments_sharded(mesh, op, p0, lld, ca, cb))
    one("cheb", lambda: _np(chebyshev_moments(op, p0, lld, ca, cb)))

    per = 3  # chains on each rank
    dens = torch.ones((32, per), dtype=torch.float64, device=dev)
    out["dos"] = _np(total_dos_psum(mesh, dens))

    sysb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=5, nsp=2, device=dev)
    sysb.cluster.irec = np.ones(nrec, dtype=np.int64)
    out["run_block"] = sysb.run_block()
    one("run_block", sysb.run_block)
    sysb.cfg.energy.energy_min, sysb.cfg.energy.energy_max = window
    em = EnergyMesh.build(sysb.cfg.energy)
    out["run_cheb"] = sysb.run_chebyshev(em)
    one("run_cheb", lambda: sysb.run_chebyshev(em))

    pairs = np.array([[1, 2], [1, 3], [1, 4]])
    wd = tempfile.mkdtemp(prefix="rslmto_stage_x_")
    sysb.cfg.energy.channels_ldos = EXCHANGE_CHANNELS
    # run() applies predls after its build; applied once before both runs
    # it pins the potentials (the synthetic atom's c == enu makes it
    # idempotent), as the JAX package's dry run does
    for at in sysb.atoms:
        at.potential.predls(sysb.cluster.wav * ANG2AU)

    def jij(key):
        """Jij/Dij/Aij of the pairs under ``key``, their chains under
        ``key`` with ``_chains``."""
        calc = ExchangeCalculation(sysb, pairs, wd)
        res = calc.run()
        out[key.replace("exchange", "exchange_chains")] = (calc.a_b,
                                                           calc.b_b)
        return np.array([[r["jij"], *np.ravel(r["dmi"]),
                          *np.ravel(r["aij"])] for r in res])

    out["exchange"] = jij("exchange")
    one("exchange", lambda: jij("exchange_1"))

    sysc = build_synthetic_b2(rc=6.0, ndim=500, lld=4, nsp=2, device=dev)
    sysc.cfg.control.cond_ll = 4
    calc = ConductivityCalculation(sysc, wd)
    v_a, v_b, _, _ = build_velocity_operators(
        sysc, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    out["cond"] = _np(calc.compute_moments(v_a, v_b, 1.9, -0.2, 4))
    one("cond", lambda: _np(calc.compute_moments(v_a, v_b, 1.9, -0.2, 4)))
    return out


def chain_block(hs, lsham, iz, cols, starts, lld: int):
    """The chain-sharded block recursion of identity start blocks on the
    atoms ``starts`` and its single-rank result, with the backend's name
    (with one NCCL rank: its initialisation and CUDA-tensor all-gather)."""
    from ..ops.block_lanczos import block_start_vectors

    dev = _device()
    mesh = make_mesh()
    op = BlockOperator(hs, iz, cols, lsham).to(dev)
    p0 = block_start_vectors(cols.shape[0], list(starts), dev)
    t0 = time.perf_counter()
    got = tuple(map(_np, block_lanczos_sharded(mesh, op, p0, lld)))
    wall = time.perf_counter() - t0
    return {"block": got, "block_1": tuple(map(_np, block_lanczos(op, p0,
                                                                   lld))),
            "backend": mesh.backend, "world": mesh.world, "wall": wall,
            "device": str(dev)}


def pair_chains_sharded(lld: int = 5):
    """The pair chains of the bcc preset (rc 8, ``nsp=2``; the onsite pair
    and two nearest neighbours, R = 9) from their compact start blocks
    through the dispatch, chain-sharded over the ranks and on one rank,
    with each run's routes (``routes`` and ``local_routes`` of the
    dispatch) and every rank's shapes of the start tensors built (one per
    run)."""
    from ..models.exchange import pair_start_blocks
    from ..models.presets import build_synthetic_bcc
    from ..ops.block_lanczos import StartBlocks

    dev = _device()
    mesh = make_mesh()
    sysb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=lld, nsp=2, device=dev)
    hb = sysb.ham
    blocks = pair_start_blocks(sysb.cluster.kk,
                               np.array([[0, 0], [0, 1], [0, 2]]), dev)
    built, place = [], StartBlocks._place

    def recorded(self, n, where):
        out = place(self, n, where)
        built.append(tuple(out.shape))
        return out

    def run():
        built.clear()
        dispatch.routes.clear()
        dispatch.local_routes.clear()
        got = dispatch.block_lanczos_auto(hb.ee, hb.lsham, hb.iz, hb.cols,
                                          blocks, lld)
        return {"chains": got,
                "routes": dict(dispatch.routes + dispatch.local_routes),
                "built": per_rank(mesh, *(n for s in built for n in s))}

    StartBlocks._place = recorded
    try:
        out = {"sharded": run()}
        with single_rank():
            out["one"] = run()
    finally:
        StartBlocks._place = place
    return out


# ----------------------------------------------------------------------
# row slabs
def slab_recursions(hs, lsham, iz, cols, starts, lld: int, *, hoh=False,
                    hso=None, enim=None, iz_onsite=None, nmax: int = 0,
                    kinds=("block", "cheb"), window=CHEB_WINDOW,
                    single: bool = True, device=None):
    """Block recursion and Chebyshev moments (``kinds``) of the start
    blocks on the atoms ``starts``, on row slabs over the ranks, and with
    ``single`` on the whole table on this rank; ``"scalar"`` in ``kinds``
    runs the scalar recursion of the first start atom's 9 orbitals on the
    tables' upper-left 9 x 9 blocks.  Returns the results, the slab's
    rows and halo, and per kind its halo exchanges, the kernels' launches,
    the wall seconds and this rank's peak device memory, and every rank's
    wall, peak, own rows and halo rows (``ranks``)."""
    from ..ops import block_kernels as bk
    from ..ops import haydock_kernels as hk

    dev = _device(device)
    mesh = make_mesh()
    d = hs.shape[-1]
    kk = cols.shape[0]
    psi0 = torch.zeros((kk + 1, d, d * len(starts)), dtype=torch.complex128,
                       device=dev)
    for n, j in enumerate(starts):
        psi0[j, :, d * n:d * (n + 1)] = torch.eye(d, dtype=psi0.dtype)
    tabs = dict(hoh=hoh, hso=hso, enim=enim, iz_onsite=iz_onsite,
                nmax=nmax)
    ca, cb = cheb_scale(window)
    slab = rowslab.Slab(mesh, cols, dev)
    out = {"exchanges": {}, "wall": {}, "peak": {}, "launches": {},
           "ranks": {}, "halo": int(slab.nx - slab.n_own),
           "own": slab.n_own}
    kernels = {"spmv_dot": hk.spmv_dot, "update_norm": hk.update_norm,
               "spmv_dot_pipelined": hk.spmv_dot_pipelined,
               "block_step": bk.block_step}

    def timed(kind, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.barrier()
        slab.exchanges = 0
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["wall"][kind] = time.perf_counter() - t0
        out["exchanges"][kind] = slab.exchanges
        out["launches"][kind] = {n: k.launches for n, k in kernels.items()}
        out["peak"][kind] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
        out["ranks"][kind] = per_rank(mesh, out["wall"][kind],
                                      out["peak"][kind], slab.n_own,
                                      slab.nx - slab.n_own)
        return res

    if "block" in kinds:
        a_b, b2_b = timed("block", lambda: rowslab.block_lanczos_rowsharded(
            mesh, hs, lsham, iz, cols, psi0, lld, slab=slab, **tabs))
        out["block"] = (_np(a_b), _np(b2_b))
    if "cheb" in kinds:
        out["cheb"] = _np(timed("cheb", lambda: (
            rowslab.chebyshev_moments_rowsharded(
                mesh, hs, lsham, iz, cols, psi0, lld, ca, cb, slab=slab,
                **tabs))))
    if "scalar" in kinds:
        hs9 = np.ascontiguousarray(np.asarray(hs)[..., :9, :9])
        p9 = scalar_start_vectors(kk, starts[:1], dev)
        a, b2 = timed("scalar", lambda: rowslab.lanczos_rowsharded(
            mesh, hs9, iz, cols, p9, lld, slab=slab))
        out["scalar"] = (_np(a), _np(b2))
    if single:
        op = BlockOperator(hs, iz, cols, lsham, **tabs).to(dev)
        if "block" in kinds:
            out["block_1"] = tuple(map(_np, block_lanczos(op, psi0, lld)))
        if "cheb" in kinds:
            out["cheb_1"] = _np(chebyshev_moments(op, psi0, lld, ca, cb))
        if "scalar" in kinds:
            out["scalar_1"] = tuple(map(_np, HaydockOperator(
                hs9, iz, cols).to(dev).coefficients(p9, lld)))
    return out


def slab_cases(cases: dict, **common):
    """:func:`slab_recursions` of each named case (its keyword
    arguments, on top of ``common``), in one launch."""
    return {name: slab_recursions(**{**common, **kw})
            for name, kw in cases.items()}


def spmv_suite(seed: int = 7, nchain: int = 4):
    """The all-gather and the halo SpMV on the bcc preset (rc 8) against
    the whole table's SpMV on this rank, and the halo's rows per rank."""
    from ..models.presets import build_synthetic_bcc

    dev = _device()
    mesh = make_mesh()
    hb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=4, device=dev).ham
    kk = hb.cols.shape[0]
    rng = np.random.default_rng(seed)
    psi = torch.as_tensor(rng.standard_normal((kk, 9, nchain))
                          + 1j * rng.standard_normal((kk, 9, nchain)),
                          device=dev)
    hs9 = np.ascontiguousarray(hb.ee[:, :, :9, :9])
    y_step = rowsharded_spmv_step(mesh, hs9, hb.iz, hb.cols, psi)
    y_halo = rowsharded_spmv_halo(mesh, hs9, hb.iz, hb.cols, psi)
    x = torch.cat([psi, psi.new_zeros((1, 9, nchain))])
    y = block_spmv(torch.as_tensor(hs9, device=dev),
                   torch.as_tensor(hb.iz, device=dev),
                   torch.as_tensor(hb.cols, device=dev), x)
    return {"step": _np(y_step), "halo": _np(y_halo), "dense": _np(y),
            "psi": _np(psi)}


def dispatch_gate(budget: Optional[str], lld: int = 5):
    """``run_block``-style dispatch calls on the bcc preset (rc 8,
    ``nsp=2``, one rec atom) and the scalar dispatch (atoms 0 and 1)
    with ``RSLMTO_ROWSHARD_BYTES`` set to ``budget`` (unset for None);
    returns the results and the dispatch's routes."""
    from ..models.presets import build_synthetic_bcc

    if budget is None:
        os.environ.pop("RSLMTO_ROWSHARD_BYTES", None)
    else:
        os.environ["RSLMTO_ROWSHARD_BYTES"] = budget
    dev = _device()
    sysb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=lld, nsp=2, device=dev)
    dispatch.routes.clear()
    a_b, b2_b = sysb.run_block()
    hb = sysb.ham
    p9 = scalar_start_vectors(hb.cols.shape[0], [0, 1], dev)
    a, b2 = dispatch.lanczos_auto(hb.ee[:, :, :9, :9], hb.iz, hb.cols, p9,
                                  lld)
    return {"block": (a_b, b2_b), "scalar": (a, b2),
            "routes": dict(dispatch.routes)}


def exchange_run(arrays, potentials, cfg, pairs, device=None):
    """The exchange run of ``pairs`` on the system of
    :func:`..convert.system_to_numpy` (``arrays``, ``potentials``) with
    ``cfg`` on ``device`` (the rank's by default), through the dispatch:
    chain-sharded over the ranks where there is a process group.  Returns the pairs' Jij, Dij and Aij (mRy), the
    chains (``a_b``, ``b_b``), the wall and the peak device memory, and
    with ranks every rank's wall and peak."""
    import shutil

    import torch.distributed as dist

    from ..convert import system_from_numpy
    from ..models.exchange import ExchangeCalculation

    dev = _device(device)
    sys_ = system_from_numpy(arrays, potentials, dev, cfg=cfg)
    wd = tempfile.mkdtemp(prefix="rslmto_stage_x_")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    calc = ExchangeCalculation(sys_, pairs, wd)
    res = calc.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    shutil.rmtree(wd, ignore_errors=True)
    out = {"jij": np.array([[r["jij"], *np.ravel(r["dmi"]),
                             *np.ravel(r["aij"])] for r in res]),
           "chains": (calc.a_b, calc.b_b), "wall": wall, "peak": peak}
    if dist.is_initialized():
        out["ranks"] = per_rank(make_mesh(), wall, peak)
    return out


def exchange_roundoff(device=None, eps=(1e-15, 1e-12, 1e-9),
                      seeds=(0, 1, 2, 3), window=CHEB_WINDOW):
    """How far the exchange pair driver's Jij/Dij/Aij move when its chains
    move: the run of :func:`chain_suite`'s exchange stage on one rank,
    then each chain coefficient of ``a_b``/``b_b`` scaled by
    ``1 + e z`` (z complex normal from ``seed``) and Jij/Dij/Aij taken
    again from the same Green-function and integral code.  Returns
    ``{e: [(max |d chains|, max |d Jij/Dij/Aij| in mRy) per seed]}``:
    ``e`` at roundoff is what two sound runs whose chains differ there can
    read; ``e`` far above it, what a wrong chain reads."""
    from ..models.exchange import ExchangeCalculation
    from ..models.presets import build_synthetic_bcc
    from ..models.scf import ANG2AU
    from ..physics.energy_mesh import EnergyMesh

    dev = _device(device)
    sysb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=5, nsp=2, device=dev)
    sysb.cfg.energy.energy_min, sysb.cfg.energy.energy_max = window
    sysb.cfg.energy.channels_ldos = EXCHANGE_CHANNELS
    for at in sysb.atoms:
        at.potential.predls(sysb.cluster.wav * ANG2AU)
    wd = tempfile.mkdtemp(prefix="rslmto_stage_x_")
    calc = ExchangeCalculation(sysb, np.array([[1, 2], [1, 3], [1, 4]]), wd)

    def table(res):
        return np.array([[r["jij"], *np.ravel(r["dmi"]), *np.ravel(r["aij"])]
                         for r in res])

    base = table(calc.run())
    em = EnergyMesh.build(sysb.cfg.energy)
    a_b, b_b = calc.a_b.copy(), calc.b_b.copy()
    out = {}
    for e in eps:
        out[e] = []
        for seed in seeds:
            rng = np.random.default_rng(seed)

            def moved(x):
                z = (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
                return x * (1.0 + e * z) if np.iscomplexobj(x) else (
                    x * (1.0 + e * z.real))

            calc.a_b, calc.b_b = moved(a_b), moved(b_b)
            calc.intersite_gf(em)
            d_chain = max(float(np.abs(calc.a_b - a_b).max()),
                          float(np.abs(calc.b_b - b_b).max()))
            out[e].append((d_chain,
                           float(np.abs(table(calc._lkag(em)) - base).max())))
    return out


# ----------------------------------------------------------------------
# the command line
def cli_main(argv, env: Optional[dict] = None):
    """``python -m rslmtoasa_tpu_torch argv...`` on this rank (with the
    variables ``env`` set).  Returns its exit code, every rank's (wall
    seconds, peak device memory) and every rank's count of each of the
    dispatch's routes over the ranks (``dispatch.ROUTES``), so that the
    caller sees where the run went."""
    from ..cli import main

    for k, v in (env or {}).items():
        os.environ[k] = v
    dev = _device()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dispatch.routes.clear()
    t0 = time.perf_counter()
    rc = main(list(argv))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mesh = make_mesh()
    counts = per_rank(mesh, *(dispatch.routes[k] for k in dispatch.ROUTES))
    return {"rc": rc, "ranks": per_rank(mesh, wall, peak),
            "routes": [{k: int(n) for k, n in zip(dispatch.ROUTES, c) if n}
                       for c in counts]}
