"""The port's row slabs (``ops/rowslab.py``, ``parallel/mesh.py``) over
gloo ranks on the CPU, against the JAX package.

Ranks are spawned through ``parallel/launch.py`` (one torch thread each,
a ``file://`` rendezvous in a fresh temporary directory) and run the
stages of ``parallel/stages.py``; the tables come from the JAX package's
presets, so that both packages recur the same arrays.

* The block recursion and the Chebyshev moments on slabs over 2 ranks
  against the JAX package's dense ones (1e-10 of scale): the bcc preset
  (``nsp=2``, spin-orbit coupling), with HoH (two halo exchanges per
  application), on a layered four-type table and on an impurity table
  with six per-atom rows (the JAX dry run's constructions,
  ``__graft_entry__.py`` :235-277); the scalar recursion on slabs equals
  the single rank's bit for bit and the JAX package's within 1e-12.
* Uneven slabs: the B2 preset (kk = 224) over 3 ranks.
* Over 4 ranks: the all-gather and the halo SpMV against the whole
  table's and the JAX package's (1e-12, as ``tests/test_sharding.py``),
  ``lanczos_rowsharded`` against the JAX package's
  ``lanczos_rowsharded`` (8 virtual devices) and its dense recursion, and
  the dispatch's gate: with ``RSLMTO_ROWSHARD_BYTES`` under the state
  the block and scalar dispatches run the slabs and agree with the routes
  without it.
* A world size of 1 gives today's route: no mesh, and the slab recursion
  on one slab is the whole table's bit for bit.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslmtoasa_tpu.models.presets import build_synthetic_b2 as jax_b2
from rslmtoasa_tpu.models.presets import build_synthetic_bcc as jax_bcc
from rslmtoasa_tpu.ops import block_lanczos as jbl
from rslmtoasa_tpu.ops import chebyshev as jch
from rslmtoasa_tpu.ops.lanczos import block_spmv as jax_spmv
from rslmtoasa_tpu.ops.lanczos import lanczos_coefficients as jax_lanczos
from rslmtoasa_tpu.ops.lanczos import scalar_start_vectors as jax_starts
from rslmtoasa_tpu.parallel.mesh import lanczos_rowsharded as jax_rows
from rslmtoasa_tpu.parallel.mesh import make_mesh as jax_mesh
from rslmtoasa_tpu_torch.parallel import launch, stages

LLD = 6
STARTS = [0, 7]
WINDOW = (-2.0, 1.5)  # every case's moments stay bounded here
# between a quarter of one chain's block state (6 kk d^2 16 B, kk = 180,
# d = 18) and all of it, and under the scalar state of 18 chains
BUDGET = 1_500_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread in this process while the module runs, as
    in ``test_torch_block``: with one thread per core in each of the
    suite's workers the CPU SCFs here oversubscribe the cores (the block
    CLI test took ~50 times as long in the 6-worker run as alone)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _run(n, calls):
    return launch.run("rslmtoasa_tpu_torch.parallel.stages:many", n,
                      device="cpu", calls=calls)


def _tables(hb, hoh=False):
    lsham = hb.lsham if hb.lsham is not None else np.zeros(
        (hb.ee.shape[0], 18, 18), np.complex128)
    t = dict(hs=np.asarray(hb.ee), lsham=np.asarray(lsham),
             iz=np.asarray(hb.iz, np.int32),
             cols=np.asarray(hb.cols, np.int32))
    if hoh:
        t.update(hoh=True, hso=np.asarray(hb.eeo), enim=np.asarray(hb.enim))
    return t


@pytest.fixture(scope="module")
def bcc_cases():
    """The four tables of the 2-rank run (JAX presets)."""
    sys_ = jax_bcc(rc=8.0, ndim=2000, lld=LLD, nsp=2, hoh=True)
    hb = sys_.ham
    base = _tables(hb)
    hs_l, lsh_l, iz_l = stages.layered_tables(base["hs"], base["lsham"],
                                              np.asarray(sys_.cluster.cr))
    hs_i, iz_r, iz_o = stages.impurity_tables(base["hs"], base["iz"])
    return {
        "bcc": dict(base, kinds=("block", "cheb", "scalar")),
        "hoh": _tables(hb, hoh=True),
        "layered": dict(base, hs=hs_l, lsham=lsh_l, iz=iz_l),
        "impurity": dict(base, hs=hs_i, iz=iz_r, iz_onsite=iz_o, nmax=6),
    }


@pytest.fixture(scope="module")
def slabs2(bcc_cases):
    return _run(2, [("slab_cases", dict(cases=bcc_cases, starts=STARTS,
                                        lld=LLD, window=WINDOW))])[0]


def _jax_dense(t, starts=STARTS, lld=LLD):
    """The JAX package's dense block recursion and moments of ``t``."""
    kk = t["cols"].shape[0]
    kw = dict(hoh=t.get("hoh", False),
              hso=None if t.get("hso") is None else jnp.asarray(t["hso"]),
              enim=None if t.get("enim") is None else jnp.asarray(t["enim"]),
              iz_onsite=(None if t.get("iz_onsite") is None
                         else jnp.asarray(t["iz_onsite"])))
    args = (jnp.asarray(t["hs"]), jnp.asarray(t["lsham"]),
            jnp.asarray(t["iz"]), jnp.asarray(t["cols"]),
            jnp.asarray(jbl.block_start_vectors(kk, starts)))
    a_b, b2_b = jbl.block_lanczos(*args, lld, **kw)
    mu = jch.chebyshev_moments(*args, lld, *stages.cheb_scale(WINDOW), **kw)
    return (np.asarray(a_b), np.asarray(b2_b)), np.asarray(mu)


def _close(got, want, tol, what):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale}"


@pytest.mark.parametrize("case", ["bcc", "hoh", "layered", "impurity"])
def test_block_and_chebyshev_slabs_match_jax(slabs2, bcc_cases, case):
    res, t = slabs2[case], bcc_cases[case]
    block, mu = _jax_dense(t)
    _close(res["block"], block, 1e-10, f"{case} block slabs vs JAX")
    _close(res["cheb"], mu, 1e-10, f"{case} Chebyshev slabs vs JAX")
    _close(res["block"], res["block_1"], 1e-12, f"{case} slabs vs 1 rank")
    _close(res["cheb"], res["cheb_1"], 1e-12, f"{case} slabs vs 1 rank")
    per = 2 if t.get("hoh") else 1
    assert res["exchanges"] == dict(
        {"block": per * (LLD - 1), "cheb": per * (LLD + 1)},
        **({"scalar": LLD - 1} if "scalar" in res else {}))
    assert 0 < res["halo"] < res["own"]


def test_scalar_slabs_bit_equal_single_rank(slabs2, bcc_cases):
    """K1''s and K3''s row-block partials gathered in the global order
    give the single rank's a and b2 bit for bit."""
    res, t = slabs2["bcc"], bcc_cases["bcc"]
    for g, w in zip(res["scalar"], res["scalar_1"]):
        np.testing.assert_array_equal(g, w)
    kk = t["cols"].shape[0]
    a, b2 = jax_lanczos(jnp.asarray(t["hs"][..., :9, :9]),
                        jnp.asarray(t["iz"]), jnp.asarray(t["cols"]),
                        jax_starts(kk, STARTS[:1]), LLD)
    _close(res["scalar"], (np.asarray(a), np.asarray(b2)), 1e-12,
           "scalar slabs vs JAX")


def test_uneven_slabs_b2_three_ranks():
    """kk = 224 over 3 ranks: slabs of 64, 96 and 64 rows."""
    t = _tables(jax_b2(rc=8.0, lld=LLD, nsp=2).ham)
    assert t["cols"].shape[0] == 224
    res = _run(3, [("slab_recursions", dict(
        t, starts=[0, 1], lld=LLD, window=WINDOW,
        kinds=("block", "cheb", "scalar")))])[0]
    block, mu = _jax_dense(t, [0, 1])
    _close(res["block"], block, 1e-10, "B2 block slabs vs JAX")
    _close(res["cheb"], mu, 1e-10, "B2 Chebyshev slabs vs JAX")
    for g, w in zip(res["scalar"], res["scalar_1"]):
        np.testing.assert_array_equal(g, w)
    assert res["own"] == 64


@pytest.fixture(scope="module")
def four_ranks():
    spmv, gate_on, gate_off = _run(4, [
        ("spmv_suite", {}),
        ("dispatch_gate", dict(budget=str(BUDGET))),
        ("dispatch_gate", dict(budget=None))])
    return spmv, gate_on, gate_off


def test_allgather_and_halo_spmv_match_dense(four_ranks):
    spmv = four_ranks[0]
    hb = jax_bcc(rc=8.0, ndim=2000, lld=4).ham
    x = np.concatenate([spmv["psi"], np.zeros((1, 9, 4))])
    want = np.asarray(jax_spmv(jnp.asarray(hb.ee[:, :, :9, :9]),
                               jnp.asarray(hb.iz), jnp.asarray(hb.cols),
                               jnp.asarray(x)))
    for k in ("step", "halo", "dense"):
        np.testing.assert_allclose(spmv[k], want, rtol=0, atol=1e-12)


def test_lanczos_rowsharded_matches_jax(four_ranks):
    """The port's slab recursion (4 ranks, the dispatch's gate open)
    against the JAX package's ppermute-ring ``lanczos_rowsharded`` on 8
    virtual devices and its dense recursion."""
    hb = jax_bcc(rc=8.0, ndim=2000, lld=5, nsp=2).ham
    kk = hb.kk
    n = 8
    kk_pad = -(-kk // n) * n
    iz_p = np.zeros(kk_pad, np.int32)
    iz_p[:kk] = hb.iz
    cols_p = np.full((kk_pad, hb.nslots), kk_pad, np.int32)
    cols_p[:kk] = np.where(hb.cols >= kk, kk_pad, hb.cols)
    psi = np.zeros((kk_pad, 9, 18), np.complex128)
    psi[:kk] = np.asarray(jax_starts(kk, [0, 1]))[:kk]
    hs9 = jnp.asarray(hb.ee[:, :, :9, :9])
    ring = jax_rows(jax_mesh(n), hs9, jnp.asarray(iz_p),
                    jnp.asarray(cols_p), jnp.asarray(psi), 5)
    dense = jax_lanczos(hs9, jnp.asarray(hb.iz), jnp.asarray(hb.cols),
                        jax_starts(kk, [0, 1]), 5)
    got = four_ranks[1]["scalar"]
    assert four_ranks[1]["routes"] == {"slab_block": 1, "slab_scalar": 1}
    _close(got, tuple(map(np.asarray, ring)), 1e-10, "vs JAX ring")
    _close(got, tuple(map(np.asarray, dense)), 1e-10, "vs JAX dense")


def test_gate_engages_under_rowshard_bytes(four_ranks):
    """``RSLMTO_ROWSHARD_BYTES`` under one chain's block state (and over
    its share on 4 ranks) sends the block recursion and the scalar chains
    to the slabs (the JAX package's
    ``test_lanczos_rowshard_hbm_route``); without it neither runs there,
    and both routes agree."""
    on, off = four_ranks[1], four_ranks[2]
    assert on["routes"] == {"slab_block": 1, "slab_scalar": 1}
    assert off["routes"] == {"chains_scalar": 1}
    _close(on["block"], off["block"], 1e-10, "block slabs vs 1 rank")
    _close(on["scalar"], off["scalar"], 1e-10, "scalar slabs vs chains")


def test_world_of_one_is_todays_route():
    """One gloo rank: the dispatch takes no mesh, and the slab recursion
    on its one slab is the whole table's, bit for bit."""
    import torch.distributed as dist

    from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc
    from rslmtoasa_tpu_torch.ops import rowslab
    from rslmtoasa_tpu_torch.ops.block_lanczos import (
        BlockOperator,
        block_lanczos,
        block_start_vectors,
    )
    from rslmtoasa_tpu_torch.parallel import dispatch, mesh

    rdv = tempfile.mkdtemp(prefix="rslmto_test_rdv_")
    assert mesh.init_distributed(0, 1, 0, device="cpu",
                                 init_method=f"file://{rdv}/r") == \
        torch.device("cpu")
    try:
        dispatch._mesh_cache.update(mesh=None, checked=False)
        assert dispatch.get_mesh() is None
        hb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=LLD, nsp=2,
                                 device="cpu").ham
        psi0 = block_start_vectors(hb.cols.shape[0], STARTS,
                                   torch.device("cpu"))
        got = rowslab.block_lanczos_rowsharded(
            mesh.make_mesh(), hb.ee, hb.lsham, hb.iz, hb.cols, psi0, LLD)
        want = block_lanczos(BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham),
                             psi0, LLD)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    finally:
        dispatch._mesh_cache.update(mesh=None, checked=False)
        mesh.shutdown()
    assert not dist.is_initialized()
