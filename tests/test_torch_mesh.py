"""The port's chain sharding (``parallel/mesh.py``, the dispatch's mesh
branches), its dry run and its CLI over gloo ranks on the CPU, against
one rank and the JAX package.

Ranks are spawned through ``parallel/launch.py`` (one torch thread each,
a ``file://`` rendezvous in a fresh temporary directory).

* The dry run (``python -m rslmtoasa_tpu_torch.dryrun 2 device=cpu``,
  here ``dryrun.run(2, "cpu")``) passes its bars, and its 2-rank results
  are held below; ``stages.chain_suite`` runs the same at 4 ranks.
* Chain sharding against one rank: the scalar recursion (16 chains)
  within 1e-12 -- not bit for bit: a rank's share recurs at another batch
  width, and torch's CPU products round differently there (~2e-16) --
  and the block recursion and Chebyshev moments (8 start blocks), the
  DOS all-reduce, ``run_block``, ``run_chebyshev`` (5 rec atoms, padded
  to a multiple of the ranks), the exchange pair driver (three pairs) and
  the conductivity's unit partition (B2, two types), within 1e-12 (the
  exchange's Jij, Dij, Aij within 1e-10 mRy, as the JAX dry run; the dry
  run's own bar on them, 1e-9 mRy, lies between what roundoff in the
  chains and what chains wrong at 1e-12 read).
* The same against the JAX package: its ``lanczos_sharded`` and
  ``block_lanczos_sharded`` on 8 virtual devices and its dense moments
  (1e-10), its ``run_block``/``run_chebyshev`` (1e-10), its exchange run
  (1e-8 mRy) and its conductivity moments (1e-10 of scale).
* The CLI at 2 ranks: the scalar SCF (9 chains, chain-sharded) and the
  block SCF (one rec atom, on row slabs with ``RSLMTO_ROWSHARD_BYTES``)
  write the files of the JAX CLI and of one rank within 1e-6, or one unit
  of a number's last printed digit (``test_torch_block``; rank 0
  writes the output directory, the other rank a temporary one of its
  own).
"""

import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import conductivity as jcond
from rslmtoasa_tpu.models.exchange import ExchangeCalculation as JaxExchange
from rslmtoasa_tpu.models.presets import build_synthetic_b2 as jax_b2
from rslmtoasa_tpu.models.presets import build_synthetic_bcc as jax_bcc
from rslmtoasa_tpu.models.scf import ANG2AU
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu.ops import block_lanczos as jbl
from rslmtoasa_tpu.ops import chebyshev as jch
from rslmtoasa_tpu.ops.lanczos import scalar_start_vectors as jax_starts
from rslmtoasa_tpu.parallel import dispatch as jdispatch
from rslmtoasa_tpu.parallel.mesh import block_lanczos_sharded as jax_bls
from rslmtoasa_tpu.parallel.mesh import lanczos_sharded as jax_ls
from rslmtoasa_tpu.parallel.mesh import make_mesh as jax_mesh
from rslmtoasa_tpu.physics.energy_mesh import EnergyMesh as JaxMesh
from rslmtoasa_tpu_torch import dryrun
from rslmtoasa_tpu_torch.cli import main as torch_cli
from rslmtoasa_tpu_torch.models.presets import synthetic_bcc_config
from rslmtoasa_tpu_torch.parallel import launch, stages
from test_torch_block import _assert_printed_close
from test_torch_scf import _input_text

WORLDS = (2, 4)


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


@pytest.fixture(scope="module")
def chain():
    """Rank 0's ``chain_suite`` at 2 ranks (from the dry run, with the
    single rank's results) and at 4 (without), the two launches side by
    side; the 4 ranks' results are held against the 2-rank run's single
    rank."""
    with ThreadPoolExecutor(2) as pool:
        dry = pool.submit(dryrun.run, 2, "cpu")
        four = pool.submit(
            launch.run, "rslmtoasa_tpu_torch.parallel.stages:chain_suite",
            4, device="cpu", single=False)
        dry, four = dry.result(), four.result()
    two = dict(dry["chain"], dry=dry)
    four.update({k: v for k, v in two.items() if k.endswith("_1")})
    return {2: two, 4: four}


def test_dry_run_passes_at_two_ranks(chain):
    dry = chain[2]["dry"]
    assert dry["world"] == 2
    assert set(dry["errors"]) == set(dryrun.BARS)
    assert dry["bars"] == dryrun.BARS
    for k, v in dry["errors"].items():
        assert v <= dryrun.BARS[k], (k, v)


def test_dry_run_exchange_bar_parts_roundoff_from_wrong_chains():
    """The dry run's Jij/Dij/Aij bar lies above what chains that differ by
    roundoff read (coefficients moved by 1e-15 of themselves) and below
    what chains wrong at 1e-12 read."""
    res = stages.exchange_roundoff(device="cpu", eps=(1e-15, 1e-12))
    bar = dryrun.BARS["exchange"]
    assert max(jij for _, jij in res[1e-15]) < bar / 5
    assert min(jij for _, jij in res[1e-12]) > bar * 5
    for e, runs in res.items():
        assert all(e <= d_chain < 10 * e for d_chain, _ in runs)


def _err(a, b):
    if isinstance(a, tuple):
        return max(_err(x, y) for x, y in zip(a, b))
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what", ["scalar", "block", "cheb", "run_block",
                                  "run_cheb", "cond"])
def test_chain_sharding_matches_one_rank(chain, world, what):
    res = chain[world]
    assert _err(res[what], res[what + "_1"]) <= 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_pairs_and_dos_match_one_rank(chain, world):
    res = chain[world]
    assert _err(res["exchange"], res["exchange_1"]) <= 1e-10
    np.testing.assert_array_equal(res["dos"], np.full(32, 3.0 * world))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's results on the stage's inputs."""
    out = {}
    mesh = jax_mesh(8)
    hb = jax_bcc(rc=8.0, ndim=2000, lld=6).ham
    hs9 = jnp.asarray(hb.ee[:, :, :9, :9])
    tabs = (jnp.asarray(hb.iz), jnp.asarray(hb.cols))
    psi0 = jnp.asarray(np.asarray(jax_starts(hb.kk, [0, 1]))[:, :, :16])
    out["scalar"] = tuple(map(np.asarray, jax_ls(mesh, hs9, *tabs, psi0,
                                                   6)))
    lsham = jnp.zeros((hb.ee.shape[0], 18, 18), jnp.complex128)
    p0 = jnp.asarray(jbl.block_start_vectors(hb.kk, list(range(8))))
    out["block"] = tuple(map(np.asarray, jax_bls(
        mesh, jnp.asarray(hb.ee), lsham, *tabs, p0, 6)))
    out["cheb"] = np.asarray(jch.chebyshev_moments(
        jnp.asarray(hb.ee), lsham, *tabs, p0, 6,
        *stages.cheb_scale()))

    sysb = jax_bcc(rc=8.0, ndim=2000, lld=5, nsp=2)
    sysb.cluster.irec = np.ones(5, dtype=np.int64)
    out["run_block"] = tuple(map(np.asarray, sysb.run_block()))
    sysb.cfg.energy.energy_min, sysb.cfg.energy.energy_max = \
        stages.CHEB_WINDOW
    out["run_cheb"] = np.asarray(sysb.run_chebyshev(
        JaxMesh.build(sysb.cfg.energy)))
    sysb.cfg.energy.channels_ldos = stages.EXCHANGE_CHANNELS
    for at in sysb.atoms:
        at.potential.predls(sysb.cluster.wav * ANG2AU)
    res = JaxExchange(sysb, np.array([[1, 2], [1, 3], [1, 4]]),
                      workdir=tempfile.mkdtemp(prefix="rslmto_jx_")).run()
    out["exchange"] = np.array([[r["jij"], *np.ravel(r["dmi"]),
                                 *np.ravel(r["aij"])] for r in res])

    sysc = jax_b2(rc=6.0, ndim=500, lld=4, nsp=2)
    sysc.cfg.control.cond_ll = 4
    v_a, v_b, _, _ = jcond.build_velocity_operators(
        sysc, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    jdispatch._mesh_cache.update(mesh=None, checked=True)  # one device
    try:
        out["cond"] = np.asarray(jcond.ConductivityCalculation(
            sysc).compute_moments(v_a, v_b, 1.9, -0.2, 4))
    finally:
        jdispatch._mesh_cache.update(mesh=None, checked=False)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what,tol", [
    ("scalar", 1e-10), ("block", 1e-10), ("cheb", 1e-10),
    ("run_block", 1e-10), ("run_cheb", 1e-10), ("exchange", 1e-8),
    ("cond", 1e-10)])
def test_chain_sharding_matches_jax(chain, jax_refs, world, what, tol):
    got, want = chain[world][what], jax_refs[what]
    scale = 1.0 if what == "exchange" else max(
        1.0, max(float(np.abs(w).max()) for w in (
            want if isinstance(want, tuple) else (want,))))
    assert _err(got, want) <= tol * scale


@pytest.mark.parametrize("recur", ["lanczos", "block"])
def test_cli_two_ranks_matches_jax_and_one_rank(tmp_path, capsys, recur):
    """``python -m rslmtoasa_tpu_torch`` on 2 ranks: the scalar SCF's 9
    chains split over the ranks; the block SCF's one rec atom on row slabs
    (the budget below its state, over half of it)."""
    nsp = 1 if recur == "lanczos" else 2
    preset = dict(rc=8.0, ndim=2000, lld=8, nsp=nsp)
    src = tmp_path / "src"
    src.mkdir()
    JaxSCF(jax_bcc(**preset), workdir=str(src)).save_checkpoints()
    os.rename(src / "X_out.nml", src / "X.nml")
    cfg = synthetic_bcc_config(**preset)
    assert cfg.control.recur == recur
    (src / "input.nml").write_text(_input_text(cfg))
    dirs = {}
    for name in ("jax", "one", "two"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    inp = lambda name: str(dirs[name] / "input.nml")  # noqa: E731
    assert jax_cli([inp("jax"), f"output={dirs['jax']}"]) == 0
    assert torch_cli([inp("one"), f"output={dirs['one']}",
                      "device=cpu"]) == 0
    kk = 180
    env = {} if recur == "lanczos" else {
        "RSLMTO_ROWSHARD_BYTES": str(6 * kk * 18 * 18 * 16 * 3 // 4)}
    before = set(os.listdir(dirs["two"]))
    out = launch.run("rslmtoasa_tpu_torch.parallel.stages:cli_main", 2,
                     device="cpu", argv=[inp("two"), f"output={dirs['two']}",
                                         "device=cpu"], env=env)
    assert out["rc"] == 0
    # every rank took the route over the ranks in every iteration
    route = "chains_scalar" if recur == "lanczos" else "slab_block"
    for counts in out["routes"]:
        assert counts.get(route, 0) >= 1 and set(counts) == {route}, counts
    capsys.readouterr()
    files = {k: set(os.listdir(d)) for k, d in dirs.items()}
    assert files["two"] == files["one"] == files["jax"]
    assert {"totaldos.out", "X_out.nml", "report.out"} <= files["two"]
    assert files["two"] - before  # the run wrote its files
    for fname in sorted(files["two"]):
        _assert_printed_close(dirs["jax"] / fname, dirs["two"] / fname)
        _assert_printed_close(dirs["one"] / fname, dirs["two"] / fname)
