"""The port's active-set wavefront against the JAX package's (CPU).

On the fixture of ``tests/test_wavefront.py`` (``build_synthetic_bcc(rc=45,
ndim=100000, lld=8, nsp=2)``, kk = 2 636):

* ``hop_distances``, the plan's permutation, ``n_read``, stages and work
  equal to the JAX package's, for the block, HoH and Chebyshev plans;
* the scalar, block (HoH off and on) and Chebyshev wavefronts within
  1e-10 abs of the JAX package's wavefronts and of the port's full-width
  route (the plain versions here: CPU tensors);
* the dispatch engages above ``RSLMTO_WAVEFRONT_KK`` and not below it,
  where the JAX package's rule does;
* with the threshold lowered in both packages (the plan then engages on
  this cluster): one SCF iteration on the scalar and on the block
  ``nsp=2`` path at the bars of ``tests/test_torch_block.py`` (etot 1e-9;
  fermi, ql and mom 1e-10), both command-line drivers' files within 1e-6,
  an impurity's block recursion (its per-atom rows reordered by the
  permutation) within 1e-10 of the JAX package's, and an exchange run's Jij/Dij/Aij within
  1e-8 mRy.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.models.exchange import ExchangeCalculation as JaxExchange
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu.ops import block_lanczos as jbl
from rslmtoasa_tpu.ops import lanczos as jlz
from rslmtoasa_tpu.ops import wavefront as jwf
from rslmtoasa_tpu.parallel import dispatch as jdispatch
from rslmtoasa_tpu_torch.cli import main as torch_cli
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models.exchange import ExchangeCalculation
from rslmtoasa_tpu_torch.models.scf import SelfConsistency
from rslmtoasa_tpu_torch.ops import wavefront as pwf
from rslmtoasa_tpu_torch.ops.block_lanczos import (
    BlockOperator,
    block_lanczos,
    block_start_vectors,
)
from rslmtoasa_tpu_torch.ops.chebyshev import chebyshev_moments
from rslmtoasa_tpu_torch.ops.lanczos import (
    HaydockOperator,
    scalar_start_vectors,
)
from rslmtoasa_tpu_torch.parallel import dispatch as pdispatch
from test_torch_block import _assert_printed_close
from test_torch_embedded import _jax_system as jax_embedded
from test_torch_exchange import _close
from test_torch_scf import _input_text

CPU = torch.device("cpu")
FIXTURE = dict(rc=45.0, ndim=100000, lld=8, nsp=2)
LOW = "1000"  # a threshold under the fixture's kk
AB = (1.5, -0.25)  # H~ = (H - b) / a of the Chebyshev wavefronts


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_block.py`` runs: the
    suite's worker processes share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def bcc():
    """The JAX package's fixture system and its tables as host arrays; the
    HoH tables are seeded (``tests/test_wavefront.py``'s)."""
    sys_ = jpresets.build_synthetic_bcc(**FIXTURE)
    hb = sys_.ham
    rng = np.random.default_rng(7)
    shape = hb.ee.shape
    return dict(
        kk=sys_.cluster.kk, ee=np.asarray(hb.ee), iz=np.asarray(hb.iz),
        cols=np.asarray(hb.cols), lsham=np.asarray(hb.lsham),
        hso=0.05 * (rng.standard_normal(shape)
                    + 1j * rng.standard_normal(shape)),
        enim=0.1 * np.eye(18)[None].repeat(shape[0], 0).astype(
            np.complex128))


def _jax_psi0(kk, starts):
    return np.asarray(jbl.block_start_vectors(kk, starts))


# ----------------------------------------------------------------------
# the plan
def _host(x):
    """A plan's field as a NumPy array (a tensor's copied to the host)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("tables", ["numpy", "torch"])
@pytest.mark.parametrize("granularity", [128, 512])
@pytest.mark.parametrize("kind,hops", [("lanczos", 1), ("lanczos", 2),
                                       ("chebyshev", 1)])
def test_plan_matches_jax(bcc, kind, hops, granularity, tables):
    """The plan from host arrays, and from torch tables (the BFS and the
    sort on the tables' device, as the dispatch makes it), against the JAX
    package's: the distances, ``perm``, ``inv``, ``n_read``, the stages,
    the work and the permuted tables equal."""
    kk, cols = bcc["kk"], bcc["cols"]
    starts = [0, 3]
    tabs = bcc["iz"], cols, bcc["iz"][::-1].copy()
    if tables == "torch":
        cols = pwf.device_table(cols, CPU)
        starts = torch.tensor(starts)
        tabs = tuple(pwf.device_table(t, CPU) for t in tabs)
    assert np.array_equal(_host(pwf.hop_distances(cols, kk, starts)),
                          jwf.hop_distances(bcc["cols"], kk, [0, 3]))
    mk = {"lanczos": (pwf.make_plan, jwf.make_plan),
          "chebyshev": (pwf.make_plan_chebyshev, jwf.make_plan_chebyshev)}
    got, want = (f(c, kk, s, 8, hops_per_step=hops, granularity=granularity)
                 for f, c, s in zip(mk[kind], (cols, bcc["cols"]),
                                    (starts, [0, 3])))
    assert torch.is_tensor(got.perm) == (tables == "torch")
    assert np.array_equal(_host(got.perm), want.perm)
    assert np.array_equal(_host(got.inv), want.inv)
    assert np.array_equal(got.n_read, want.n_read)
    assert got.stages == want.stages
    assert (got.work, got.dense_work, got.kk) == (
        want.work, want.dense_work, want.kk)
    wtabs = bcc["iz"], bcc["cols"], bcc["iz"][::-1].copy()
    for g, w in zip(got.permute_tables(*tabs), want.permute_tables(*wtabs)):
        assert np.array_equal(_host(g), w)


@pytest.mark.parametrize("tables", ["numpy", "torch"])
def test_unreachable_atoms_come_last(tables):
    """A ring of 40 atoms and, apart from it, a chain of 20 (its first
    atom also joined to the last): the BFS from start rows given twice
    reaches the ring only; the chain's atoms get ``kk + 1`` and come last
    in index order, as the JAX package's NumPy plan puts them."""
    kk, ring = 60, 40
    cols = np.full((kk, 3), kk, dtype=np.int32)
    cols[:, 0] = np.arange(kk)
    cols[:ring, 1] = (np.arange(ring) + 1) % ring
    cols[:ring, 2] = (np.arange(ring) - 1) % ring
    cols[ring:-1, 1] = np.arange(ring + 1, kk)
    cols[-1, 1] = ring
    starts = [7, 7, 30, 7]
    want = jwf.make_plan(cols, kk, starts, 5, granularity=8)
    dist = jwf.hop_distances(cols, kk, starts)
    assert (dist[ring:] == kk + 1).all() and dist[:ring].max() < kk + 1
    assert np.array_equal(want.perm[ring:], np.arange(ring, kk))
    c, s = cols, starts
    if tables == "torch":
        c, s = pwf.device_table(cols, CPU), torch.tensor(starts)
    n = pwf.plan_counts["levels"]
    got = pwf.make_plan(c, kk, s, 5, granularity=8)
    assert pwf.plan_counts["levels"] - n == dist[:ring].max() + 1
    assert np.array_equal(_host(pwf.hop_distances(c, kk, s)), dist)
    for f in ("perm", "inv", "n_read"):
        assert np.array_equal(_host(getattr(got, f)), getattr(want, f)), f
    assert got.stages == want.stages


# ----------------------------------------------------------------------
# the three recursions
def test_scalar_wavefront(bcc):
    kk, lld, starts = bcc["kk"], 8, [0, 3]
    hs = np.ascontiguousarray(bcc["ee"][:, :, :9, :9])
    args = hs, bcc["iz"], bcc["cols"]
    plan = pwf.make_plan(bcc["cols"], kk, starts, lld, granularity=128)
    assert plan.work < plan.dense_work
    psi0 = scalar_start_vectors(kk, starts, CPU)
    a_w, b_w = pwf.lanczos_coefficients_wavefront(*args, psi0, lld, plan)
    a_j, b_j = jwf.lanczos_coefficients_wavefront(
        *args, np.asarray(jlz.scalar_start_vectors(kk, starts)), lld,
        jwf.make_plan(bcc["cols"], kk, starts, lld, granularity=128))
    a_d, b_d = HaydockOperator(*args).coefficients(psi0, lld)
    for got, want in ((a_w, a_j), (b_w, b_j), (a_w, a_d.numpy()),
                      (b_w, b_d.numpy())):
        assert got.shape == want.shape == (lld, 18)
        assert np.abs(got - want).max() <= 1e-10


@pytest.mark.parametrize("hoh", [False, True])
def test_block_wavefront(bcc, hoh):
    kk, lld = bcc["kk"], 5 if hoh else 6
    kw = dict(hoh=True, hso=bcc["hso"], enim=bcc["enim"]) if hoh else {}
    tabs = bcc["ee"], bcc["lsham"], bcc["iz"], bcc["cols"]
    hops = 2 if hoh else 1
    plan = pwf.make_plan(bcc["cols"], kk, [0], lld, hops_per_step=hops,
                         granularity=128)
    psi0 = block_start_vectors(kk, [0], CPU)
    a_w, b_w = pwf.block_lanczos_wavefront(*tabs, psi0, lld, plan, **kw)
    a_j, b_j = jwf.block_lanczos_wavefront(
        *tabs, _jax_psi0(kk, [0]), lld,
        jwf.make_plan(bcc["cols"], kk, [0], lld, hops_per_step=hops,
                      granularity=128), **kw)
    op = BlockOperator(bcc["ee"], bcc["iz"], bcc["cols"], bcc["lsham"], **kw)
    a_d, b_d = block_lanczos(op, psi0, lld)
    for got, want in ((a_w, a_j), (b_w, b_j), (a_w, a_d.numpy()),
                      (b_w, b_d.numpy())):
        assert got.shape == want.shape == (lld, 1, 18, 18)
        assert np.abs(got - want).max() <= 1e-10


def test_chebyshev_wavefront(bcc):
    kk, lld = bcc["kk"], 6
    tabs = bcc["ee"], bcc["lsham"], bcc["iz"], bcc["cols"]
    plan = pwf.make_plan_chebyshev(bcc["cols"], kk, [0], lld,
                                   granularity=128)
    assert len(plan.stages) > 2  # the pre-step's stage, then growth
    psi0 = block_start_vectors(kk, [0], CPU)
    mu_w = pwf.chebyshev_moments_wavefront(*tabs, psi0, lld, *AB, plan)
    mu_j = jwf.chebyshev_moments_wavefront(
        *tabs, _jax_psi0(kk, [0]), lld, *AB,
        jwf.make_plan_chebyshev(bcc["cols"], kk, [0], lld, granularity=128))
    op = BlockOperator(bcc["ee"], bcc["iz"], bcc["cols"], bcc["lsham"])
    mu_d = chebyshev_moments(op, psi0, lld, *AB).numpy()
    assert mu_w.shape == mu_j.shape == (2 * lld + 2, 1, 18, 18)
    assert np.abs(mu_w - mu_j).max() <= 1e-10
    assert np.abs(mu_w - mu_d).max() <= 1e-10


def test_start_rows_outside_the_first_stage_raise(bcc):
    kk = bcc["kk"]
    plan = pwf.make_plan(bcc["cols"], kk, [0], 6)
    far = int(plan.perm[-1])
    with pytest.raises(ValueError, match="first stage"):
        pwf.permuted_start(block_start_vectors(kk, [0, far], CPU), plan)


# ----------------------------------------------------------------------
# the dispatch
@pytest.fixture
def lowered(monkeypatch):
    """Set ``RSLMTO_WAVEFRONT_KK`` for both packages (the JAX package on one
    device); returns the setter."""
    monkeypatch.setenv("RSLMTO_NO_MESH", "1")
    monkeypatch.setattr(jdispatch, "_mesh_cache",
                        {"mesh": None, "checked": False})

    def set_kk(value):
        monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", value)
    set_kk(LOW)
    return set_kk


def _spy(monkeypatch, module, names):
    """Count the calls of ``module``'s functions ``names``."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def counted(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, n, counted)
    return calls


@pytest.mark.parametrize("threshold", [LOW, "2636", "2637", "999999999"])
@pytest.mark.parametrize("kind,hoh,lld", [("lanczos", False, 8),
                                          ("lanczos", True, 8),
                                          ("lanczos", True, 4),
                                          ("lanczos", True, 3),
                                          ("chebyshev", False, 8),
                                          ("chebyshev", True, 3)])
def test_dispatch_plans_as_jax(bcc, lowered, threshold, kind, hoh, lld):
    """``_wavefront_plan`` engages exactly where the JAX package's does,
    with the same stages: above the threshold and where the plan's work is
    under 0.7 of the full width's (the HoH plan's is 0.88 at lld 8, 0.72
    at lld 4, 0.58 at lld 3)."""
    lowered(threshold)
    kk = bcc["kk"]
    psi0 = block_start_vectors(kk, [0, 3], CPU)
    got = pdispatch._wavefront_plan(bcc["cols"], psi0, lld, hoh, kind)
    want = jdispatch._wavefront_plan(bcc["cols"], kk, _jax_psi0(kk, [0, 3]),
                                     lld, hoh, kind=kind)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.stages == want.stages
        assert np.array_equal(got.perm, want.perm)
    engages = int(threshold) <= kk and not (
        hoh and kind == "lanczos" and lld >= 4)
    assert (got is not None) == engages


def test_dispatch_counts_its_plans(bcc, lowered, monkeypatch):
    """One plan a recursion that engages, made from the torch table on
    ``psi0``'s device, its BFS's levels counted; ``cols`` uploaded once a
    recursion (the plan and the permuted tables, or the full-width
    operator, share the upload); no plan below the threshold."""
    kk, cols = bcc["kk"], bcc["cols"]
    uploads = []
    upload = pwf.device_table

    def counted(t, device):
        uploads.append(t is cols)
        return upload(t, device)
    monkeypatch.setattr(pwf, "device_table", counted)
    psi0 = block_start_vectors(kk, [0, 3], CPU)
    levels = int(jwf.hop_distances(cols, kk, [0, 3]).max()) + 1
    for threshold, plans in ((LOW, 1), ("999999999", 0)):
        lowered(threshold)
        pwf.plan_counts.clear()
        uploads.clear()
        pdispatch.block_lanczos_auto(bcc["ee"], bcc["lsham"], bcc["iz"],
                                     cols, psi0, 6)
        assert pwf.plan_counts == ({"device_plans": 1, "levels": levels}
                                   if plans else {})
        assert uploads.count(True) == 1


def test_dispatch_routes_through_the_wavefront(bcc, lowered, monkeypatch):
    """Above the threshold the block, Chebyshev and scalar dispatches run
    the wavefront (per spin sector where the problem splits) and agree
    with the full width taken when it is raised."""
    calls = _spy(monkeypatch, pwf, ["lanczos_coefficients_wavefront",
                                    "block_lanczos_wavefront",
                                    "chebyshev_moments_wavefront"])
    kk = bcc["kk"]
    psi0 = block_start_vectors(kk, [0], CPU)
    sp = scalar_start_vectors(kk, [0], CPU)
    hs9 = np.ascontiguousarray(bcc["ee"][:, :, :9, :9])
    runs = {
        "block": lambda: pdispatch.block_lanczos_auto(
            bcc["ee"], bcc["lsham"], bcc["iz"], bcc["cols"], psi0, 6),
        "collinear": lambda: pdispatch.block_lanczos_auto(
            bcc["ee"], np.zeros_like(bcc["lsham"]), bcc["iz"], bcc["cols"],
            psi0, 6),
        "chebyshev": lambda: (pdispatch.chebyshev_moments_auto(
            bcc["ee"], bcc["lsham"], bcc["iz"], bcc["cols"], psi0, 6, *AB),),
        "scalar": lambda: pdispatch.lanczos_auto(
            hs9, bcc["iz"], bcc["cols"], sp, 8)}
    got = {k: run() for k, run in runs.items()}
    assert calls == {"lanczos_coefficients_wavefront": 1,
                     "block_lanczos_wavefront": 3,  # the collinear: two
                     "chebyshev_moments_wavefront": 1}
    lowered("999999999")
    for k, run in runs.items():
        for g, w in zip(got[k], run()):
            assert np.abs(g - w).max() <= 1e-10, k
    assert sum(calls.values()) == 5


# ----------------------------------------------------------------------
# SCFs, the command-line drivers, an impurity and exchange, engaged
def _scf_once(sys_, scf_cls, workdir):
    workdir.mkdir()
    scf = scf_cls(sys_, workdir=str(workdir))
    scf.run(nstep=1)
    pot = sys_.atoms[0].potential
    return dict(etot=pot.etot, fermi=scf.fermi, ql=pot.ql.copy(),
                mom=np.array(pot.mom))


@pytest.mark.parametrize("nsp", [1, 2])
def test_scf_iteration_matches_jax(lowered, monkeypatch, tmp_path, nsp):
    """One SCF iteration of the scalar (``nsp=1``) and block (``nsp=2``)
    paths, each recursion through the wavefront in both packages."""
    calls = _spy(monkeypatch, pwf, ["lanczos_coefficients_wavefront",
                                    "block_lanczos_wavefront"])
    jcalls = _spy(monkeypatch, jwf, ["lanczos_coefficients_wavefront",
                                     "block_lanczos_wavefront"])
    kw = dict(FIXTURE, nsp=nsp)
    want = _scf_once(jpresets.build_synthetic_bcc(**kw), JaxSCF,
                     tmp_path / "jax")
    got = _scf_once(presets.build_synthetic_bcc(device="cpu", **kw),
                    SelfConsistency, tmp_path / "torch")
    name = ("lanczos_coefficients_wavefront" if nsp == 1
            else "block_lanczos_wavefront")
    # two spin channels; nsp=2 couples the spins (spin-orbit): one d = 18
    assert calls[name] == jcalls[name] == (2 if nsp == 1 else 1)
    assert np.isfinite(got["etot"]) and got["etot"] < -2000.0
    assert abs(got["etot"] - want["etot"]) <= 1e-9
    assert abs(got["fermi"] - want["fermi"]) <= 1e-10
    assert np.abs(got["ql"] - want["ql"]).max() <= 1e-10
    assert np.abs(got["mom"] - want["mom"]).max() <= 1e-10


def test_cli_matches_jax_cli(lowered, tmp_path, capsys):
    """Both drivers on one block ``nsp=2`` input of the fixture, each
    through its wavefront: every written file within 1e-6."""
    src = tmp_path / "src"
    src.mkdir()
    JaxSCF(jpresets.build_synthetic_bcc(**FIXTURE),
           workdir=str(src)).save_checkpoints()
    os.rename(src / "X_out.nml", src / "X.nml")
    (src / "input.nml").write_text(
        _input_text(presets.synthetic_bcc_config(**FIXTURE)))
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    assert jax_cli([str(dirs["jax"] / "input.nml"),
                    f"output={dirs['jax']}"]) == 0
    assert torch_cli([str(dirs["torch"] / "input.nml"),
                      f"output={dirs['torch']}", "device=cpu"]) == 0
    capsys.readouterr()
    files = sorted(os.listdir(dirs["torch"]))
    assert files == sorted(os.listdir(dirs["jax"]))
    assert {"totaldos.out", "X_out.nml", "report.out"} <= set(files)
    for fname in files:
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_impurity_block_recursion(lowered, monkeypatch):
    """An impurity's block recursion on its combined row table ``[hall;
    ee]``: the wavefront against the JAX package's.  (The full width's
    plain K4 loops over the table's 64 row types: ~16 s here; the card's
    tests hold the full width.)"""
    calls = _spy(monkeypatch, pwf, ["block_lanczos_wavefront"])
    cfg = presets.synthetic_embedded_config("I", 60.0, 8, 2)
    psys = presets.build_synthetic_embedded(cfg, device="cpu")
    assert psys.cluster.kk == 3838 and psys.cluster.nmax == 60
    got = psys.run_block()
    assert calls["block_lanczos_wavefront"] == 1  # d = 18: spin-orbit
    want = jax_embedded(cfg).run_block()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8, 3, 18, 18)
        assert np.abs(g - w).max() <= 1e-10


def test_exchange_matches_jax(lowered, monkeypatch, tmp_path):
    """An exchange run (the onsite pair and the nearest neighbour) with its
    pair recursions through the wavefront: Jij, Dij and Aij within 1e-8
    mRy of the JAX package's."""
    calls = _spy(monkeypatch, pwf, ["block_lanczos_wavefront"])
    systems = []
    for mod, kw in ((jpresets, {}), (presets, {"device": "cpu"})):
        sys_ = mod.build_synthetic_bcc(**FIXTURE, **kw)
        sys_.cfg.energy.channels_ldos = 200
        systems.append(sys_)
    pairs = presets.exchange_pairs(systems[1].cluster, 1)
    want = JaxExchange(systems[0], pairs, str(tmp_path)).run()
    got = ExchangeCalculation(systems[1], pairs, str(tmp_path)).run()
    assert calls["block_lanczos_wavefront"] == 1
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("jij", "dmi", "aij"):
            assert _close(g[k], w[k]), k
    assert abs(got[0]["jij"]) > 1.0
