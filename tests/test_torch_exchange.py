"""The port's exchange post-processing against the JAX package's (CPU).

Preset: the bcc preset ``build_synthetic_bcc(rc=8, nsp=2)`` (kk = 174) at
lld 8 with 200 energy points, the pairs of ``presets.exchange_pairs`` with
three shells (the onsite pair of atom 1 and one pair per shell: 13 live
chains, 16 in the JAX package) and the preset's trio; the Chebyshev runs
take the window (-1.5, 1.0).  Cases: block and Chebyshev, HoH off and on,
the collinear block run (``nsp=1``: two d = 9 spin sectors; the onsite pair
and the nn) and the bcc(001) slab of ``tests/test_torch_embedded.py``
(``calctype='S'``, pairs (1, 1) and (1, 2)) on the block and Chebyshev
recursions and with HoH (its atoms given an overlap).

* start blocks equal in the mapped layout;
* ``a_b``/``b_b`` within 1e-10 and ``mu`` within 1e-10 of scale, the dead
  chains' slots equal to the JAX package's (zeros, ``b_b[0] = I``);
* ``gij_full``/``gji_full`` computed by the port from the JAX package's
  chains within 1e-12 of scale plus lld - 1 times the JAX package's own
  movement when the energies move by one unit in the last place of the
  Hamiltonian's scale (``green_bar``): the real-axis Green function of a
  truncated chain has poles, and near one (E = -0.97 on this mesh) two
  packages' inverses of the same chains land ~1.5e-12 of scale apart;
* Jij/Dij/Aij, Jijk, the auxiliary-GF Jij, Gauss-Legendre, damping and
  inertia within 1e-8 (mRy; meV/a.u. for Jijk), or 1e-10 relative where
  the value exceeds 100; every written file within 1e-6 with one unit of
  the last printed digit allowed (``test_torch_block``);
* K4 (its plain version here) called lld - 1 times per block run, twice
  that with HoH, lld + 1 per Chebyshev run, per spin sector;
* ``bgreen`` with ``eta`` against the JAX package's at 1e-12; the plain
  SpMV in column chunks against one gather at 1e-14 of scale;
* the two-level closed-form damping and inertia (``tests/test_exchange.py``
  :126-190) on the port;
* the JAX system carried into the port by ``convert`` gives the JAX
  package's Jij/Dij/Aij;
* both command-line drivers on one exchange input, pairs and trio routes;
* on a 300-channel mesh (E = 1e-16 on it) the port's onsite pair completes
  where the JAX package raises (ROADMAP queue 3); the impurity cluster is
  refused, and the geometry exports (``write_artifacts``) are written beside
  ``exchange_p2rs``, ``conductivity_p2rs`` and ``orbital_modern``.
"""

import copy
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.models.exchange import ExchangeCalculation as JaxExchange
from rslmtoasa_tpu.models.exchange import pair_start_vectors as jax_starts
from rslmtoasa_tpu.physics import greens as jgreens
from rslmtoasa_tpu.physics.energy_mesh import EnergyMesh as JaxMesh
from rslmtoasa_tpu_torch import cli
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models import exchange as pex
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models.exchange import ExchangeCalculation
from rslmtoasa_tpu_torch.ops import block_kernels as bk
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.ops.block_lanczos import port_layout
from rslmtoasa_tpu_torch.physics import greens as pgreens
from rslmtoasa_tpu_torch.physics.energy_mesh import EnergyMesh
from test_torch_block import _assert_printed_close
from test_torch_embedded import _config as slab_config
from test_torch_embedded import _jax_system as jax_slab

CPU = torch.device("cpu")
RC, LLD, NE, NSHELL = 8.0, 8, 200, 3
WINDOW = (-1.5, 1.0)
ULP = 2.0**-52
CASES = ["block", "block-hoh", "chebyshev", "chebyshev-hoh", "block-nsp1",
         "S-block", "S-chebyshev", "S-block-hoh"]
# the slab's HoH case gives its atoms an overlap, so that eeo counts
OBAR = np.array([[-0.05, -0.055], [-0.04, -0.045], [-0.03, -0.035]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread per xdist worker, as in
    ``test_torch_block`` (the batched CPU inverses oversubscribe)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bcc_pair(nsp=2, hoh=False, ne=NE):
    """(JAX system, port system) of the bcc preset."""
    out = []
    for mod, kw in ((jpresets, {}), (presets, {"device": "cpu"})):
        sys_ = mod.build_synthetic_bcc(rc=RC, ndim=500, lld=LLD, nsp=nsp,
                                       hoh=hoh, **kw)
        sys_.cfg.energy.channels_ldos = ne
        out.append(sys_)
    return out


def _systems(case):
    """(JAX system, port system, 1-based pairs) of a case."""
    kind, *rest = case.split("-")
    if kind == "S":
        hoh = "hoh" in rest
        cfg = slab_config("S", 2, hoh)
        jsys = jax_slab(cfg)
        psys = presets.build_synthetic_embedded(cfg, hoh, device="cpu")
        for sys_ in (jsys, psys):
            sys_.cfg.control.recur = rest[0]
            if rest[0] == "chebyshev":
                sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = \
                    WINDOW
            if hoh:
                for at in sys_.atoms:
                    at.potential.obar[:] = OBAR
                sys_.build_hamiltonian()
                assert np.abs(sys_.ham.eeo).max() > 0.01
        return jsys, psys, np.array([[1, 1], [1, 2]])
    nsp1 = "nsp1" in rest
    jsys, psys = _bcc_pair(nsp=1 if nsp1 else 2, hoh="hoh" in rest)
    for sys_ in (jsys, psys):
        sys_.cfg.control.recur = kind
        if kind == "chebyshev":
            sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = WINDOW
    # the collinear run (two sectors) with the onsite pair and the nn
    return jsys, psys, presets.exchange_pairs(psys.cluster,
                                              1 if nsp1 else NSHELL)


def _exchange_and_analyses(xc, block):
    """run() and every analysis of an exchange run, into its workdir (the
    Gauss-Legendre files into ``gl/``); their returns by name."""
    out = {"run": xc.run(), "aux": xc.calculate_jij_auxgreen(),
           "damping": xc.calculate_gilbert_damping(),
           "inertia": xc.calculate_moment_of_inertia()}
    xc.calculate_exchange_twoindex()
    if block:
        wd = xc.workdir
        xc.workdir = os.path.join(wd, "gl")
        os.makedirs(xc.workdir)
        xc.run_gauss_legendre()
        xc.workdir = wd
    return out


@pytest.fixture(scope="module", params=CASES)
def runs(request, tmp_path_factory):
    case = request.param
    jsys, psys, pairs = _systems(case)
    block = psys.cfg.control.recur == "block"
    dirs = {k: tmp_path_factory.mktemp(f"{k}-{case}") for k in ("jax",
                                                                "torch")}
    jx = JaxExchange(jsys, pairs, str(dirs["jax"]))
    want = _exchange_and_analyses(jx, block)
    calls = []
    ref = bk.block_step_ref
    mp = pytest.MonkeyPatch()
    mp.setattr(bk, "block_step_ref",
               lambda *a, **kw: calls.append(1) or ref(*a, **kw))
    px = ExchangeCalculation(psys, pairs, str(dirs["torch"]))
    try:
        got = _exchange_and_analyses(px, block)
    finally:
        mp.undo()
    return dict(case=case, jx=jx, px=px, want=want, got=got, dirs=dirs,
                k4_calls=len(calls))


# ----------------------------------------------------------------------
# the pair recursion
def test_pair_start_vectors_match_jax():
    _, psys = _bcc_pair()
    kk = psys.cluster.kk
    pairs = presets.exchange_pairs(psys.cluster, NSHELL) - 1
    want = jax_starts(kk, pairs)
    chains = pex.pair_chains(pairs)
    assert len(chains) == 1 + 4 * NSHELL and want.shape[0] == 4 * (
        NSHELL + 1)
    dead = np.setdiff1d(np.arange(want.shape[0]), chains)
    assert dead.tolist() == [1, 2, 3] and not want[dead].any()
    got = pex.pair_start_blocks(kk, pairs, CPU).dense()
    assert torch.equal(got, torch.from_numpy(port_layout(want[chains])))


def test_recursion_matches_jax(runs):
    jx, px = runs["jx"], runs["px"]
    dead = np.setdiff1d(np.arange(4 * len(px.pairs)), px.chains)
    if px.cfg.control.recur == "chebyshev":
        scale = np.abs(jx.mu).max()
        assert np.abs(px.mu - jx.mu).max() <= 1e-10 * max(1.0, scale)
        assert np.array_equal(px.mu[:, dead], jx.mu[:, dead])
        assert not px.mu[:, dead].any()
        return
    assert np.abs(px.a_b - jx.a_b).max() <= 1e-10
    assert np.abs(px.b_b - jx.b_b).max() <= 1e-10
    for got, want in ((px.a_b, jx.a_b), (px.b_b, jx.b_b)):
        assert np.array_equal(got[:, dead], want[:, dead])
    if len(dead):
        assert not px.a_b[:, dead].any() and not px.b_b[1:, dead].any()
        assert np.array_equal(px.b_b[0, dead[0]], np.eye(18))


def test_k4_calls_per_run(runs):
    """One H application is one K4 call, two with HoH, per spin sector:
    lld - 1 applications per block run, lld + 1 per Chebyshev run."""
    px = runs["px"]
    per_h = 2 if px.cfg.hamiltonian.hoh else 1
    sectors = 2 if px.cfg.control.nsp == 1 else 1
    steps = LLD + 1 if px.cfg.control.recur == "chebyshev" else LLD - 1
    assert runs["k4_calls"] == per_h * sectors * steps


def green_bar(green, recur_scale, em, lld):
    """1e-12 of the scale of ``green(em)`` plus lld - 1 times its largest
    movement when the energies move by one unit in the last place of the
    Hamiltonian's scale ``recur_scale``, either way: each of the
    continued fraction's lld - 1 inverses rounds like such a move.
    ``green(em)`` returns a dict of arrays; returns (them, their bars)."""
    want = green(em)
    spread = {k: 0.0 for k in want}
    d = ULP * (np.abs(em.ene).max() + recur_scale)
    for sgn in (1.0, -1.0):
        moved = green(dataclasses.replace(em, ene=em.ene + sgn * d))
        for k, w in want.items():
            spread[k] = np.maximum(spread[k], np.abs(moved[k] - w))
    return want, {k: 1e-12 * np.abs(w).max() + (lld - 1) * spread[k]
                  for k, w in want.items()}


def test_green_functions_match_jax(runs):
    """The port's intersite Green functions from the JAX package's chains,
    within :func:`green_bar` of the JAX package's: the real-axis Green
    function has poles, and near one both packages' inverses round apart
    by more than 1e-12 of scale (ROADMAP queue 3)."""
    jx = copy.copy(runs["jx"])
    px = copy.copy(runs["px"])
    keys = ("gij_full", "gji_full")
    if px.cfg.control.recur == "chebyshev":
        px.mu = jx.mu
        lo, hi = px.cfg.energy.energy_min, px.cfg.energy.energy_max
        scale = (hi - lo) / 1.7 + abs(hi + lo) / 2  # the window's bound

        def green(em):
            jx._intersite_gf(None, None, em, mu=jx.mu)
            return {k: getattr(jx, k) for k in keys}
    else:
        px.a_b, px.b_b = jx.a_b, jx.b_b
        scale = np.abs(jx.a_b).max() + 2 * np.abs(jx.b_b).max()

        def green(em):
            jx._intersite_gf(jx.a_b, jx.b_b, em)
            return {k: getattr(jx, k) for k in keys}
    px.intersite_gf(EnergyMesh.build(px.cfg.energy))
    want, bar = green_bar(green, scale, JaxMesh.build(jx.cfg.energy), LLD)
    for k, w in want.items():
        got = getattr(px, k).numpy()
        assert got.shape == w.shape
        assert (np.abs(got - w) <= bar[k]).all(), k
    for k in "nxyz":
        assert torch.equal(px.comps_i[k], pex._spin_components(
            px.gij_full.permute(0, 3, 1, 2))[k].permute(0, 2, 3, 1))


# ----------------------------------------------------------------------
# what the calculation gives and writes
def _close(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    bar = np.where(np.abs(want) > 100, 1e-10 * np.abs(want), 1e-8)
    return got.shape == want.shape and bool((np.abs(got - want) <= bar).all())


def test_lkag_matches_jax(runs):
    got, want = runs["got"]["run"], runs["want"]["run"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["i"], g["j"], g["iz_i"], g["iz_j"]) == (
            w["i"], w["j"], w["iz_i"], w["iz_j"])
        assert np.array_equal(g["rij"], w["rij"]) and g["dist"] == w["dist"]
        for k in ("jij", "dmi", "aij"):
            assert _close(g[k], w[k]), k
    assert abs(got[0]["jij"]) > 1.0  # the onsite pair's J0


def test_analyses_match_jax(runs):
    for name in ("aux", "damping", "inertia"):
        assert _close(runs["got"][name], runs["want"][name]), name


def test_outputs_match_jax(runs):
    dirs = runs["dirs"]
    names = sorted(os.listdir(dirs["torch"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    block = runs["px"].cfg.control.recur == "block"
    assert {"jij.out", "dij.out", "aij.out", "jtens.out", "jijso.out",
            "fort.150", "jij_aux.out", "alldampings.out",
            "example-real.out"} <= set(names)
    assert ("gl" in names) == block
    for sub in (["."] + (["gl"] if block else [])):
        files = sorted(os.listdir(dirs["torch"] / sub))
        assert files == sorted(os.listdir(dirs["jax"] / sub))
        for fname in files:
            if (dirs["torch"] / sub / fname).is_file():
                _assert_printed_close(dirs["jax"] / sub / fname,
                                      dirs["torch"] / sub / fname)


def test_carried_state_gives_jax_exchange(tmp_path):
    """The JAX system's arrays carried into the port by ``convert``: the
    port's exchange run gives the JAX package's Jij/Dij/Aij."""
    jsys, _ = _bcc_pair()
    pairs = presets.exchange_pairs(jsys.cluster, NSHELL)
    arrays, pots = system_to_numpy(jsys)
    psys = system_from_numpy(arrays, pots, CPU, cfg=copy.deepcopy(
        _bcc_pair()[1].cfg))
    out = []
    for cls, sys_, name in ((JaxExchange, jsys, "jax"),
                            (ExchangeCalculation, psys, "torch")):
        (tmp_path / name).mkdir()
        out.append(cls(sys_, pairs, str(tmp_path / name)).run())
    for g, w in zip(out[1], out[0]):
        for k in ("jij", "dmi", "aij"):
            assert _close(g[k], w[k]), k


def test_jijk_matches_jax(tmp_path):
    """The trio route: the three pairs of the preset's trio, then Jijk, on
    the 300-channel mesh.  The 200-channel mesh holds E = -0.4, the s
    band's C, where P = 0 and both packages' rescale P / P0 is 0 / 0: every
    component is NaN in both there (``test_cli_matches_jax_cli[trio]``;
    ROADMAP queue 3)."""
    jsys, psys = _bcc_pair(ne=300)
    trios = presets.synthetic_exchange(psys, NSHELL).cfg.lattice.ijktrio
    out = []
    for cls, sys_, name in ((JaxExchange, jsys, "jax"),
                            (ExchangeCalculation, psys, "torch")):
        (tmp_path / name).mkdir()
        xc = cls(sys_, pex.trio_pairs(trios), str(tmp_path / name))
        xc.run()
        with np.errstate(invalid="ignore"):
            out.append(xc.calculate_jijk(trios))
    want, got = out
    assert got.shape == (1, 9) and np.abs(want).max() > 1e-6
    assert _close(got, want)
    _assert_printed_close(tmp_path / "jax" / "jijk.out",
                          tmp_path / "torch" / "jijk.out")


# ----------------------------------------------------------------------
# the pieces
@pytest.fixture(scope="module")
def block_run(tmp_path_factory):
    """The port's block exchange run of the bcc preset (its chains and
    terminators)."""
    _, psys = _bcc_pair()
    xc = ExchangeCalculation(psys, presets.exchange_pairs(psys.cluster,
                                                          NSHELL),
                             str(tmp_path_factory.mktemp("block-run")))
    xc.run()
    return xc


@pytest.mark.parametrize("eta", ["scalar", "per-energy"])
def test_bgreen_eta_matches_jax(block_run, eta):
    """``bgreen`` with ``eta`` on the port's live chains: a scalar shift
    on the real mesh, or the 64 Gauss-Legendre nodes at one energy."""
    px = block_run
    a_b, b_b = px.a_b[:, px.chains], px.b_b[:, px.chains]
    if eta == "scalar":
        ene, etas = EnergyMesh.build(px.cfg.energy).ene, 0.02j
    else:
        x = 0.5 * (np.polynomial.legendre.leggauss(64)[0] + 1.0)
        ene, etas = np.full(64, -0.07), 1j * (1.0 - x) / x
    got = pgreens.bgreen(a_b, b_b, px.a_inf, px.b_inf, ene, CPU, eta=etas)
    for r in range(len(px.chains)):
        args = (a_b[:, r], b_b[:, r], px.a_inf[r], px.b_inf[r])
        if eta == "scalar":
            want = jgreens.bgreen(*args, ene, eta=etas)
        else:  # the JAX package's bgreen takes one eta per call
            want = np.stack([jgreens.bgreen(*args, ene[n:n + 1],
                                            eta=etas[n])[..., 0]
                             for n in range(len(ene))], -1)
        assert np.abs(got[r] - want).max() <= 1e-12 * np.abs(want).max()


def test_plain_spmv_in_column_chunks(monkeypatch):
    """The plain SpMV gathers ``psi[cols]`` in chunks of columns under
    ``GATHER_BYTES``: one and two types, two-site complex start blocks
    (C = 18 R) and random columns, within 1e-14 of scale of one gather."""
    _, psys = _bcc_pair()
    hb = psys.ham
    kk = psys.cluster.kk
    pairs = presets.exchange_pairs(psys.cluster, NSHELL) - 1
    psi = pex.pair_start_blocks(kk, pairs, CPU).dense()
    psi[:kk] += torch.from_numpy(
        np.random.default_rng(5).standard_normal(psi[:kk].shape) * 0.1)
    cols = torch.from_numpy(hb.cols)
    for ntype in (1, 2):
        tab = torch.from_numpy(np.tile(hb.ee, (ntype, 1, 1, 1)))
        tab[1:] *= 0.5
        iz = torch.from_numpy((np.arange(kk) % ntype).astype(np.int32))
        whole = hk.block_spmv(tab, iz, cols, psi)
        with monkeypatch.context() as mp:
            per_col = kk * cols.shape[1] * 18 * 16
            mp.setattr(hk, "GATHER_BYTES", 5 * per_col)  # chunks of 5
            chunked = hk.block_spmv(tab, iz, cols, psi)
        assert chunked.shape == whole.shape == (kk, 18, psi.shape[2])
        assert (chunked - whole).abs().max() <= 1e-14 * whole.abs().max()


def _two_level_setup(tmp_path, monkeypatch, eta=0.05, e0=-0.1):
    """The port's ExchangeCalculation with EXACT Lorentzian intersite GF
    injected: g_ij(E) = 1/(E - e0 + i eta) on orbital (0,0), zero elsewhere,
    and a torque operator T = |0><0| on every type/component (as
    ``tests/test_exchange.py``'s)."""
    sys_ = presets.build_synthetic_bcc(rc=8.0, ndim=500, lld=4, nsp=2,
                                       device="cpu")
    xc = ExchangeCalculation(sys_, np.array([[1, 2]]), workdir=str(tmp_path))
    em = EnergyMesh.build(sys_.cfg.energy)
    g = 1.0 / (em.ene - e0 + 1j * eta)
    gfull = torch.zeros((1, 18, 18, em.npts), dtype=torch.complex128)
    gfull[0, 0, 0] = torch.from_numpy(g)
    xc.gij_full = gfull
    xc.gji_full = gfull.clone()
    t = np.zeros((1, 3, 18, 18), np.complex128)
    t[:, :, 0, 0] = 1.0
    monkeypatch.setattr(pex, "torque_operator_collinear", lambda atoms: t)
    ef = em.ene[int(np.argmin(np.abs(em.ene - em.fermi)))]
    pot = sys_.atoms[0].potential
    spin = float((pot.ql[0, :, 0] - pot.ql[0, :, 1]).sum())
    return xc, em, ef, eta, e0, spin


def test_damping_kambersky_two_level(tmp_path, monkeypatch):
    """alpha^{kl} = 2 (Im g(E_F))^2 / (pi m) for every k, l."""
    xc, em, ef, eta, e0, spin = _two_level_setup(tmp_path, monkeypatch)
    alpha = xc.calculate_gilbert_damping()
    img = -eta / ((ef - e0) ** 2 + eta ** 2)
    expect = 2.0 * img ** 2 / (np.pi * spin)
    np.testing.assert_allclose(alpha, np.full(9, expect), rtol=1e-10)


def test_inertia_kambersky_two_level(tmp_path, monkeypatch):
    """I^{kl} = Re tr[T A T B'' + T B'' T A] with B''_00 = Re[4/(E - e0 +
    i eta)^3]; the module differentiates B on the mesh (O(h^2) central
    differences), so the bar allows that truncation."""
    xc, em, ef, eta, e0, spin = _two_level_setup(tmp_path, monkeypatch)
    inertia = xc.calculate_moment_of_inertia()
    g = 1.0 / (ef - e0 + 1j * eta)
    a00 = 2j * g.imag
    b2_exact = np.real(4.0 / (ef - e0 + 1j * eta) ** 3)
    expect = np.real(a00 * b2_exact + b2_exact * a00)
    np.testing.assert_allclose(inertia, np.full(9, expect), rtol=5e-3)


# ----------------------------------------------------------------------
# the entry points
@pytest.mark.parametrize("route", ["pairs", "trio"])
def test_cli_matches_jax_cli(tmp_path, capsys, route):
    _, psys = _bcc_pair()
    presets.synthetic_exchange(psys, NSHELL)
    if route == "trio":
        psys.cfg.lattice.njijk = 1
    src = tmp_path / "src"
    src.mkdir()
    presets.write_exchange_input(psys, str(src))
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    inp = lambda name: str(dirs[name] / "input.nml")  # noqa: E731
    assert jax_cli([inp("jax"), f"output={dirs['jax']}"]) == 0
    assert cli.main([inp("torch"), f"output={dirs['torch']}",
                     "device=cpu"]) == 0
    capsys.readouterr()
    files = sorted(os.listdir(dirs["torch"]))
    assert files == sorted(os.listdir(dirs["jax"]))
    assert ({"jijk.out"} if route == "trio" else {
        "jij.out", "dij.out", "aij.out", "jtens.out", "jijso.out",
        "aijparts.out", "fort.150"}) <= set(files)
    for fname in files:
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_zero_chains_never_reach_the_green_function(tmp_path):
    """On the 300-channel mesh (E = 1.1e-16 on it) the JAX package's dead
    chains of the onsite pair make ``bgreen`` raise; the port recurs and
    inverts only the live chain and completes (ROADMAP queue 3)."""
    jsys, psys = _bcc_pair(ne=300)
    assert np.abs(JaxMesh.build(jsys.cfg.energy).ene).min() < 1e-15
    with pytest.raises(np.linalg.LinAlgError):
        JaxExchange(jsys, np.array([[1, 1]]), str(tmp_path)).run()
    res = ExchangeCalculation(psys, np.array([[1, 1]]), str(tmp_path)).run()
    assert np.isfinite(res[0]["jij"]) and res[0]["jij"] > 1.0


def test_refusals(tmp_path, monkeypatch):
    """The impurity cluster raises, naming its ROADMAP entry; pairs
    outside the cluster raise.  The geometry exports are written beside
    every branch before it runs."""
    cfg = presets.synthetic_embedded_config("I", 12.0, LLD, 2)
    isys = presets.build_synthetic_embedded(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        ExchangeCalculation(isys, np.array([[1, 2]]), str(tmp_path))
    _, psys = _bcc_pair()
    for bad in ([[1, 0]], [[1, psys.cluster.kk + 1]], [1, 2]):
        with pytest.raises(ValueError, match="pairs"):
            ExchangeCalculation(psys, np.array(bad), str(tmp_path))
    psys.cfg.lattice.write_artifacts = True
    presets.write_input(psys, str(tmp_path))  # the element file X.nml
    psys.cfg.atoms.database = str(tmp_path)
    ran = []
    monkeypatch.setattr(cli, "run_system", lambda sys_, wd: ran.append(
        (sys_.cluster.kk, sys_.cfg.calculation.post_processing, wd)))
    posts = ("exchange_p2rs", "conductivity_p2rs", "orbital_modern")
    for post in posts:
        psys.cfg.calculation.post_processing = post
        out = tmp_path / post
        assert cli.run_calculation(psys.cfg, str(out), device="cpu") == 0
        assert {"clust", "map", "str.out", "sbar", "view.sbar"} <= set(
            os.listdir(out))
    assert ran == [(psys.cluster.kk, p, str(tmp_path / p)) for p in posts]
