"""The port's block-Lanczos and Chebyshev recursions against the JAX
package's (CPU).

* K4's plain version (``block_step_ref``, reached through the
  ``block_step`` wrapper with CPU tensors) against the JAX package's
  ``_spmv18`` + ``_onsite18`` + ``gram_sum``, for d in {9, 18}, one and two
  types, and the HoH composition: 1e-13 of the output's scale.
* ``block_lanczos`` and ``chebyshev_moments`` against the JAX package's on
  the bcc (``rc=8, ndim=2000, lld=8, nsp=2``, ``hoh`` False/True) and B2
  (``rc=8``, kk = 224, two start blocks) presets: 1e-10.
* 2-iteration SCFs of five presets against the JAX package's SCF, plus one
  on the JAX state carried across by ``convert``: etot within 1e-9; fermi,
  ql, mom and delta within 1e-10; written files within 1e-6.  The JAX etot
  values were -2542.088784590601 (bcc block), -2542.096652877853 (HoH),
  -2542.08016980097 (B2), -2542.088588337106 (bcc nsp=1 block, spin
  sectors), -2542.4144178647666 (bcc Chebyshev, window (-1.5, 1.0)); the
  test recomputes them.
* K4's packed tables (the kernel's B fragments) against the plain
  products.
* ``local_axis``, both command-line drivers, the Green functions (torch,
  batched over rec atoms, against the JAX package's NumPy ones; no NumPy
  inverse left in an SCF iteration), the start blocks' cache across a
  change of device, and the collinear spin-sector split.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models.presets import build_synthetic_b2 as jax_b2
from rslmtoasa_tpu.models.presets import build_synthetic_bcc as jax_bcc
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu.ops import block_lanczos as jbl
from rslmtoasa_tpu.ops import chebyshev as jch
from rslmtoasa_tpu.parallel import dispatch as jdispatch
from rslmtoasa_tpu.physics import greens as jgreens
from rslmtoasa_tpu_torch.cli import main as torch_cli
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models.presets import (
    build_synthetic_b2,
    build_synthetic_bcc,
    synthetic_bcc_config,
)
from rslmtoasa_tpu_torch.models.scf import SelfConsistency
from rslmtoasa_tpu_torch.ops import block_kernels as bk
from rslmtoasa_tpu_torch.ops import block_lanczos as pbl
from rslmtoasa_tpu_torch.ops import chebyshev as pch
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.parallel import dispatch as pdispatch
from rslmtoasa_tpu_torch.physics import greens as pgreens
from test_torch_scf import NUM, _assert_files_close, _input_text

CPU = torch.device("cpu")
BCC = dict(rc=8.0, ndim=2000, lld=8)
NSTEP = 2
WINDOW = (-1.5, 1.0)  # the Chebyshev window in which the moments converge
# an overlap per l and spin for the atoms of the HoH cases (the preset's
# atoms have obar = 0, so that eeo would be zero)
OBAR = np.array([[-0.05, -0.055], [-0.04, -0.045], [-0.03, -0.035]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several pytest-xdist worker processes at once.
    With torch's default of one intra-op thread per core in each of them,
    the Green functions' batched CPU inverses oversubscribe the cores:
    three concurrent block SCF tests took over ten times as long as one.
    One thread while this module's tests and fixtures run (an autouse
    fixture comes before the other fixtures of its scope) keeps their time
    as it is alone; the old count comes back after them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ----------------------------------------------------------------------
# K4's plain version against the JAX package's XLA ops
@pytest.mark.parametrize("hoh", [False, True])
@pytest.mark.parametrize("ntype", [1, 2])
@pytest.mark.parametrize("d", [9, 18])
def test_block_step_matches_jax_ops(d, ntype, hoh):
    rng = np.random.default_rng(100 * d + 10 * ntype + hoh)
    kk, nslots, r = 37, 5, 2
    hs = _rand(rng, ntype, nslots, d, d)
    hso = _rand(rng, ntype, nslots, d, d) if hoh else None
    lsham = _rand(rng, ntype, d, d)
    enim = _rand(rng, ntype, d, d) if hoh else None
    iz = rng.integers(0, ntype, kk).astype(np.int32)
    izo = rng.integers(0, ntype, kk).astype(np.int32)
    cols = rng.integers(0, kk + 1, (kk, nslots)).astype(np.int32)
    cols[:, 0] = np.arange(kk)
    psi = _rand(rng, r, kk + 1, d, d)
    psi[:, kk] = 0.0

    jpsi = jnp.asarray(psi)
    hpsi = jbl._spmv18(jnp.asarray(hs), jnp.asarray(iz), jnp.asarray(cols),
                       jpsi)
    if hoh:
        pad = jnp.concatenate([hpsi, jnp.zeros((r, 1, d, d), hpsi.dtype)], 1)
        want = (hpsi - jbl._spmv18(jnp.asarray(hso), jnp.asarray(iz),
                                   jnp.asarray(cols), pad)
                + jbl._onsite18(jnp.asarray(enim), jnp.asarray(izo), jpsi)
                + jbl._onsite18(jnp.asarray(lsham), jnp.asarray(izo), jpsi))
    else:
        want = hpsi + jbl._onsite18(jnp.asarray(lsham), jnp.asarray(izo),
                                    jpsi)
    gram = np.asarray(jbl.gram_sum(jpsi[:, :-1].conj(), want,
                                   decomposed=False))
    want = pbl.port_layout(np.asarray(want))

    op = pbl.BlockOperator(hs, iz, cols, lsham, iz_onsite=izo, hoh=hoh,
                           hso=hso, enim=enim)
    n = bk.block_step.launches
    y, g = op(_tensor(pbl.port_layout(psi)), gram=True)
    assert bk.block_step.launches == n  # CPU tensors take the plain version
    assert y.shape == (kk, d, r * d)
    assert g.shape == (bk.nrowblk(kk, d), r, d, d)
    scale = np.abs(want).max()
    assert np.abs(y.numpy() - want).max() <= 1e-13 * scale
    assert np.abs(g.sum(0).numpy() - gram).max() <= 1e-13 * np.abs(gram).max()
    # the padded form (the HoH step's first launch) appends a zero row kk
    yp, none = bk.block_step(op.hs, op.iz, op.cols,
                             _tensor(pbl.port_layout(psi)), pad=True)
    assert none is None and yp.shape == (kk + 1, d, r * d)
    assert not yp[kk].any()


@pytest.mark.parametrize("ntype", [1, 2])
@pytest.mark.parametrize("d", [9, 18])
def test_block_packed_tables_match_plain(d, ntype):
    """K4's packed B fragments (type table and onsite table as one slot),
    combined as the kernel's MMAs combine them, give the plain SpMV and
    onsite products within 1e-13 of scale; padding is zero."""
    rng = np.random.default_rng(7 * d + ntype)
    kk, nslots, c = 29, 15, 2 * d
    hs = _tensor(_rand(rng, ntype, nslots, d, d))
    onsite = _tensor(_rand(rng, ntype, d, d))
    iz = torch.from_numpy(rng.integers(0, ntype, kk).astype(np.int32))
    cols = torch.from_numpy(
        rng.integers(0, kk + 1, (kk, nslots)).astype(np.int32))
    x = _tensor(_rand(rng, kk + 1, d, c))
    x[kk] = 0.0
    table = bk.pack_table(hs)
    nq, ntile = (68, 5) if d == 18 else (34, 3)
    assert table.shape == (ntype, nq, ntile, 32, 2)
    want = bk.block_spmv(hs, iz, cols, x)
    got = hk.spmv_packed_ref(table, iz, cols, x)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    self_cols = torch.arange(kk, dtype=torch.int32)[:, None]
    want = torch.einsum("iab,ibc->iac", onsite[iz.long()], x[:kk])
    got = hk.spmv_packed_ref(bk.pack_onsite(onsite), iz, self_cols, x)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    # the realified rows past 2d and the inputs past d nslots weigh nothing
    lane = torch.arange(32)
    n = 8 * torch.arange(ntile)[:, None] + lane // 4
    assert not table[:, :, n >= 2 * d].any()
    q = 4 * torch.arange(nq)[:, None] + lane % 4
    assert not table.permute(0, 1, 3, 2, 4)[:, q >= d * nslots].any()


# ----------------------------------------------------------------------
# the recursions against the JAX package's
def _jax_system(name):
    if name == "b2":
        return jax_b2(rc=8.0)
    return jax_bcc(nsp=2, hoh=name == "bcc-hoh", **BCC)


def _tables(jsys):
    hb = jsys.ham
    lsham = hb.lsham if hb.lsham is not None else np.zeros(
        (hb.ee.shape[0], 18, 18), np.complex128)
    hoh = jsys.cfg.hamiltonian.hoh
    return dict(hs=np.asarray(hb.ee), lsham=np.asarray(lsham),
                iz=np.asarray(hb.iz), cols=np.asarray(hb.cols), hoh=hoh,
                hso=np.asarray(hb.eeo) if hoh else None,
                enim=np.asarray(hb.enim) if hoh else None)


def _jax_args(t):
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (jnp.asarray(t["hs"]), jnp.asarray(t["lsham"]),
            jnp.asarray(t["iz"]), jnp.asarray(t["cols"])), dict(
        hoh=t["hoh"], hso=opt(t["hso"]), enim=opt(t["enim"]))


def _operator(t):
    return pbl.BlockOperator(t["hs"], t["iz"], t["cols"], t["lsham"],
                             hoh=t["hoh"], hso=t["hso"], enim=t["enim"])


@pytest.mark.parametrize("name", ["bcc", "bcc-hoh", "b2"])
def test_block_lanczos_matches_jax(name):
    jsys = _jax_system(name)
    t = _tables(jsys)
    kk = jsys.cluster.kk
    starts = [int(j) - 1 for j in jsys.cluster.irec]
    assert len(starts) == (2 if name == "b2" else 1)
    lld = BCC["lld"]
    args, kw = _jax_args(t)
    a0, b20 = jbl.block_lanczos(*args, jnp.asarray(
        jbl.block_start_vectors(kk, starts)), lld, **kw)
    a, b2 = pbl.block_lanczos(_operator(t),
                              pbl.block_start_vectors(kk, starts, CPU), lld)
    assert a.shape == (lld, len(starts), 18, 18)
    assert np.abs(a.numpy() - np.asarray(a0)).max() <= 1e-10
    assert np.abs(b2.numpy() - np.asarray(b20)).max() <= 1e-10


@pytest.mark.parametrize("name", ["bcc", "bcc-hoh", "b2"])
def test_chebyshev_moments_match_jax(name):
    jsys = _jax_system(name)
    t = _tables(jsys)
    kk = jsys.cluster.kk
    starts = [int(j) - 1 for j in jsys.cluster.irec]
    lld, a, b = 6, (WINDOW[1] - WINDOW[0]) / 1.7, sum(WINDOW) / 2
    args, kw = _jax_args(t)
    mu0 = np.asarray(jch.chebyshev_moments(*args, jnp.asarray(
        jbl.block_start_vectors(kk, starts)), lld, a, b, **kw))
    mu = pch.chebyshev_moments(_operator(t),
                               pbl.block_start_vectors(kk, starts, CPU),
                               lld, a, b).numpy()
    assert mu.shape == (2 * lld + 2, len(starts), 18, 18)
    assert np.abs(mu - mu0).max() <= 1e-10


def test_local_axis_block_matches_jax():
    """``local_axis=True``: each rec atom recurs in its moment's frame, one
    atom at a time at the full width, in both packages."""
    _local_axis_parity(hoh=False)


def test_local_axis_hoh_block_matches_jax():
    """The same with HoH, the atoms given an overlap (``obar``) so that
    ``eeo`` counts (ROADMAP item 17)."""
    _local_axis_parity(hoh=True)


def _local_axis_parity(hoh):
    jsys = jax_bcc(nsp=2, hoh=hoh, **BCC)
    jsys.cfg.hamiltonian.local_axis = True
    jsys.atoms[0].potential.mom = np.array([0.3, -0.4, 0.866])
    if hoh:
        jsys.atoms[0].potential.obar[:] = OBAR
        jsys.build_hamiltonian()
        assert np.abs(jsys.ham.eeo).max() > 0.01
    cfg = synthetic_bcc_config(nsp=2, **BCC)
    cfg.hamiltonian.local_axis = True
    cfg.hamiltonian.hoh = hoh
    psys = system_from_numpy(*system_to_numpy(jsys), CPU, cfg=cfg)
    a0, b20 = jsys.run_block()
    a, b2 = psys.run_block()
    assert np.abs(a - np.asarray(a0)).max() <= 1e-10
    assert np.abs(b2 - np.asarray(b20)).max() <= 1e-10


# ----------------------------------------------------------------------
# SCFs against the JAX package's
def _make(pkg, name):
    """The preset ``name`` built by the JAX package (``pkg='jax'``) or the
    port (on the CPU)."""
    bcc, b2 = ((jax_bcc, jax_b2) if pkg == "jax" else
               (lambda **k: build_synthetic_bcc(device="cpu", **k),
                lambda **k: build_synthetic_b2(device="cpu", **k)))
    if name == "b2-block":
        return b2(rc=8.0)
    sys_ = bcc(nsp=1 if name == "bcc-nsp1-block" else 2,
               hoh=name == "bcc-block-hoh", **BCC)
    if name == "bcc-nsp1-block":
        sys_.cfg.control.recur = "block"
    if name == "bcc-chebyshev":
        sys_.cfg.control.recur = "chebyshev"
        sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = WINDOW
    return sys_


def _scf(sys_, scf_cls, workdir):
    scf = scf_cls(sys_, workdir=str(workdir))
    state = scf.run(nstep=NSTEP)
    pot = sys_.atoms[0].potential
    return dict(etot=pot.etot, fermi=scf.fermi, ql=pot.ql.copy(),
                mom=np.array(pot.mom), delta=state.delta, dir=workdir)


SCF_CASES = ["bcc-block", "bcc-block-hoh", "b2-block", "bcc-nsp1-block",
             "bcc-chebyshev", "bcc-block/carried-state"]


@pytest.fixture(scope="module", params=SCF_CASES)
def scf_pair(request, tmp_path_factory):
    name, _, carried = request.param.partition("/")
    jsys = _make("jax", name)
    if carried:
        psys = system_from_numpy(*system_to_numpy(jsys), CPU,
                                 cfg=synthetic_bcc_config(nsp=2, **BCC))
    else:
        psys = _make("torch", name)
    assert psys.cfg.control.recur == jsys.cfg.control.recur != "lanczos"
    tag = request.param.replace("/", "-")
    return (_scf(jsys, JaxSCF, tmp_path_factory.mktemp(f"jax-{tag}")),
            _scf(psys, SelfConsistency,
                 tmp_path_factory.mktemp(f"torch-{tag}")))


# The second iteration's Fermi level inherits the atomic-sphere solver's
# noise: its eigenvalue searches stop at |de| <= 1e-8, so ql equal to
# 4e-16 after the first iteration give band centres c 1.3e-10 apart on the
# Chebyshev preset (1e-11 on the block one).  The JAX package's own two
# exact engines (complex128 and realified float64, both on the CPU) give
# Chebyshev Fermi levels 1.53e-10 apart, and the port lands 1.09e-10 from
# the complex128 one.  Its bar is therefore 2e-10; every other bar is
# 1e-10.
FERMI_BAR = {"bcc-chebyshev": 2e-10}


def test_scf_scalars_match_jax(request, scf_pair):
    ref, got = scf_pair
    name = request.node.callspec.params["scf_pair"]
    assert np.isfinite(got["etot"]) and got["etot"] < -2000.0
    assert abs(got["etot"] - ref["etot"]) <= 1e-9
    assert abs(got["fermi"] - ref["fermi"]) <= FERMI_BAR.get(name, 1e-10)
    assert np.abs(got["ql"] - ref["ql"]).max() <= 1e-10
    assert np.abs(got["mom"] - ref["mom"]).max() <= 1e-10
    assert abs(got["delta"] - ref["delta"]) <= 1e-10


def _tokens(path):
    return [t for w in open(path).read().split() for t in NUM.findall(w)]


def _last_place(token: str) -> float:
    """The unit of a printed number's last digit: 1e-5 for '1.70886'."""
    mant, _, exp = re.sub("[dDE]", "e", token).partition("e")
    return 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))


def _assert_printed_close(p1, p2):
    """The files hold the same words and numbers within 1e-6 (relative
    above one), or, for a number printed with fewer digits, within one unit
    of its last printed digit: the orbital DOS prints five decimals, so two
    runs whose SCF scalars agree to 1e-11 can still round a value apart
    across a print boundary (one of the 47 690 numbers of the bcc block
    run's X_orbital_dos.out)."""
    name = os.path.basename(p1)
    _assert_files_close(p1, p2, tol=np.inf)  # same words, same count
    t1, t2 = _tokens(p1), _tokens(p2)
    num = lambda t: float(re.sub("[dD]", "e", t))  # noqa: E731
    n1, n2 = np.array([num(t) for t in t1]), np.array([num(t) for t in t2])
    unit = np.array([_last_place(t) for t in t1])
    bar = np.maximum(1e-6 * np.maximum(1.0, np.abs(n1)), 1.000001 * unit)
    bad = np.nonzero(np.abs(n1 - n2) > bar)[0]
    assert bad.size == 0, f"{name}: {t1[bad[0]]} vs {t2[bad[0]]}"


@pytest.mark.parametrize("fname", ["totaldos.out", "X_out.nml", "X_dos.out",
                                   "X_orbital_dos.out"])
def test_scf_outputs_match_jax(scf_pair, fname):
    _assert_printed_close(scf_pair[0]["dir"] / fname,
                          scf_pair[1]["dir"] / fname)


def test_block_scf_counts_its_recursions(monkeypatch, tmp_path):
    """The HoH block SCF applies H through two K4 calls per step (their
    plain version on the CPU): nstep * (lld - 1) * 2."""
    calls = []
    ref = bk.block_step_ref

    def spy(*args, **kw):
        calls.append(1)
        return ref(*args, **kw)

    monkeypatch.setattr(bk, "block_step_ref", spy)
    _scf(_make("torch", "bcc-block-hoh"), SelfConsistency, tmp_path)
    assert len(calls) == NSTEP * (BCC["lld"] - 1) * 2


# ----------------------------------------------------------------------
# both command-line drivers on a recur='block' input
def test_cli_block_matches_jax_cli(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    JaxSCF(jax_bcc(nsp=2, **BCC), workdir=str(src)).save_checkpoints()
    os.rename(src / "X_out.nml", src / "X.nml")
    cfg = synthetic_bcc_config(nsp=2, **BCC)
    assert cfg.control.recur == "block" and cfg.control.nsp == 2
    (src / "input.nml").write_text(_input_text(cfg))
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    inp = lambda name: str(dirs[name] / "input.nml")  # noqa: E731
    assert jax_cli([inp("jax"), f"output={dirs['jax']}"]) == 0
    assert torch_cli([inp("torch"), f"output={dirs['torch']}",
                      "device=cpu"]) == 0
    capsys.readouterr()
    jax_files = set(os.listdir(dirs["jax"]))
    torch_files = set(os.listdir(dirs["torch"]))
    assert jax_files == torch_files
    assert {"totaldos.out", "X_out.nml", "report.out",
            "rs2paoham.dat"} <= torch_files
    for fname in sorted(torch_files):
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


# ----------------------------------------------------------------------
# the Green functions against their JAX originals
@pytest.fixture(scope="module")
def coefficients():
    """(a_b, b2_b, mu) of the B2 preset from the JAX package."""
    t = _tables(jax_b2(rc=8.0))
    args, kw = _jax_args(t)
    psi0 = jnp.asarray(jbl.block_start_vectors(224, [0, 1]))
    a_b, b2_b = jbl.block_lanczos(*args, psi0, 8, **kw)
    mu = jch.chebyshev_moments(*args, psi0, 8, 2.5 / 1.7, -0.25, **kw)
    return np.asarray(a_b), np.asarray(b2_b), np.asarray(mu)


def test_zsqr_and_terminators_match_jax(coefficients):
    a_b, b2_b, _ = coefficients
    b_b = pbl.zsqr(b2_b)
    assert np.abs(b_b - jbl.zsqr(b2_b)).max() <= 1e-13
    for got, want in zip(pgreens.get_terminf(a_b, b_b),
                         jgreens.get_terminf(a_b, b_b)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("nrec", [1, 2])
@pytest.mark.parametrize("sym_term", [False, True])
def test_bgreen_matches_jax(coefficients, sym_term, nrec):
    """The port's batched bgreen (all rec atoms at once, torch on the CPU)
    against the JAX package's, one atom at a time: 1e-12 of scale."""
    a_b, b2_b, _ = coefficients
    a_b, b2_b = a_b[:, :nrec], b2_b[:, :nrec]
    b_b = jbl.zsqr(b2_b)
    a_inf, b_inf = jgreens.get_terminf(a_b, b_b)
    ene = np.linspace(-1.0, 0.5, 301)
    got = pgreens.bgreen(a_b, b_b, a_inf, b_inf, ene, CPU, sym_term=sym_term)
    assert got.shape == (nrec, 18, 18, 301)
    for n in range(nrec):
        want = jgreens.bgreen(a_b[:, n], b_b[:, n], a_inf[n], b_inf[n], ene,
                              sym_term=sym_term)
        assert np.abs(got[n] - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("nrec", [1, 2])
def test_chebyshev_green_matches_jax(coefficients, nrec):
    mu = coefficients[2][:, :nrec]
    ene = np.linspace(WINDOW[0] + 0.1, WINDOW[1] - 0.1, 301)
    got = pch.chebyshev_green(mu, ene, *WINDOW, CPU)
    assert got.shape == (nrec, 18, 18, 301)
    for n in range(nrec):
        want = jch.chebyshev_green(mu[:, n], ene, *WINDOW)
        assert np.abs(got[n] - want).max() <= 1e-13 * np.abs(want).max()
    assert np.array_equal(pch.jackson_kernel(17), jch.jackson_kernel(17))
    assert np.array_equal(pch.lorentz_kernel(17), jch.lorentz_kernel(17))


@pytest.mark.parametrize("recur", ["block", "chebyshev"])
def test_dos_phase_inverts_in_torch(monkeypatch, tmp_path, recur):
    """One block (or Chebyshev) SCF iteration with NumPy's inverse made to
    raise: the Green function runs as torch on the recursion's device."""
    def refuse(*args, **kw):
        raise AssertionError("np.linalg.inv called")

    monkeypatch.setattr(np.linalg, "inv", refuse)
    sys_ = _make("torch", "bcc-chebyshev" if recur == "chebyshev"
                 else "bcc-block")
    state = SelfConsistency(sys_, workdir=str(tmp_path)).run(nstep=1)
    assert state.niter == 1 and np.isfinite(sys_.atoms[0].potential.etot)


def test_start_blocks_follow_the_device():
    """The cached start blocks are made again when the system's device
    changes, as when a copy of an SCF runs its next iteration on another
    device."""
    sys_ = build_synthetic_bcc(device="cpu", nsp=2, **BCC)
    kk, atoms = sys_.cluster.kk, [int(j) - 1 for j in sys_.cluster.irec]
    psi0 = sys_._cached_psi0(kk, atoms)
    assert sys_._cached_psi0(kk, atoms) is psi0
    sys_.device = torch.device("meta")
    moved = sys_._cached_psi0(kk, atoms)
    assert moved.device.type == "meta" and moved.shape == psi0.shape


# ----------------------------------------------------------------------
# the collinear spin-sector split
@pytest.mark.parametrize("recursion", ["block", "chebyshev"])
def test_spin_split_equals_unsplit(recursion):
    """On the nsp=1 block preset (no SOC) the two 9-wide sector recursions
    equal the unsplit 18-wide one within 1e-12."""
    sys_ = _make("torch", "bcc-nsp1-block")
    hb = sys_.ham
    lsham = np.zeros((1, 18, 18), np.complex128)
    psi0 = pbl.block_start_vectors(sys_.cluster.kk, [0], CPU)
    assert pdispatch._spin_sectors(hb.ee, lsham, None, None, psi0) is not None
    op = pbl.BlockOperator(hb.ee, hb.iz, hb.cols, lsham)
    ab = 2.5 / 1.7, -0.25
    if recursion == "block":
        split = pdispatch.block_lanczos_auto(hb.ee, lsham, hb.iz, hb.cols,
                                             psi0, BCC["lld"])
        whole = pbl.block_lanczos(op, psi0, BCC["lld"])
    else:
        split = (pdispatch.chebyshev_moments_auto(
            hb.ee, lsham, hb.iz, hb.cols, psi0, BCC["lld"], *ab),)
        whole = (pch.chebyshev_moments(op, psi0, BCC["lld"], *ab),)
    for s, w in zip(split, (w.numpy() for w in whole)):
        assert s.shape == w.shape and s.shape[-2:] == (18, 18)
        assert np.abs(s - w).max() <= 1e-12


@pytest.mark.parametrize("name", SCF_CASES[:5])
def test_spin_split_decision_matches_jax(name):
    """Both packages split (or not) alike on every SCF preset: only the
    collinear nsp=1 preset decouples."""
    t = _tables(_make("jax", name))
    kk = t["cols"].shape[0]
    starts = [0, 1] if name == "b2-block" else [0]
    jsec = jdispatch._spin_sectors(t["hs"], t["lsham"], t["hso"], t["enim"],
                                   jbl.block_start_vectors(kk, starts), None)
    psec = pdispatch._spin_sectors(t["hs"], t["lsham"], t["hso"], t["enim"],
                                   pbl.block_start_vectors(kk, starts, CPU))
    assert (jsec is None) == (psec is None) == (name != "bcc-nsp1-block")
