"""The port's orbital moment (``post_processing='orbital_modern'``) against
the JAX package's (CPU).

Preset: the bcc preset ``build_synthetic_bcc(rc=5, nsp=2)`` (kk = 112,
spin-orbit coupling) at lld 8, 200 energy points; with HoH its atoms carry
an overlap, which the orbital moment ignores in both packages (ROADMAP
queue 3).

* the raw trace sum_s <A e_s | T_n(H~) e_s> over 10 sites within 1e-12 of
  its scale of the JAX package's ``_orbital_chunk`` diagonal blocks, and of
  a dense-matrix computation of the same sum (H as a full matrix, T_n by
  the three-term recursion on the columns of the sites);
* Lz(E) of ``OrbitalMoment.run`` within 1e-12 of scale of the JAX
  package's, and ``fort.50`` within 1e-6 (one unit of the last printed
  digit allowed, ``test_torch_block``);
* sites in groups (given, or planned from a small memory budget) give the
  same trace within 1e-13 of scale;
* K4 (its plain version here) called ``n_mom + 1`` times per group;
* both command-line drivers on one ``orbital_modern`` input;
* an impurity cluster raises, naming ROADMAP queue 3.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import orbital as jorb
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu_torch import cli
from rslmtoasa_tpu_torch.models import orbital as porb
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.ops import block_kernels as bk
from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator
from test_torch_block import _assert_printed_close

CPU = torch.device("cpu")
RC, LLD, NE = 5.0, 8, 200
SITES = np.linspace(0, 111, 10).astype(int)
OBAR = np.array([[-0.05, -0.055], [-0.04, -0.045], [-0.03, -0.035]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread per xdist worker, as in
    ``test_torch_block``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(hoh=False):
    """(JAX system, port system) of the bcc preset."""
    out = []
    for mod, kw in ((jpresets, {}), (presets, {"device": "cpu"})):
        sys_ = mod.build_synthetic_bcc(rc=RC, ndim=500, lld=LLD, nsp=2,
                                       hoh=hoh, **kw)
        sys_.cfg.energy.channels_ldos = NE
        if hoh:
            for at in sys_.atoms:
                at.potential.obar[:] = OBAR
            sys_.build_hamiltonian()
        out.append(sys_)
    return out


def _scaling(sys_):
    en = sys_.cfg.energy
    return ((en.energy_max - en.energy_min) / 1.7,
            (en.energy_max + en.energy_min) / 2)


def _port_trace(psys, sites, group):
    hb, cl = psys.ham, psys.cluster
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham)
    coord = lambda k: torch.as_tensor(  # noqa: E731
        np.append(cl.cr[:, k] * cl.alat, 0.0))
    return porb.orbital_moments(op, coord(0), coord(1), sites, LLD,
                                *_scaling(psys), group).numpy()


def _jax_trace(jsys, sites):
    """The JAX package's chunk over ``sites`` at once, its diagonal 18 x 18
    blocks summed."""
    hb, cl = jsys.ham, jsys.cluster
    psi0 = np.zeros((cl.kk, 18, 18 * len(sites)), np.complex128)
    for n, s in enumerate(sites):
        psi0[s, :, 18 * n:18 * (n + 1)] = np.eye(18)
    a, b = _scaling(jsys)
    mu = np.asarray(jorb._orbital_chunk(
        jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(cl.cr[:, 0] * cl.alat),
        jnp.asarray(cl.cr[:, 1] * cl.alat), jnp.asarray(psi0), n_mom=LLD,
        a=float(a), b=float(b)))
    return sum(mu[:, 18 * n:18 * (n + 1), 18 * n:18 * (n + 1)]
               for n in range(len(sites)))


def _dense_trace(psys, sites):
    """sum_s (L e_s)^H T_n(H~) e_s with H~ = (H - b) / a as a full matrix
    and L = i (Y H~ X - X H~ Y), the JAX package's left vector."""
    hb, cl = psys.ham, psys.cluster
    kk, n = cl.kk, 18 * cl.kk
    h = np.zeros((n, n), np.complex128)
    for i in range(kk):
        blk = slice(18 * i, 18 * i + 18)
        h[blk, blk] += hb.lsham[hb.iz[i]]
        for m, j in enumerate(hb.cols[i]):
            if j < kk:
                h[blk, 18 * j:18 * j + 18] += hb.ee[hb.iz[i], m]
    a, b = _scaling(psys)
    ht = (h - b * np.eye(n)) / a
    x = np.repeat(cl.cr[:, 0] * cl.alat, 18)[:, None]
    y = np.repeat(cl.cr[:, 1] * cl.alat, 18)[:, None]
    cols = np.concatenate([np.arange(18 * s, 18 * s + 18) for s in sites])
    e = np.eye(n)[:, cols]
    left = 1j * (y * (ht @ (x * e)) - x * (ht @ (y * e)))
    mu = np.zeros((LLD, 18, 18), np.complex128)
    t0, t1 = None, e
    for k in range(LLD):
        if k == 1:
            t0, t1 = t1, ht @ t1
        elif k > 1:
            t0, t1 = t1, 2 * (ht @ t1) - t0
        for r in range(len(sites)):
            c = slice(18 * r, 18 * r + 18)
            mu[k] += left[:, c].conj().T @ t1[:, c]
    return mu


@pytest.mark.parametrize("hoh", [False, True])
def test_trace_matches_jax_and_dense(hoh):
    jsys, psys = _pair(hoh)
    got = _port_trace(psys, SITES, 4)
    scale = np.abs(got).max()
    assert scale > 1.0
    assert np.abs(got - _jax_trace(jsys, SITES)).max() <= 1e-12 * scale
    assert np.abs(got - _dense_trace(psys, SITES)).max() <= 1e-12 * scale


def test_groups_give_the_same_trace(monkeypatch):
    _, psys = _pair()
    kk = psys.cluster.kk
    whole = _port_trace(psys, SITES, len(SITES))
    scale = np.abs(whole).max()
    # a budget of three start blocks' vectors
    unit = (kk + 1) * 18 * 18 * 16
    monkeypatch.setattr(porb, "CPU_BUDGET", 3 * porb.WORK_VECS * unit + 1)
    assert porb.plan(kk, len(SITES), CPU) == 3
    for group in (1, 3, 7):
        got = _port_trace(psys, SITES, group)
        assert np.abs(got - whole).max() <= 1e-13 * scale


@pytest.mark.parametrize("group", [3, 10])
def test_launches(monkeypatch, group):
    """K4 (its plain version on CPU tensors) runs lld + 1 times per group:
    two for the left vector, one per moment n >= 1."""
    calls = []
    ref = bk.block_step_ref

    def spy(*args, **kw):
        calls.append(1)
        return ref(*args, **kw)

    monkeypatch.setattr(bk, "block_step_ref", spy)
    _, psys = _pair()
    _port_trace(psys, SITES, group)
    assert len(calls) == porb.launches(LLD, len(SITES), group) \
        == -(-len(SITES) // group) * (LLD + 1)


def test_run_matches_jax(tmp_path):
    jsys, psys = _pair()
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jorb.OrbitalMoment(jsys, str(tmp_path / "jax")).run(n_sites=10)
    got = porb.OrbitalMoment(psys, str(tmp_path / "torch")).run(
        n_sites=10, group=3)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    _assert_printed_close(tmp_path / "jax" / "fort.50",
                          tmp_path / "torch" / "fort.50")


def test_cli_matches_jax_cli(tmp_path, capsys):
    _, psys = _pair()
    src = tmp_path / "src"
    src.mkdir()
    presets.write_input(psys, str(src), "orbital_modern")
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
    assert files == sorted(os.listdir(dirs["jax"])) and "fort.50" in files
    for fname in files:
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_impurity_raises(tmp_path):
    cfg = presets.synthetic_embedded_config("I", 12.0, LLD, 2)
    isys = presets.build_synthetic_embedded(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        porb.OrbitalMoment(isys, str(tmp_path))
