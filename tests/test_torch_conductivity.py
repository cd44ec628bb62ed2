"""The port's Kubo-Bastin conductivity against the JAX package's (CPU).

Presets: the bcc preset ``build_synthetic_bcc(rc=8, nsp=2)`` (kk = 174,
spin-orbit coupling) with HoH off and on, the B2 preset (two types: R = 2
start blocks side by side, where the JAX package loops over types) and the
bcc(001) slab of ``tests/test_torch_embedded.py`` (``calctype='S'``, four
types), at ``cond_ll`` 8 and 200 energy points; ``random_vec`` with two
random-phase vectors.

* the Kubo operator tables of all eight operator types, pol x/y/z, and the
  velocity tables: bit-equal to the JAX package's;
* the moments within 1e-12 of their largest entry of the JAX package's,
  with a left-chain block that does not divide n (the JAX ``kubo_moments``
  at the same block), and the port's moments at other blocks and right
  groups within 1e-13 of scale of each other;
* K4 (its plain version here) called :func:`~ops.kubo.launches` times;
* the start blocks: the unit blocks of ``per_type`` and the random phases of
  ``random_vec`` equal to the JAX package's draws;
* the integrand of ``conductivity_tensor`` within 1e-12 of scale on the
  same moments; every written file within 1e-6 with one unit of the last
  printed digit allowed (``test_torch_block``);
* start blocks in groups (a small memory budget) give the same moments;
* the JAX system carried into the port by ``convert`` gives the JAX
  package's moments;
* both command-line drivers on one conductivity input, ``per_type`` and
  ``random_vec``, HoH off and on;
* the impurity cluster and the geometry exports beside
  ``conductivity_p2rs`` raise.
"""

import copy
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import conductivity as jcond
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.ops.kubo import kubo_moments as jax_kubo_moments
from rslmtoasa_tpu.physics.energy_mesh import EnergyMesh as JaxMesh
from rslmtoasa_tpu_torch import cli
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models import conductivity as pcond
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.ops import block_kernels as bk
from rslmtoasa_tpu_torch.ops import kubo
from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator, port_layout
from test_torch_block import _assert_printed_close
from test_torch_embedded import _config as slab_config
from test_torch_embedded import _jax_system as jax_slab

CPU = torch.device("cpu")
RC, NMOM, NE = 8.0, 8, 200
AB = (1.9, -0.2)  # the scaling of the JAX package's own Kubo tests
OP_TYPES = ("charge", "spin", "orbital", "spin_accumulation",
            "orbital_accumulation", "spin_torque", "spin_soc_torque",
            "orbital_torque")
CASES = ["bcc", "bcc-hoh", "random", "random-hoh", "B2", "S"]
# the preset's atoms carry no overlap (obar = 0, so eeo = vo = 0): the HoH
# cases give them this one, per l and spin, so that every HoH term counts
OBAR = np.array([[-0.05, -0.055], [-0.04, -0.045], [-0.03, -0.035]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread per xdist worker, as in
    ``test_torch_block``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _systems(case):
    """(JAX system, port system) of a case, at ``cond_ll`` NMOM and NE
    energy points."""
    kind, *rest = case.split("-")
    hoh = "hoh" in rest
    if kind == "S":
        cfg = slab_config("S", 2, False)
        pair = [jax_slab(cfg), presets.build_synthetic_embedded(
            copy.deepcopy(cfg), device="cpu")]
    elif kind == "B2":
        pair = [jpresets.build_synthetic_b2(rc=RC, nsp=2),
                presets.build_synthetic_b2(rc=RC, nsp=2, device="cpu")]
    else:
        pair = [mod.build_synthetic_bcc(rc=RC, lld=4, nsp=2, hoh=hoh, **kw)
                for mod, kw in ((jpresets, {}),
                                (presets, {"device": "cpu"}))]
    for sys_ in pair:
        _configure(sys_, "random_vec" if kind == "random" else "per_type",
                   hoh)
    return pair


def _configure(sys_, units, hoh):
    """``cond_ll`` NMOM, NE energy points, the start units; with ``hoh``
    the atoms' overlap OBAR (the Hamiltonian rebuilt)."""
    ctl = sys_.cfg.control
    ctl.cond_ll, ctl.cond_calctype, ctl.random_vec_num = NMOM, units, 2
    sys_.cfg.energy.channels_ldos = NE
    if hoh:
        for at in sys_.atoms:
            at.potential.obar[:] = OBAR
        sys_.build_hamiltonian()
        assert np.abs(sys_.ham.eeo).max() > 0.01


def _count_k4(mp):
    """Count the plain K4's calls (the CPU's K4) into the returned list."""
    calls = []
    ref = bk.block_step_ref
    mp.setattr(bk, "block_step_ref",
               lambda *a, **kw: calls.append(1) or ref(*a, **kw))
    return calls


@pytest.fixture(scope="module", params=CASES)
def runs(request, tmp_path_factory):
    case = request.param
    jsys, psys = _systems(case)
    dirs = {k: tmp_path_factory.mktemp(f"{k}-{case}") for k in ("jax",
                                                                "torch")}
    want = jcond.ConductivityCalculation(jsys, str(dirs["jax"])).run()
    mp = pytest.MonkeyPatch()
    calls = _count_k4(mp)
    try:
        got = pcond.ConductivityCalculation(psys, str(dirs["torch"])).run()
    finally:
        mp.undo()
    return dict(case=case, jsys=jsys, psys=psys, want=want, got=got,
                dirs=dirs, k4_calls=len(calls))


# ----------------------------------------------------------------------
# the operator tables
@pytest.fixture(scope="module")
def bcc_pairs():
    """(JAX system, port system) of the bcc preset, HoH off and on."""
    return {hoh: _systems("bcc-hoh" if hoh else "bcc") for hoh in (False,
                                                                   True)}


@pytest.mark.parametrize("op_type", OP_TYPES)
def test_kubo_operator_bit_equal(bcc_pairs, op_type):
    largest = 0.0
    for jsys, psys in bcc_pairs.values():
        for pol in "xyz":
            for v_dir in ([0.0, 0.0, 1.0], [1.0, 2.0, -0.5]):
                want = jcond.build_kubo_operator(jsys, op_type, pol,
                                                 np.array(v_dir))
                got = pcond.build_kubo_operator(psys, op_type, pol,
                                                np.array(v_dir))
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and np.array_equal(g, w)
                largest = max(largest, np.abs(got[0]).max())
    assert largest > 0


def test_velocity_operators_bit_equal(bcc_pairs):
    """Both directions and a velocity scale per type, the HoH images."""
    def args():  # new arrays each call: both normalise them in place
        return (np.array([0.0, 1.0, 0.0]), np.array([1.0, 1.0, 0.0]),
                np.array([1.5]))

    for jsys, psys in bcc_pairs.values():
        want = jcond.build_velocity_operators(jsys, *args())
        got = pcond.build_velocity_operators(psys, *args())
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert np.abs(got[3]).max() > 0  # vo_b with HoH
    for pol in "xyz":
        assert np.array_equal(pcond._l_op18(pol), jcond._l_op18(pol))
        assert np.array_equal(pcond.spin_current(got[0], pol),
                              jcond.spin_current(got[0], pol))


# ----------------------------------------------------------------------
# the moments
def _tables(sys_, mod=jcond):
    """Velocity tables (v_a, v_b, vo_a, vo_b) of the default directions,
    built by ``mod``, and the onsite table."""
    vel = mod.build_velocity_operators(sys_, np.array([0.0, 1.0, 0.0]),
                                       np.array([1.0, 0.0, 0.0]))
    return vel, sys_.ham.lsham


@pytest.mark.parametrize("hoh", [False, True])
def test_kubo_moments_match_jax(bcc_pairs, hoh, monkeypatch):
    """The port's ``kubo_moments`` at a left block of 3 (n = 8) against the
    JAX ``kubo_moments`` at the same block, within 1e-12 of scale; K4
    called ``launches(8, 3)`` times; the port's moments at one left block
    and right groups of 3 within 1e-13 of scale of them."""
    jsys, psys = bcc_pairs[hoh]
    hb = jsys.ham
    (va, vb, vo_a, vo_b), lsh = _tables(jsys)
    kk = jsys.cluster.kk
    psi = np.zeros((kk, 18, 18), np.complex128)
    psi[5] = np.eye(18)
    hoh_kw = dict(hoh=True, vo_a=jnp.asarray(vo_a), vo_b=jnp.asarray(vo_b),
                  blocks_o=jnp.asarray(hb.eeo),
                  enim=jnp.asarray(hb.enim)) if hoh else {}
    want = np.asarray(jax_kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsh), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(va), jnp.asarray(vb),
        jnp.asarray(psi), n_moments=NMOM, block_size=3, a=AB[0], b=AB[1],
        **hoh_kw))
    pad = np.concatenate([psi, np.zeros((1, 18, 18))])[None]
    psi0 = torch.from_numpy(port_layout(pad))
    op = BlockOperator(hb.ee, hb.iz, hb.cols, lsh, hoh=hoh,
                       hso=hb.eeo if hoh else None,
                       enim=hb.enim if hoh else None)
    vops = [kubo.VelocityOperator(v, hb.iz, hb.cols, vo if hoh else None)
            for v, vo in ((va, vo_a), (vb, vo_b))]
    calls = _count_k4(monkeypatch)
    got = kubo.kubo_moments(op, *vops, psi0, NMOM, *AB, 3)
    assert len(calls) == kubo.launches(NMOM, 3, hoh)
    assert got.shape == (1, NMOM, NMOM, 18, 18)
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got[0].numpy() - want).max() <= 1e-12 * scale
    other = kubo.kubo_moments(op, *vops, psi0, NMOM, *AB, NMOM, group=3)
    assert (other - got).abs().max() <= 1e-13 * scale


def test_launch_counts():
    """Without HoH: the left chain's 7 H and 8 velocity applications, and
    per left block v_b and 7 H; with HoH: two launches per left H, and per
    block 3 for v_b, 3 per right velocity and 1 per right H."""
    assert kubo.launches(8, 8, False) == 7 + 8 + 8
    assert kubo.launches(8, 3, False) == 7 + 8 + 3 * 8
    assert kubo.launches(8, 8, True) == 14 + 3 + 24 + 7
    assert kubo.launches(8, 3, True) == 14 + 3 * 34


def test_start_vectors_match_jax():
    """The unit blocks at the types' ``atlist`` atoms, and the random
    phases drawn unit after unit from the JAX package's seed."""
    jsys, psys = _systems("B2")
    cl = psys.cluster
    got = pcond.kubo_start_vectors(cl, "per_type", 2, CPU)
    want = np.zeros((2, cl.kk + 1, 18, 18), np.complex128)
    for t in range(2):
        want[t, int(jsys.cluster.atlist[t]) - 1] = np.eye(18)
    assert torch.equal(got, torch.from_numpy(port_layout(want)))
    got = pcond.kubo_start_vectors(cl, "random_vec", 3, CPU)
    rng = np.random.default_rng(20260821)
    want = np.zeros((3, cl.kk + 1, 18, 18), np.complex128)
    for t in range(3):
        ph = np.exp(2j * np.pi * rng.random(cl.kk)) / np.sqrt(float(cl.kk))
        want[t, :cl.kk] = ph[:, None, None] * np.eye(18)
    assert torch.equal(got, torch.from_numpy(port_layout(want)))


def test_moments_match_jax(runs):
    """``run()``'s moments (18, 18, n, m, units) within 1e-12 of scale:
    per_type units side by side (B2: 2, the slab: 4) against the JAX
    package's loop over them, random_vec's two vectors."""
    got, want = runs["got"], runs["want"]
    units = {"B2": 2, "S": 4}.get(runs["case"], 1)
    if runs["case"].startswith("random"):
        units = 2
    assert got.shape == want.shape == (18, 18, NMOM, NMOM, units)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale


def test_k4_calls_per_run(runs):
    """One block of the whole left chain: ``launches(n, n)`` K4 calls (the
    plain version here) for all start blocks side by side."""
    hoh = runs["psys"].cfg.hamiltonian.hoh
    assert runs["k4_calls"] == kubo.launches(NMOM, NMOM, hoh)


def test_outputs_match_jax(runs):
    dirs = runs["dirs"]
    names = sorted(os.listdir(dirs["torch"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    per_type = not runs["case"].startswith("random")
    labels = runs["psys"].cfg.atoms.labels if per_type else []
    assert set(names) == {"cond_total.out", "cond_total_orb_real.out",
                          "cond_total_orb_im.out"} | {
        f"{lab}{suf}" for lab in labels
        for suf in ("_cond.out", "_cond_orb_real.out", "_cond_orb_im.out")}
    for fname in names:
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_integrand_matches_jax(runs, tmp_path):
    """``conductivity_tensor`` of the JAX package's moments: the integrand
    (18, NE, units) within 1e-12 of its scale."""
    jsys, psys = runs["jsys"], runs["psys"]
    mu = runs["want"]
    cfg = jsys.cfg
    em = JaxMesh.build(cfg.energy)
    a = (em.energy_max - em.energy_min) / 1.7
    b = (em.energy_max + em.energy_min) / 2.0
    want = jcond.ConductivityCalculation(jsys, str(tmp_path)) \
        .conductivity_tensor(mu, em, a, b, NMOM)
    got = pcond.ConductivityCalculation(psys, str(tmp_path)) \
        .conductivity_tensor(torch.from_numpy(mu), em, a, b, NMOM)
    assert got.shape == want.shape == (18, em.npts, mu.shape[4])
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_start_blocks_in_groups(monkeypatch):
    """A budget that holds one start block's chains but not two: the B2
    run's units recur one at a time (left blocks of 5, then of the whole
    chain) and give the side-by-side moments within 1e-13 of scale."""
    psys = presets.build_synthetic_b2(rc=RC, nsp=2, device="cpu")
    calc = pcond.ConductivityCalculation(psys)
    (va, vb, _, _), _ = _tables(psys, pcond)
    both = calc.compute_moments(va, vb, *AB, NMOM)
    kk = psys.cluster.kk
    unit = (kk + 1) * 18 * 18 * 16
    for nvec, size in ((5, 5), (NMOM, NMOM)):
        budget = (kubo.WORK_VECS + NMOM + nvec) * unit
        monkeypatch.setattr(kubo, "CPU_BUDGET", budget)
        assert kubo.plan(kk, 2, NMOM, CPU) == (1, size)
        calls = _count_k4(monkeypatch)
        one = calc.compute_moments(va, vb, *AB, NMOM)
        assert len(calls) == 2 * kubo.launches(NMOM, size, False)
        monkeypatch.undo()
        assert (one - both).abs().max() <= 1e-13 * both.abs().max()
    monkeypatch.setattr(kubo, "CPU_BUDGET", (kubo.WORK_VECS + 8) * unit)
    with pytest.raises(MemoryError):
        kubo.plan(kk, 2, NMOM, CPU)


def test_carried_state_gives_jax_moments(tmp_path):
    """The JAX system's arrays carried into the port by ``convert``: the
    port's conductivity run gives the JAX package's moments."""
    jsys, psys = _systems("bcc")
    arrays, pots = system_to_numpy(jsys)
    carried = system_from_numpy(arrays, pots, CPU, cfg=copy.deepcopy(
        psys.cfg))
    out = []
    for mod, sys_, name in ((jcond, jsys, "jax"), (pcond, carried, "torch")):
        (tmp_path / name).mkdir()
        out.append(mod.ConductivityCalculation(sys_,
                                               str(tmp_path / name)).run())
    want, got = out
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ----------------------------------------------------------------------
# the entry points
@pytest.mark.parametrize("hoh", [False, True])
@pytest.mark.parametrize("units", ["per_type", "random_vec"])
def test_cli_matches_jax_cli(tmp_path, capsys, units, hoh):
    psys = presets.build_synthetic_bcc(rc=RC, lld=4, nsp=2, hoh=hoh,
                                       device="cpu")
    _configure(psys, units, hoh)
    src = tmp_path / "src"
    src.mkdir()
    presets.write_conductivity_input(psys, str(src))
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
    assert {"cond_total.out", "cond_total_orb_real.out"} <= set(files)
    assert ("X_cond.out" in files) == (units == "per_type")
    for fname in files:
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_refusals(tmp_path, monkeypatch):
    """The impurity cluster raises, naming its ROADMAP entry; the geometry
    exports are written beside ``conductivity_p2rs`` before it runs."""
    cfg = presets.synthetic_embedded_config("I", 12.0, 8, 2)
    isys = presets.build_synthetic_embedded(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        pcond.ConductivityCalculation(isys, str(tmp_path))
    psys = presets.build_synthetic_bcc(rc=RC, lld=4, nsp=2, device="cpu")
    psys.cfg.calculation.post_processing = "conductivity_p2rs"
    psys.cfg.lattice.write_artifacts = True
    presets.write_input(psys, str(tmp_path))  # the element file X.nml
    psys.cfg.atoms.database = str(tmp_path)
    ran = []
    monkeypatch.setattr(cli, "run_system", lambda sys_, wd: ran.append(
        sys_.cfg.calculation.post_processing))
    out = tmp_path / "out"
    assert cli.run_calculation(psys.cfg, str(out), device="cpu") == 0
    assert {"clust", "map", "str.out", "sbar", "view.sbar"} <= set(
        os.listdir(out))
    assert ran == ["conductivity_p2rs"]
