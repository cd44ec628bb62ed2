"""The port's spin dynamics (``processing='sd'``) against the JAX package's
(CPU).

* ``MTGaussian``: the same stream, bit for bit, as the JAX package's class
  for the same seed, across calls of odd sizes (the spare value);
* the two-spin dimer testbench of ``tests/test_spin_dimer.py`` on the
  port's Depondt integrator (norms, invariants, the Larmor rate, damped
  alignment), its trajectory bit-equal to the JAX package's;
* the torques and one Euler or Depondt step (``sd_temp > 0``: the thermal
  field runs) on one SCF state: the JAX package's after one ``nsp=3``
  iteration, carried into the port by ``convert``; each package's
  ``SpinDynamics.run`` with its SCF left out, ``asd_step=1``: the moments
  within 1e-12 of the JAX package's and the trajectory file equal;
* a 2-step ``sd`` run through both command-line drivers on the ``nsp=3`` bcc
  preset (``rc=5``, lld 8, the start moment tilted, Depondt at 300 K):
  ``output.lammpstrj`` within 1e-6, one unit of the last printed digit
  allowed (``test_torch_block``), and the other files with the same words.
  Each step's SCF carries the atomic-sphere solver's noise (ROADMAP queue 3,
  "the second SCF iteration"): the first SCF's inputs agree within 1e-14,
  its potential parameters within 4e-11, and the next SCF's moments land
  ~1e-8 apart, which moves the DOS files' fifth decimals; the trajectory
  prints four.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.models import spin_dynamics as jsd
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu.utils.namelist import parse_namelists as jparse
from rslmtoasa_tpu_torch import cli
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models import spin_dynamics as psd
from rslmtoasa_tpu_torch.utils.namelist import parse_namelists
from test_torch_block import _assert_printed_close
from test_torch_scf import _assert_files_close

CPU = torch.device("cpu")
RC, LLD, NE = 5.0, 8, 200
TILT = np.array([0.3, -0.4, 0.866])
SD = {"integrator": "depondt", "sd_temp": 300.0, "asd_step": 2,
      "alpha": 0.1, "dt": 1e-15, "sd_seed": 4321}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread per xdist worker, as in
    ``test_torch_block``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("seed", [1234, 7])
def test_mtgaussian_bit_equal(seed):
    got, want = psd.MTGaussian(seed), jsd.MTGaussian(seed)
    for shape in [(3, 1), (3, 2), (5,), (3, 7), (1,), (2, 3)]:
        assert np.array_equal(got.standard_normal(shape),
                              want.standard_normal(shape))


# ----------------------------------------------------------------------
# the dimer testbench of tests/test_spin_dimer.py on the port's integrator
def _dimer_run(mod, j_field, m0, nsteps, dt, lam=0.0, temp=0.0):
    """Integrate two moments with field B_i = j_field * m_j (a.u.)."""
    rng = mod.MTGaussian(7)
    mmom = np.linalg.norm(m0, axis=0)
    emom = m0 / mmom[None, :]
    traj = [emom.copy()]
    for _ in range(nsteps):
        beff = j_field * emom[:, ::-1] * mmom[None, ::-1]
        emom_p, b2eff, _ = mod.depondt_evolve_first(lam, beff, emom, mmom,
                                                    dt, temp, rng)
        beff2 = j_field * emom_p[:, ::-1] * mmom[None, ::-1]
        emom = mod.depondt_evolve_second(lam, beff2, b2eff, emom, dt)
        traj.append(emom.copy())
    return np.asarray(traj)  # (nsteps+1, 3, 2)


def test_dimer_norm_and_invariants():
    m0 = np.array([[0.0, 5.0], [0.0, 0.0], [5.0, 0.0]])
    j = -3.4e-3
    dt = 0.05 / (psd.GAMA * abs(j) * 5.0)  # ~0.05 rad per step
    traj = _dimer_run(psd, j, m0, nsteps=400, dt=dt)
    norms = np.linalg.norm(traj, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)
    tot = traj.sum(axis=2)
    np.testing.assert_allclose(tot @ tot[0], (tot[0] @ tot[0]), rtol=5e-6)
    # with a thermal field too, the JAX package's trajectory bit for bit
    for temp in (0.0, 50.0):
        assert np.array_equal(
            _dimer_run(psd, j, m0, 50, dt, lam=0.05, temp=temp),
            _dimer_run(jsd, j, m0, 50, dt, lam=0.05, temp=temp))


def test_larmor_precession_frequency():
    """Constant external field: the rotation advances the azimuthal phase
    at exactly GAMA |B| per unit time."""
    rng = psd.MTGaussian(3)
    bmag = 1.0e-2
    beff = np.array([[0.0], [0.0], [bmag]])
    mmom = np.array([5.0])
    emom = np.array([[np.sin(0.3)], [0.0], [np.cos(0.3)]])
    dt = 0.04 / (psd.GAMA * bmag)
    phis = []
    for _ in range(500):
        e_p, b2eff, _ = psd.depondt_evolve_first(0.0, beff, emom, mmom, dt,
                                                 0.0, rng)
        emom = psd.depondt_evolve_second(0.0, beff, b2eff, emom, dt)
        phis.append(np.arctan2(emom[1, 0], emom[0, 0]))
    phi = np.unwrap(np.asarray(phis))
    rate = np.polyfit(np.arange(len(phi)) * dt, phi, 1)[0]
    want = psd.GAMA * bmag
    assert abs(abs(rate) - want) < 1e-6 * want, (rate, want)


def test_dimer_damped_alignment():
    m0 = np.array([[0.5, 0.0], [0.0, 0.5], [5.0, 5.0]])
    j = +2.0e-3
    dt = 0.05 / (psd.GAMA * abs(j) * 5.0)
    traj = _dimer_run(psd, j, m0, nsteps=3000, dt=dt, lam=0.1)
    cosang = np.einsum("tia,tia->t", traj[:, :, :1], traj[:, :, 1:])
    assert cosang[-1] > 0.9999
    assert cosang[-1] > cosang[0]


# ----------------------------------------------------------------------
# the torques and one step on one SCF state
def _sd_text(sd):
    return "&sd\n" + "".join(f" {k} = {v!r}\n" for k, v in sd.items()) \
        + "/\n"


@pytest.mark.parametrize("integrator", ["euler", "depondt"])
def test_torques_and_step_on_one_state(tmp_path, integrator):
    sd = dict(SD, integrator=integrator, asd_step=1)
    jsys = jpresets.build_synthetic_bcc(rc=RC, ndim=500, lld=LLD, nsp=3)
    jsys.cfg.energy.channels_ldos = NE
    jsys.atoms[0].potential.mom = TILT.copy()
    JaxSCF(jsys, workdir=str(tmp_path)).run(nstep=1)
    cfg = presets.synthetic_bcc_config(rc=RC, ndim=500, lld=LLD, nsp=3)
    cfg.energy.channels_ldos = NE
    cfg.namelists = parse_namelists(_sd_text(sd))
    jsys.cfg.namelists = jparse(_sd_text(sd))
    psys = system_from_numpy(*system_to_numpy(jsys), CPU, cfg=cfg)
    iz_rec = [0]
    torques = psd.magnetic_torques(psys.atoms, iz_rec)
    want = jsd.magnetic_torques(jsys.atoms, iz_rec)
    assert np.abs(want).max() > 1.0
    assert np.abs(torques - want).max() <= 1e-12 * np.abs(want).max()
    mom0 = psys.atoms[0].potential.mom0
    before = mom0 / np.linalg.norm(mom0)
    moms = {}
    for name, mod, sys_ in (("jax", jsd, jsys), ("torch", psd, psys)):
        (tmp_path / name).mkdir()
        run = mod.SpinDynamics(sys_, str(tmp_path / name))
        assert run.params.integrator == integrator
        run.scf.run = lambda *a, **k: None  # the state is the SCF's
        moms[name] = run.run()
    pots = [s.atoms[0].potential for s in (jsys, psys)]
    assert np.abs(pots[1].mom - before).max() > 1e-6  # the step moved it
    assert np.abs(moms["torch"] - moms["jax"]).max() <= 1e-12
    assert np.abs(pots[1].mom - pots[0].mom).max() <= 1e-12
    traj = [(tmp_path / n / "output.lammpstrj").read_text()
            for n in ("jax", "torch")]
    assert traj[0] == traj[1]


def test_cli_matches_jax_cli(tmp_path, capsys):
    psys = presets.build_synthetic_bcc(rc=RC, ndim=500, lld=LLD, nsp=3,
                                       device="cpu")
    psys.cfg.energy.channels_ldos = NE
    psys.atoms[0].potential.mom = TILT.copy()
    src = tmp_path / "src"
    src.mkdir()
    presets.write_input(psys, str(src), sd=SD)
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
    traj = (dirs["torch"] / "output.lammpstrj").read_text()
    assert traj.count("ITEM: TIMESTEP") == SD["asd_step"]
    _assert_printed_close(dirs["jax"] / "output.lammpstrj",
                          dirs["torch"] / "output.lammpstrj")
    for fname in files:
        _assert_files_close(dirs["jax"] / fname, dirs["torch"] / fname,
                            tol=np.inf)
