"""The port's bulk scalar-Haydock SCF against the JAX package's (CPU).

A 2-iteration ``SelfConsistency`` on ``build_synthetic_bcc(rc=8,
ndim=2000, lld=8, nsp=1)`` runs through the JAX package, through the port
on its own build, and through the port on the JAX state carried across by
``convert``; each in its own temporary directory.  Then both command-line
drivers run the same input files.

Bars: etot within 1e-9 (|etot| is about 2542 Ry, so that is 4e-13
relative); fermi, ql and mom within 1e-10; written files numerically
equal within 1e-6 (relative above one), the reference's own bar for its
outputs.
"""

import os
import re
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models.presets import build_synthetic_bcc as jax_bcc
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu_torch.cli import main as torch_cli
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models import scf as scf_module
from rslmtoasa_tpu_torch.models.presets import (
    build_synthetic_bcc,
    synthetic_bcc_config,
)
from rslmtoasa_tpu_torch.models.scf import (
    SelfConsistency,
    update_fermi_in_input,
)
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.utils.namelist import write_namelist

PRESET = dict(rc=8.0, ndim=2000, lld=8, nsp=1)
NSTEP = 2
NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eEdD][-+]?\d+)?")


def _scf(sys_, scf_cls, workdir):
    scf = scf_cls(sys_, workdir=str(workdir))
    state = scf.run(nstep=NSTEP)
    pot = sys_.atoms[0].potential
    return dict(etot=pot.etot, fermi=scf.fermi, ql=pot.ql.copy(),
                mom=np.array(pot.mom), delta=state.delta, dir=workdir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jsys = jax_bcc(**PRESET)
    arrays, pots = system_to_numpy(jsys)
    jax_run = _scf(jsys, JaxSCF, tmp_path_factory.mktemp("jax"))
    own = _scf(build_synthetic_bcc(device="cpu", **PRESET), SelfConsistency,
               tmp_path_factory.mktemp("torch"))
    carried = system_from_numpy(arrays, pots, torch.device("cpu"),
                                cfg=synthetic_bcc_config(**PRESET))
    conv = _scf(carried, SelfConsistency, tmp_path_factory.mktemp("conv"))
    return jax_run, {"own-build": own, "carried-state": conv}


def _parse(path):
    """(words with numbers blanked, numbers) of a text file; numbers may
    differ in width (a sign), so the comparison is by word."""
    words = open(path).read().split()
    nums = [float(x.replace("d", "e").replace("D", "e"))
            for w in words for x in NUM.findall(w)]
    return [NUM.sub("#", w) for w in words], np.array(nums)


def _assert_files_close(p1, p2, tol=1e-6):
    name = os.path.basename(p1)
    (w1, n1), (w2, n2) = _parse(p1), _parse(p2)
    bad = next((i for i, (a, b) in enumerate(zip(w1, w2)) if a != b), None)
    assert len(w1) == len(w2) and bad is None, f"{name}: word {bad} differs"
    assert n1.shape == n2.shape, name
    # 1e-6, relative above one: a field printed to 6 decimals can round
    # either way when the two values straddle a print boundary
    err = float((np.abs(n1 - n2) / np.maximum(1.0, np.abs(n1))).max(
        initial=0.0))
    assert err <= tol, f"{name}: max difference {err}"


@pytest.mark.parametrize("which", ["own-build", "carried-state"])
def test_scf_scalars_match_jax(runs, which):
    ref, got = runs[0], runs[1][which]
    assert np.isfinite(got["etot"]) and got["etot"] < -2000.0
    assert abs(got["etot"] - ref["etot"]) <= 1e-9
    assert abs(got["fermi"] - ref["fermi"]) <= 1e-10
    assert np.abs(got["ql"] - ref["ql"]).max() <= 1e-10
    assert np.abs(got["mom"] - ref["mom"]).max() <= 1e-10
    assert abs(got["delta"] - ref["delta"]) <= 1e-10


@pytest.mark.parametrize("which", ["own-build", "carried-state"])
@pytest.mark.parametrize("fname", ["totaldos.out", "X_out.nml",
                                   "X_dos.out", "X_orbital_dos.out"])
def test_scf_outputs_match_jax(runs, which, fname):
    _assert_files_close(runs[0]["dir"] / fname, runs[1][which]["dir"] / fname)


def _input_text(cfg):
    lat, en = cfg.lattice, cfg.energy
    return "".join([
        write_namelist("calculation", {
            "pre_processing": cfg.calculation.pre_processing}),
        write_namelist("control", {
            "calctype": cfg.control.calctype, "nsp": cfg.control.nsp,
            "lld": cfg.control.lld, "recur": cfg.control.recur}),
        write_namelist("lattice", {
            "rc": lat.rc, "ndim": lat.ndim, "alat": lat.alat,
            "wav": lat.wav, "crystal_sym": lat.crystal_sym,
            "ntype": lat.ntype, "r2": lat.r2, "ct": [lat.ct[0]]}),
        write_namelist("atoms", {"database": "", "label": cfg.atoms.labels}),
        write_namelist("self", {"nstep": NSTEP}),
        write_namelist("energy", {
            "channels_ldos": en.channels_ldos, "energy_min": en.energy_min,
            "energy_max": en.energy_max, "fermi": en.fermi}),
        write_namelist("mix", {"beta": cfg.mix.beta,
                               "mixtype": cfg.mix.mixtype}),
    ])


def test_cli_matches_jax_cli(tmp_path, capsys):
    """Both drivers on the same input.nml and X.nml (the element file
    written by the JAX package's checkpoint writer) write the same files;
    the PAOFLOW export rs2paoham.dat among them."""
    src = tmp_path / "src"
    src.mkdir()
    JaxSCF(jax_bcc(**PRESET), workdir=str(src)).save_checkpoints()
    os.rename(src / "X_out.nml", src / "X.nml")
    (src / "input.nml").write_text(_input_text(synthetic_bcc_config(**PRESET)))
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    inp = lambda name: str(dirs[name] / "input.nml")
    assert jax_cli([inp("jax"), f"output={dirs['jax']}"]) == 0
    assert torch_cli([inp("torch"), f"output={dirs['torch']}",
                      "device=cpu"]) == 0
    capsys.readouterr()
    jax_files = set(os.listdir(dirs["jax"]))
    torch_files = set(os.listdir(dirs["torch"]))
    assert torch_files == jax_files
    assert {"totaldos.out", "X_out.nml", "report.out",
            "rs2paoham.dat"} <= torch_files
    for fname in sorted(torch_files):
        _assert_files_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_fermi_rewrites_at_once_keep_the_input(tmp_path):
    """Every rank of a multi-rank run rewrites ``fermi`` in the same input
    file: four threads doing so at once leave the whole file, with the new
    value and its comment, and no temporary file beside it."""
    text = "&control\n  recur = 'block'\n/\n&energy\n  fermi = -0.1 ! eF\n/\n"
    path = tmp_path / "input.nml"
    path.write_text(text)
    go = threading.Barrier(4)

    def rewrite():
        go.wait(timeout=60)
        for _ in range(300):
            update_fermi_in_input(-0.25, str(path))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=rewrite) for _ in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert path.read_text() == text.replace("-0.1 ", "-0.250000 ")
    assert os.listdir(tmp_path) == ["input.nml"]


def test_fermi_rewrite_replaces_the_input_whole(tmp_path, monkeypatch):
    """The input file is read and then replaced whole, never opened for
    writing in place: another rank reading it at any moment reads all of
    it, where a truncated file read back would be written back empty."""
    path = tmp_path / "input.nml"
    path.write_text("&energy\n  fermi = -0.1\n/\n")
    opened = []

    def spy(file, mode="r", *args, **kw):
        opened.append((os.path.realpath(file), mode))
        return open(file, mode, *args, **kw)

    monkeypatch.setattr(scf_module, "open", spy, raising=False)
    update_fermi_in_input(-0.25, str(path))
    assert opened == [(os.path.realpath(path), "r")]
    assert path.read_text() == "&energy\n  fermi = -0.250000 \n/\n"


def test_scf_roll_matches_jax(runs, tmp_path, monkeypatch):
    """RSLMTO_ROLL=1 sends the port's SCF through the K2' engine (its
    plain version on the CPU, once per step and spin); the result still
    matches the JAX package's SCF within the same bars."""
    monkeypatch.setenv("RSLMTO_ROLL", "1")
    calls = []
    ref = hk.spmv_dot_pipelined_ref

    def spy(*args):
        calls.append(1)
        return ref(*args)

    monkeypatch.setattr(hk, "spmv_dot_pipelined_ref", spy)
    got = _scf(build_synthetic_bcc(device="cpu", **PRESET), SelfConsistency,
               tmp_path)
    assert len(calls) == NSTEP * 2 * (PRESET["lld"] - 1)
    want = runs[0]
    assert abs(got["etot"] - want["etot"]) <= 1e-9
    assert abs(got["fermi"] - want["fermi"]) <= 1e-10
    assert np.abs(got["ql"] - want["ql"]).max() <= 1e-10
    assert np.abs(got["mom"] - want["mom"]).max() <= 1e-10
