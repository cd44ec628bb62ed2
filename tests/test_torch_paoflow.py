"""The port's PAOFLOW interchange against the JAX package's (CPU).

Preset: the bcc preset ``build_synthetic_bcc(rc=8, nsp=2)`` (kk = 174,
spin-orbit coupling), HoH off and on, lld 8, 200 energy points.

* the export (``rs2paoham.dat``) byte-equal to the JAX package's export of
  the same system, HoH off and on, and after a ``bravais`` SCF through
  both command-line drivers;
* the round trip of ``tests/test_paoflow.py`` on the port's functions;
* the imported ``ee`` within 1e-10 of the JAX import of the same file; with
  HoH the import leaves ``eeo``, ``eeoee`` and ``enim`` as the LMTO build
  made them, in both packages (ROADMAP queue 3);
* a packed K4 table of the Hamiltonian from before the import is never
  handed to an operator built after it;
* ``paoflow2rs``, ``exchange_p2rs`` and ``conductivity_p2rs`` through both
  command-line drivers on the JAX package's export: the same files, within
  1e-6 with one unit of the last printed digit allowed
  (``test_torch_block``).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.models.paoflow import export_rs2pao as jax_export
from rslmtoasa_tpu.models.paoflow import import_paoflow as jax_import
from rslmtoasa_tpu_torch import cli
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models.paoflow import export_rs2pao, import_paoflow
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator
from rslmtoasa_tpu_torch.physics.harmonics import sph2cart
from test_torch_block import _assert_printed_close

RC, LLD, NE = 8.0, 8, 200


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
        out.append(sys_)
    return out


def _cart(blk):
    out = blk.astype(np.complex128).copy()
    for rows in (slice(0, 9), slice(9, 18)):
        for cols in (slice(0, 9), slice(9, 18)):
            out[rows, cols] = sph2cart(out[rows, cols])
    return out


@pytest.mark.parametrize("hoh", [False, True])
def test_export_matches_jax(tmp_path, hoh):
    jsys, psys = _pair(hoh)
    assert (psys.ham.eeo is not None) == hoh
    jax_export(jsys, str(tmp_path / "jax.dat"))
    export_rs2pao(psys, str(tmp_path / "torch.dat"))
    want = (tmp_path / "jax.dat").read_bytes()
    assert len(want) > 300_000
    assert (tmp_path / "torch.dat").read_bytes() == want


def test_roundtrip(tmp_path):
    """The import reconstructs the exported operator in cubic harmonics:
    ee[t, m > 0] -> sph2cart(ee), ee[t, 0] -> sph2cart(ee_onsite + lsham)."""
    _, psys = _pair()
    hb, cl = psys.ham, psys.cluster
    ee_orig, lsham = hb.ee.copy(), hb.lsham.copy()
    path = str(tmp_path / "rs2paoham.dat")
    export_rs2pao(psys, path)
    import_paoflow(psys, path)
    ia = int(cl.atlist[0]) - 1
    nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
    np.testing.assert_allclose(hb.ee[0, 0], _cart(ee_orig[0, 0] + lsham[0]),
                               atol=1e-10)
    for m in range(1, nd + 1):
        np.testing.assert_allclose(hb.ee[0, m], _cart(ee_orig[0, m]),
                                   atol=1e-10)


@pytest.mark.parametrize("hoh", [False, True])
def test_import_matches_jax(tmp_path, hoh):
    jsys, psys = _pair(hoh)
    path = str(tmp_path / "paoham.dat")
    jax_export(jsys, path)
    before = {k: getattr(psys.ham, k) for k in ("eeo", "eeoee", "enim")}
    before = {k: None if v is None else v.copy() for k, v in before.items()}
    jax_import(jsys, path)
    import_paoflow(psys, path)
    assert np.abs(psys.ham.ee - jsys.ham.ee).max() <= 1e-10
    assert np.abs(psys.ham.ee).max() > 0.1
    for k, v in before.items():
        got, want = getattr(psys.ham, k), getattr(jsys.ham, k)
        if v is None:
            assert got is None and want is None and not hoh
        else:
            assert np.array_equal(got, v) and np.array_equal(want, v)


def test_no_packed_table_outlives_the_import(tmp_path):
    """K4 reads its tables packed and cached (``packed_table``).  An
    operator built before the import packs the LMTO table; one built after
    it packs the imported one, and the old operator's table, written in
    place, is packed anew."""
    _, psys = _pair()
    hb = psys.ham
    old = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham)
    packed_old = hk.packed_table(old.hs)
    path = str(tmp_path / "paoham.dat")
    export_rs2pao(psys, path)
    import_paoflow(psys, path)
    new = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham)
    packed_new = hk.packed_table(new.hs)
    assert torch.equal(packed_new, hk.pack_table(new.hs))
    assert not torch.equal(packed_new, packed_old)
    old.hs.copy_(new.hs)
    assert torch.equal(hk.packed_table(old.hs), packed_new)


def _run_both(tmp_path, src):
    """Both drivers on ``src/input.nml`` in copies of ``src``; the two
    output directories after checking that they hold the same files."""
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    inp = lambda name: str(dirs[name] / "input.nml")  # noqa: E731
    assert jax_cli([inp("jax"), f"output={dirs['jax']}"]) == 0
    assert cli.main([inp("torch"), f"output={dirs['torch']}",
                     "device=cpu"]) == 0
    files = sorted(os.listdir(dirs["torch"]))
    assert files == sorted(os.listdir(dirs["jax"]))
    return dirs, files


def test_bravais_scf_writes_the_jax_export(tmp_path, capsys):
    _, psys = _pair()
    src = tmp_path / "src"
    src.mkdir()
    presets.write_input(psys, str(src))
    dirs, files = _run_both(tmp_path, src)
    capsys.readouterr()
    assert "rs2paoham.dat" in files
    want = (dirs["jax"] / "rs2paoham.dat").read_bytes()
    assert (dirs["torch"] / "rs2paoham.dat").read_bytes() == want


@pytest.mark.parametrize("post", ["paoflow2rs", "exchange_p2rs",
                                  "conductivity_p2rs"])
def test_cli_matches_jax_cli(tmp_path, capsys, post):
    jsys, psys = _pair()
    src = tmp_path / "src"
    src.mkdir()
    if post == "exchange_p2rs":
        presets.synthetic_exchange(psys, 2)
        psys.cfg.calculation.post_processing = post
        presets.write_exchange_input(psys, str(src))
    elif post == "conductivity_p2rs":
        psys.cfg.control.cond_ll = 8
        presets.write_conductivity_input(psys, str(src), post)
    else:
        presets.write_input(psys, str(src), post)
    # the JAX package's export of the LMTO Hamiltonian, scaled by 1.01
    # so that the import shows in every file
    jsys.ham.ee *= 1.01
    jax_export(jsys, str(src / "paoham.dat"))
    dirs, files = _run_both(tmp_path, src)
    capsys.readouterr()
    assert "paoham.dat" in files
    if post == "paoflow2rs":
        assert {"totaldos.out", "X_out.nml"} <= set(files)
    for fname in files:
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)
