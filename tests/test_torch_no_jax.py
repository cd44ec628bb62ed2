"""The port never imports JAX, and never runs on another device than the
one asked for.

The import check runs in a subprocess: this test session imports JAX in
``tests/conftest.py``.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import rslmtoasa_tpu_torch as pkg

names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert {"rslmtoasa_tpu_torch.geometry.surface",
        "rslmtoasa_tpu_torch.physics.madelung_surf",
        "rslmtoasa_tpu_torch.models.exchange",
        "rslmtoasa_tpu_torch.models.conductivity",
        "rslmtoasa_tpu_torch.ops.kubo",
        "rslmtoasa_tpu_torch.models.paoflow",
        "rslmtoasa_tpu_torch.models.orbital",
        "rslmtoasa_tpu_torch.models.spin_dynamics",
        "rslmtoasa_tpu_torch.ops.wavefront",
        "rslmtoasa_tpu_torch.physics.atomsphere",
        "rslmtoasa_tpu_torch.physics.radial",
        "rslmtoasa_tpu_torch.physics.xc_lda",
        "rslmtoasa_tpu_torch.utils.artifacts",
        "rslmtoasa_tpu_torch.parallel.mesh",
        "rslmtoasa_tpu_torch.parallel.launch",
        "rslmtoasa_tpu_torch.parallel.stages",
        "rslmtoasa_tpu_torch.ops.rowslab",
        "rslmtoasa_tpu_torch.dryrun"} <= set(names)

from rslmtoasa_tpu_torch.ops.lanczos import (
    HaydockOperator, scalar_start_vectors)

rng = np.random.default_rng(0)
kk, nslots = 6, 3
hs = rng.standard_normal((1, nslots, 9, 9)) + 1j * rng.standard_normal(
    (1, nslots, 9, 9))
hs = hs + hs.conj().transpose(0, 1, 3, 2)
cols = np.stack([np.arange(kk), (np.arange(kk) + 1) % kk,
                 np.full(kk, kk)], axis=1)
op = HaydockOperator(hs, np.zeros(kk), cols)
a, b2 = op.coefficients(scalar_start_vectors(kk, [0], torch.device("cpu")),
                        4)
assert a.shape == (4, 9) and bool(torch.isfinite(b2).all())

from rslmtoasa_tpu_torch.ops.block_lanczos import (
    BlockOperator, block_lanczos, block_start_vectors)

hs18 = rng.standard_normal((1, nslots, 18, 18)) + 1j * rng.standard_normal(
    (1, nslots, 18, 18))
bop = BlockOperator(hs18, np.zeros(kk), cols, np.zeros((1, 18, 18)))
a_b, b2_b = block_lanczos(
    bop, block_start_vectors(kk, [0], torch.device("cpu")), 3)
assert a_b.shape == (3, 1, 18, 18) and bool(torch.isfinite(b2_b).all())
print(len(names), "jax" in sys.modules)
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    nmods, has_jax = res.stdout.split()
    assert int(nmods) >= 25
    assert has_jax == "False"


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from rslmtoasa_tpu_torch import resolve_device
    from rslmtoasa_tpu_torch.cli import main
    from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_synthetic_bcc(rc=4.0, ndim=200, lld=4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(tmp_path / "input.nml")])  # the default device is cuda
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_bulk_system_defaults_to_the_card():
    """``BulkSystem(cfg=...)`` built directly asks for the card, as
    ``BulkSystem.build`` does: without one it raises; the CPU is taken
    only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from rslmtoasa_tpu_torch.models.bulk import BulkSystem
    from rslmtoasa_tpu_torch.models.presets import synthetic_bcc_config

    cfg = synthetic_bcc_config(rc=4.0, ndim=200, lld=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BulkSystem(cfg=cfg)
    assert BulkSystem(cfg=cfg, device="cpu").device == torch.device("cpu")


def test_radial_source_is_the_ports_own_copy():
    """The native solver builds from a file inside the port, byte-equal
    to the JAX package's ``native/radial.cpp``."""
    from rslmtoasa_tpu_torch import native

    src = pathlib.Path(native.SOURCE).resolve()
    port = ROOT / "rslmtoasa_tpu_torch"
    assert src.is_relative_to(port)
    jax_src = ROOT / "rslmtoasa_tpu" / "native" / "radial.cpp"
    assert src.read_bytes() == jax_src.read_bytes()
