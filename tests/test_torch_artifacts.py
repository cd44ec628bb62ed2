"""The port's geometry exports against the JAX package's (CPU).

``utils/artifacts.py`` is a NumPy copy of the JAX package's.  On the bcc
preset (``rc=8``) and the impurity preset (its ``str.out`` header lists the
local zone) the five files of ``export_geometry`` (``clust``, ``map``,
``str.out``, ``sbar``, ``view.sbar``) are byte-equal to the JAX package's;
``mad.mat``'s Fortran framing is checked as ``tests/test_artifacts.py``
does, and so is the flag gate (``&lattice write_artifacts`` or
``RSLMTO_WRITE_GEOM``).
"""

import os
import struct

import numpy as np
import pytest

from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.utils import artifacts as jartifacts
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.utils import artifacts
from test_torch_embedded import _jax_system as jax_embedded

FILES = ("clust", "map", "str.out", "sbar", "view.sbar")


def _systems(name):
    if name == "bcc":
        return (jpresets.build_synthetic_bcc(rc=8.0, lld=4),
                presets.build_synthetic_bcc(rc=8.0, lld=4, device="cpu"))
    cfg = presets.synthetic_embedded_config("I", 12.0, 4, 2)
    return jax_embedded(cfg), presets.build_synthetic_embedded(cfg,
                                                                device="cpu")


@pytest.mark.parametrize("name", ["bcc", "impurity"])
def test_exports_byte_equal_to_jax(tmp_path, name):
    jsys, psys = _systems(name)
    for sub, mod, sys_ in (("jax", jartifacts, jsys),
                           ("torch", artifacts, psys)):
        (tmp_path / sub).mkdir()
        mod.export_geometry(sys_, str(tmp_path / sub))
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(FILES)
    for fname in FILES:
        got = (tmp_path / "torch" / fname).read_bytes()
        assert got and got == (tmp_path / "jax" / fname).read_bytes(), fname


def _read_records(path):
    out = []
    with open(path, "rb") as fh:
        while head := fh.read(4):
            n = struct.unpack("<i", head)[0]
            payload = fh.read(n)
            assert struct.unpack("<i", fh.read(4))[0] == n, "framing"
            out.append(payload)
    return out


def test_mad_mat_framing(tmp_path):
    amad = np.arange(9.0).reshape(3, 3)
    artifacts.write_mad_mat(amad, str(tmp_path / "mad.mat"))
    jartifacts.write_mad_mat(amad, str(tmp_path / "mad.jax"))
    recs = _read_records(tmp_path / "mad.mat")
    assert np.array_equal(
        np.stack([np.frombuffer(r, np.float64) for r in recs]), amad)
    assert (tmp_path / "mad.mat").read_bytes() == (
        tmp_path / "mad.jax").read_bytes()


def test_flag_gate(monkeypatch):
    monkeypatch.delenv("RSLMTO_WRITE_GEOM", raising=False)
    cfg = presets.synthetic_bcc_config(rc=8.0, lld=4)
    assert not artifacts.wanted(cfg)
    cfg.lattice.write_artifacts = True
    assert artifacts.wanted(cfg)
    cfg.lattice.write_artifacts = False
    monkeypatch.setenv("RSLMTO_WRITE_GEOM", "1")
    assert artifacts.wanted(cfg)
