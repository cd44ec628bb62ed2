"""The port's host substrate against the JAX package's (CPU).

Geometry (``cr``, ``nn``, ``cols``, screened structure constants) and the
Hamiltonian tables (``ee``, ``eeo``, ``enim``, ``lsham``, ``iz``) come from
NumPy code the port copied, so they must agree to the last bit or within
1e-14.  The state carried across by :mod:`rslmtoasa_tpu_torch.convert`
must rebuild the port's own system.
"""

import numpy as np
import pytest
import torch

from rslmtoasa_tpu.models import presets as jp
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models import presets as tp

CASES = {
    "bcc": ("build_synthetic_bcc", dict(rc=8.0, ndim=2000, lld=8, nsp=1)),
    "bcc-soc-hoh": ("build_synthetic_bcc",
                    dict(rc=8.0, ndim=2000, lld=8, nsp=2, hoh=True)),
    "b2-hoh": ("build_synthetic_b2", dict(rc=9.0, hoh=True)),
}
TOL = 1e-14


def _pair(case):
    fn, kw = CASES[case]
    return getattr(jp, fn)(**kw), getattr(tp, fn)(device="cpu", **kw)


def _assert_close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    if a.dtype.kind in "iub":
        assert np.array_equal(a, b), name
    else:
        assert np.abs(a - b).max(initial=0.0) <= TOL, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_geometry_matches_jax(case):
    js, ts = _pair(case)
    jc, tc = js.cluster, ts.cluster
    assert jc.kk == tc.kk
    for name in ("cr", "iz", "num", "nn", "irec", "atlist"):
        _assert_close(getattr(jc, name), getattr(tc, name), name)
    assert len(jc.dirs) == len(tc.dirs)
    for jd, td in zip(jc.dirs, tc.dirs):
        _assert_close(jd, td, "dirs")
    assert len(js.sbars) == len(ts.sbars)
    for jb, tb, jv, tv in zip(js.sbars, ts.sbars, js.sbarvecs, ts.sbarvecs):
        _assert_close(jb, tb, "sbar")
        _assert_close(jv, tv, "sbarvec")


@pytest.mark.parametrize("case", sorted(CASES))
def test_hamiltonian_matches_jax(case):
    js, ts = _pair(case)
    for name in ("ee", "eeo", "enim", "lsham", "iz", "cols"):
        jv, tv = getattr(js.ham, name), getattr(ts.ham, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            _assert_close(jv, tv, name)
    for ja, ta in zip(js.atoms, ts.atoms):
        _assert_close(ja.potential.cshi, ta.potential.cshi, "cshi")
        _assert_close(ja.potential.dw_l, ta.potential.dw_l, "dw_l")


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_rebuilds_port_system(case):
    """JAX state carried across == the port's own build, Hamiltonian
    rebuilt from the carried geometry and potentials included."""
    js, ts = _pair(case)
    arrays, pots = system_to_numpy(js)
    cs = system_from_numpy(arrays, pots, torch.device("cpu"), cfg=ts.cfg)
    assert cs.device == torch.device("cpu")
    assert np.array_equal(cs.ham.ee, ts.ham.ee)
    assert np.array_equal(cs.ham.cols, ts.ham.cols)
    cs.build_hamiltonian()
    for name in ("ee", "eeo", "enim", "lsham"):
        jv, tv = getattr(cs.ham, name), getattr(ts.ham, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            _assert_close(jv, tv, name)
