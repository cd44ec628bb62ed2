"""The noncollinear SCF (``nsp`` 3 and 4) of the port against the JAX
package's (CPU), and the collinear Chebyshev SCF with HoH (``nsp=2``).

Preset: the bcc preset (``rc=8, ndim=2000, lld=8``, as
``tests/test_torch_block.py``) with its start moment tilted to
(0.3, -0.4, 0.866), so that ``Bands`` keeps the moment's direction
(``nsp >= 3``) and the spinor Hamiltonian mixes the spins; ``nsp=4`` adds
spin-orbit coupling.  Block and Chebyshev recursions, HoH off and on (the
HoH atoms given an overlap, so that ``eeo`` counts; the Chebyshev moments
then need the window (-2.0, 1.5), and take (-1.5, 1.0) without HoH).
``nsp2-chebyshev-hoh`` is the same Chebyshev HoH run at ``nsp=2``, its
moment not tilted (ROADMAP item 17).

Two SCF iterations in each package.  The first iteration is held at the
North star's bars: etot within 1e-9, fermi, ql and mom within 1e-10.  The
second is held at the same bars and delta within 1e-10 where both
packages start it from one state (the JAX package's after its first
iteration, carried into the port by ``convert`` with its Fermi level and
mixer): from their own states the two runs' second iterations land up to
~5e-10 apart (fermi 1.7e-10 on ``nsp3-block-hoh``), because the
atomic-sphere solver turns first-iteration inputs 1e-15 apart into
potential parameters ~5e-12 apart (ROADMAP queue 3, "the second SCF
iteration").  The same solver turns inputs 1e-16 apart into an etot up
to ~1e-7 apart (8.7e-9 after the first iteration of ``nsp3-chebyshev-hoh``,
ql 1.6e-16 apart), so an etot miss passes, as in
``tests/test_torch_embedded.py``, only where the solver's inputs of the two
runs agree (ql and pl within 1e-10, the rest equal) and the JAX package's
solver on the port's inputs gives the port's etot (ROADMAP queue 3, "the
first SCF iteration on the slab and impurity presets").  The own runs'
written files are held within 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

from rslmtoasa_tpu import native as jnative
from rslmtoasa_tpu.models.presets import build_synthetic_bcc as jax_bcc
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu_torch import native
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc
from rslmtoasa_tpu_torch.models.scf import SelfConsistency
from test_torch_block import BCC, WINDOW, _assert_printed_close

CPU = torch.device("cpu")
HOH_WINDOW = (-2.0, 1.5)
BARS = dict(etot=1e-9, fermi=1e-10, ql=1e-10, mom=1e-10)
TILT = np.array([0.3, -0.4, 0.866])
OBAR = np.array([[-0.05, -0.055], [-0.04, -0.045], [-0.03, -0.035]])
NC_CASES = [f"nsp{nsp}-{recur}{hoh}" for nsp in (3, 4)
            for recur in ("block", "chebyshev") for hoh in ("", "-hoh")
            ] + ["nsp2-chebyshev-hoh"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread per xdist worker, as in
    ``test_torch_block``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _make(build, name, **kw):
    nsp, recur, *hoh = name.split("-")
    sys_ = build(nsp=int(nsp[3:]), hoh=bool(hoh), **BCC, **kw)
    sys_.cfg.control.recur = recur
    if recur == "chebyshev":
        sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = (
            HOH_WINDOW if hoh else WINDOW)
    for at in sys_.atoms:
        if int(nsp[3:]) >= 3:
            at.potential.mom = TILT.copy()
        if hoh:
            at.potential.obar[:] = OBAR
    return sys_


def _scalars(scf, sys_, calls):
    """The scalars after an iteration, with the inputs of its call of the
    atomic-sphere solver (one rec atom)."""
    pot = sys_.atoms[0].potential
    return dict(etot=pot.etot, fermi=scf.fermi, ql=pot.ql.copy(),
                mom=np.array(pot.mom), delta=scf.state.delta,
                solver=calls[-1])


@pytest.fixture(scope="module")
def solver_calls():
    """Each package's atomic-sphere solver, recording the inputs of every
    call."""
    calls = {"jax": [], "torch": []}
    mp = pytest.MonkeyPatch()
    for pkg, mod in (("jax", jnative), ("torch", native)):
        def recording(solve=mod.atomsc_native, into=calls[pkg], **kw):
            into.append(copy.deepcopy(kw))
            return solve(**kw)
        mp.setattr(mod, "atomsc_native", recording)
    yield calls
    mp.undo()


@pytest.fixture(scope="module", params=NC_CASES)
def nc_runs(request, tmp_path_factory, solver_calls):
    """Each package's scalars after one and two iterations of its own SCF,
    and the port's after its second iteration from the JAX package's state
    after the first; the directories of the own runs."""
    name = request.param
    calls = solver_calls
    out = {}
    for pkg, build, scf_cls, kw in (
            ("jax", jax_bcc, JaxSCF, {}),
            ("torch", build_synthetic_bcc, SelfConsistency,
             {"device": "cpu"})):
        sys_ = _make(build, name, **kw)
        work = tmp_path_factory.mktemp(f"{pkg}-{name}")
        scf = scf_cls(sys_, workdir=str(work))
        scf.run(nstep=1)
        first = _scalars(scf, sys_, calls[pkg])
        if pkg == "jax":
            snap = (system_to_numpy(sys_), scf.fermi,
                    copy.deepcopy(vars(scf.mix)))
        else:
            cfg = copy.deepcopy(sys_.cfg)
        scf.run(nstep=1)
        out[pkg] = dict(first=first, second=_scalars(scf, sys_, calls[pkg]),
                        dir=work)
    carried = system_from_numpy(*snap[0], CPU, cfg=cfg)
    scf = SelfConsistency(carried, workdir=str(
        tmp_path_factory.mktemp(f"carried-{name}")))
    scf.fermi = snap[1]
    scf.mix.__dict__.update(snap[2])
    scf.run(nstep=1)
    out["carried"] = _scalars(scf, carried, calls["torch"])
    out["tilted"] = not name.startswith("nsp2")
    return out


def _assert_within_bars(got, ref, keys):
    """Every scalar of ``keys`` within its bar, etot also within the
    atomic-sphere solver's own difference."""
    bars = dict(BARS, delta=1e-10)
    diffs = {k: float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
             for k in keys}
    assert all(diffs[k] <= bars[k] for k in keys if k != "etot"), diffs
    if diffs["etot"] <= bars["etot"]:
        return
    kw, kw0 = got["solver"], ref["solver"]
    for k in kw:
        d = np.abs(np.asarray(kw[k]) - np.asarray(kw0[k])).max()
        assert d <= (1e-10 if k in ("ql", "pl") else 0.0), (k, diffs)
    assert jnative.atomsc_native(**kw).etot == got["etot"], diffs


def test_nc_first_iteration_matches_jax(nc_runs):
    got, ref = nc_runs["torch"]["first"], nc_runs["jax"]["first"]
    assert np.isfinite(got["etot"]) and got["etot"] < -2000.0
    # a tilted moment keeps a direction off z
    assert not nc_runs["tilted"] or (abs(got["mom"][0]) > 1e-3
                                     and abs(got["mom"][2]) < 1.0)
    _assert_within_bars(got, ref, BARS)


def test_nc_second_iteration_from_one_state(nc_runs):
    got, ref = nc_runs["carried"], nc_runs["jax"]["second"]
    assert not nc_runs["tilted"] or (abs(got["mom"][0]) > 1e-3
                                     and abs(got["mom"][2]) < 1.0)
    _assert_within_bars(got, ref, list(BARS) + ["delta"])


@pytest.mark.parametrize("fname", ["totaldos.out", "X_out.nml", "X_dos.out",
                                   "X_orbital_dos.out"])
def test_nc_scf_outputs_match_jax(nc_runs, fname):
    _assert_printed_close(nc_runs["jax"]["dir"] / fname,
                          nc_runs["torch"]["dir"] / fname)
