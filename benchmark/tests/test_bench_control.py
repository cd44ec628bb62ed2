"""The comparison that decides ``correct`` fails what it has to: the
control (the reference a precision lower, in the program's place) at the
test's size, and the faults a cell can have, planted under a run that skips
the look for a card.  The cells run on one card; the fault of an exchange
between cards left out is planted in a four-rank cell in
``test_bench_ranks.py``."""

import numpy as np
import pytest
import torch

from benchmark import checks, harness, jobs

from .test_bench_run import run_cell


@pytest.mark.parametrize("cell", ["bccfe30-scf-block", "bccfe30-jij-block",
                                  "bccfe30-scf-cheb"])
def test_control_fails(small, cell):
    c = harness.Cell(small, cell)
    state0 = jobs.seeded_state(c.config, 4000000007)
    ref = c.kind.reference(c, state0, "cpu", torch.complex128)
    ok, rows = checks.judge(harness.control_readings(c, state0, ref, "cpu"),
                            c.limits)
    assert not ok, rows


def _unchanged(monkeypatch):
    """An SCF step that returns its state unchanged."""
    from rslmtoasa_tpu_torch.models.scf import SelfConsistency

    monkeypatch.setattr(SelfConsistency, "run",
                        lambda self, nstep=None: self.state)


def _stale_potpar(monkeypatch):
    """The atomic-sphere step hands on the potential parameters it was
    given (its energy and moments as they should be)."""
    from rslmtoasa_tpu_torch.models import scf

    inner = scf.SelfConsistency.run_scf
    fields = ("c", "enu", "srdel", "qpar", "ppar", "vl")

    def run_scf(self):
        kept = [{k: np.copy(getattr(at.potential, k)) for k in fields}
                for at in self.sys.atoms]
        inner(self)
        for at, old in zip(self.sys.atoms, kept):
            for k, v in old.items():
                setattr(at.potential, k, v)
            at.potential.predls(self.sys.cluster.wav * scf.ANG2AU)

    monkeypatch.setattr(scf.SelfConsistency, "run_scf", run_scf)


def _altered_coefficient(monkeypatch):
    """One recursion coefficient altered where it is produced."""
    from rslmtoasa_tpu_torch.models import bulk

    inner = bulk.BulkSystem.run_block

    def run_block(self):
        a_b, b2_b = inner(self)
        a_b = a_b.copy()
        a_b[5, 0, 3, 3] += 1e-7
        return a_b, b2_b

    monkeypatch.setattr(bulk.BulkSystem, "run_block", run_block)


def _altered_jij(monkeypatch):
    """One Jij value altered where it is produced."""
    from rslmtoasa_tpu_torch.models.exchange import ExchangeCalculation

    inner = ExchangeCalculation._lkag

    def lkag(self, emesh):
        res = inner(self, emesh)
        res[2]["jij"] += 1e-4
        return res

    monkeypatch.setattr(ExchangeCalculation, "_lkag", lkag)


def _half_batch(monkeypatch):
    """Half of the pair chains left out of the recursion, their
    coefficients the mean over the rest."""
    from rslmtoasa_tpu_torch.models import exchange

    inner = exchange.block_lanczos_auto

    def half(hs, lsham, iz, cols, psi0, lld, **kw):
        r = psi0.shape[2] // 18
        keep = (r + 1) // 2
        a_b, b2_b = inner(hs, lsham, iz, cols, psi0[:, :, :18 * keep], lld,
                          **kw)
        fill = lambda x: np.concatenate(  # noqa: E731
            [x, np.repeat(x.mean(1, keepdims=True), r - keep, 1)], 1)
        return fill(a_b), fill(b2_b)

    monkeypatch.setattr(exchange, "block_lanczos_auto", half)


@pytest.mark.parametrize("cell,fault,caught_by", [
    ("bccfe30-scf-block", _unchanged, None),
    ("bccfe30-scf-block", _altered_coefficient, "coef"),
    ("bccfe30-scf-block", _stale_potpar, "potpar"),
    ("bccfe30-scf-cheb", _unchanged, None),
    ("bccfe30-jij-block", _altered_jij, "jij"),
    ("bccfe30-jij-block", _half_batch, None),
])
def test_fault_is_not_correct(small, monkeypatch, cell, fault, caught_by):
    fault(monkeypatch)
    rc, res = run_cell(small, cell)
    assert rc == 0 and res["correct"] is False
    if caught_by is not None:
        row = res["checks"][caught_by]
        assert not row["value"] <= row["limit"]
