"""The terminator fits' semantics, which the card's kernel
(``csrc/terminator.cu``) repeats bit for bit: the scalar ``bpopt`` against
the lockstep ``bpopt_batch`` lane by lane on chains that take every branch
of the fit, and ``get_terminf`` on NumPy arrays against CPU tensors, which
take the plain route and launch nothing.
"""

import numpy as np
import pytest
import torch

from rslmtoasa_tpu_torch.models.presets import build_synthetic_b2
from rslmtoasa_tpu_torch.ops import terminator
from rslmtoasa_tpu_torch.ops.block_lanczos import (
    BlockOperator,
    block_lanczos,
    block_start_vectors,
    zsqr,
)
from rslmtoasa_tpu_torch.physics.greens import get_terminf

LLDS = (8, 12, 20)
# the row of 300 chains drawn as edge_chains draws them, a thousand times
# wider than a band, whose centring runs out of its 300 steps
WIDE = {8: 32, 12: 1, 20: 46}


def edge_chains(lld: int, caps: bool = True):
    """(a, rb) (C, lld) of chains that take each branch of the fit: band
    chains; the zero chain (the Sturm count's p == 0 branch at every level,
    emami's first phase out of its 50 steps); a zero off-diagonal; a zero
    diagonal (p == 0 at the first count); a centred spectrum whose largest,
    then smallest, eigenvalue is 0 (the first, then the second phase out of
    steps).  With ``caps`` (lld in ``WIDE``), two chains whose centring
    runs out of its 300 steps (ifail): one holding a NaN, and a wide one.
    """
    rng = np.random.default_rng([lld, 0])
    n = lld - 1
    zero = np.zeros((1, lld))
    top = np.full((1, lld), -2.0)
    top[0, n - 1] = 0.0
    rows = [
        (rng.uniform(-0.3, 0.3, (3, lld)),
         rng.uniform(0.05, 0.15, (3, lld))),
        (zero, zero),
        (rng.uniform(-1.0, 1.0, (1, lld)), zero),
        (zero, np.full((1, lld), 0.2)),
        (top, zero),
        (-top, zero),
    ]
    if caps:
        nan = rng.uniform(-0.3, 0.3, (1, lld))
        nan[0, 3] = np.nan
        wide = np.random.default_rng([lld, 1])
        wa = wide.standard_normal((300, lld)) * 1e3
        wb = np.abs(wide.standard_normal((300, lld))) * 1e3
        k = WIDE[lld]
        rows += [(nan, rng.uniform(0.05, 0.15, (1, lld))),
                 (wa[k:k + 1], wb[k:k + 1])]
    return (np.concatenate([r[0] for r in rows]),
            np.concatenate([r[1] for r in rows]))


@pytest.mark.parametrize("lld", LLDS)
def test_scalar_bpopt_matches_batch_bit_for_bit(lld):
    a, rb = edge_chains(lld)
    with np.errstate(all="ignore"):
        ainf, binf, ifail = terminator.bpopt_batch(a, rb, lld - 1)
        one = [terminator.bpopt(a[k], rb[k], lld - 1)
               for k in range(a.shape[0])]
    assert np.array_equal(ainf, [x[0] for x in one], equal_nan=True)
    assert np.array_equal(binf, [x[1] for x in one], equal_nan=True)
    assert np.array_equal(ifail, [x[2] for x in one])
    assert np.isnan(ainf[-2]) and not np.isnan(ainf[-1])
    assert list(ifail[-2:]) == [1, 1] and not ifail[:-2].any()


@pytest.fixture(scope="module")
def b2_chains():
    """(a_b, b_b) of the B2 preset's two start blocks, lld 8."""
    sys_ = build_synthetic_b2(rc=8.0, nsp=2, device="cpu")
    hb = sys_.ham
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham)
    psi0 = block_start_vectors(op.kk, [0, 1], torch.device("cpu"))
    a_b, b2_b = (t.numpy() for t in block_lanczos(op, psi0, 8))
    return a_b, zsqr(b2_b)


@pytest.mark.parametrize("form", ["complex", "real"])
def test_get_terminf_on_cpu_tensors_matches_numpy(b2_chains, form):
    a_b, b_b = b2_chains
    want = get_terminf(a_b, b_b)
    pick = (lambda x: x) if form == "complex" else (lambda x: x.real.copy())
    n = terminator.bpopt_fit.launches
    got = get_terminf(*(torch.from_numpy(pick(x)) for x in (a_b, b_b)))
    assert terminator.bpopt_fit.launches == n
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (2, 18, 18)
        assert np.array_equal(g, w)
    assert np.all(want[1][:, [0, 9], [0, 9]] != 0.0)


@pytest.mark.parametrize("lld", LLDS)
def test_bpopt_fit_plain_matches_batch(lld):
    """The plain route of the kernel's wrapper: bpopt_batch, and with
    ldim the guards of get_terminf on (R, 18, 18) blocks."""
    a, rb = edge_chains(lld, caps=False)
    with np.errstate(all="ignore"):
        ainf, binf, ifail = terminator.bpopt_batch(a, rb, lld - 1)
    fit, fail = terminator.bpopt_fit(torch.from_numpy(a),
                                     torch.from_numpy(rb), lld - 1)
    assert np.array_equal(fit.numpy(), np.stack([ainf, binf]),
                          equal_nan=True)
    assert np.array_equal(fail.numpy(), ifail)
    reps = -(-324 // a.shape[0])
    blocks = [np.tile(x, (reps, 1))[:324] for x in (a, rb)]
    fit, _ = terminator.bpopt_fit(*map(torch.from_numpy, blocks), lld - 1,
                                  ldim=18)
    with np.errstate(all="ignore"):
        ainf, binf, _ = terminator.bpopt_batch(*blocks, lld - 1)
    want = terminator.terminf_guards(ainf.reshape(1, 18, 18),
                                     binf.reshape(1, 18, 18))
    assert np.array_equal(fit.numpy().reshape(2, 1, 18, 18), np.stack(want))
    assert not np.isnan(fit.numpy()).any()


def test_bpopt_fit_refuses_other_devices():
    a = torch.zeros((4, 8), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError):
        terminator.bpopt_fit(a, a, 7)


@pytest.mark.parametrize("what", ["sturm_counts", "sturm_steps"])
def test_measurement_entries_refuse_cpu_tensors(what):
    """The measurement entries read the card's own kernel: on host tensors
    they raise instead of counting or timing something else."""
    z = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        if what == "sturm_counts":
            terminator.sturm_counts(z, z, 7)
        else:
            terminator.sturm_steps(z[0], z[0], 0.0, 1)
