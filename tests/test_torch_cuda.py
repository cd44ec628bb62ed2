"""The CUDA kernels (Haydock K1'-K3', block step K4) against their plain
versions, and the Green functions, the exchange pair recursion, the Kubo
moments and the orbital moment's trace against the same torch code on the
CPU, and the active-set wavefront through the kernels against its plain
version and the full-width route, on the card; the kernels on row-slab
tables, two ranks sharing the card on row slabs, one NCCL rank, and two
NCCL ranks on row slabs and chains where there are two cards.

Marked ``gpu``: without a CUDA card every test skips (the check is made
in the fixture, never at import).  On a machine with one, run
``python -m pytest tests/test_torch_cuda.py -q``; the kernels are built
from ``csrc/`` on first use.
"""

import numpy as np
import pytest
import torch

from rslmtoasa_tpu_torch.models.conductivity import (
    ConductivityCalculation,
    build_velocity_operators,
)
from rslmtoasa_tpu_torch.models import orbital
from rslmtoasa_tpu_torch.models.exchange import (
    ExchangeCalculation,
    pair_start_vectors,
)
from rslmtoasa_tpu_torch.models.presets import (
    IMPURITIES,
    build_synthetic_b2,
    build_synthetic_bcc,
    build_synthetic_exchange,
    build_synthetic_impurity,
    build_synthetic_surface,
    exchange_pairs,
)
from rslmtoasa_tpu_torch.ops import block_kernels as bk
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.ops import kubo, wavefront
from rslmtoasa_tpu_torch.ops.block_lanczos import (
    BlockOperator,
    block_lanczos,
    block_start_vectors,
    zsqr,
)
from rslmtoasa_tpu_torch.ops.chebyshev import (
    chebyshev_green,
    chebyshev_moments,
)
from rslmtoasa_tpu_torch.ops.lanczos import (
    HaydockOperator,
    lanczos_coefficients,
    scalar_start_vectors,
)
from rslmtoasa_tpu_torch.physics.greens import bgreen, get_terminf

pytestmark = pytest.mark.gpu
BAR = 1e-12


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def system(card):
    sys_ = build_synthetic_bcc(rc=16.0, ndim=4000, lld=6, device="cpu")
    ee = sys_.ham.ee
    return sys_, HaydockOperator(ee[:, :, :9, :9], sys_.ham.iz,
                                 sys_.ham.cols).to(card)


def _psi(kk, c, seed, device):
    rng = np.random.default_rng(seed)
    psi = np.zeros((kk + 1, 9, c), np.complex128)
    psi[:kk] = rng.standard_normal((kk, 9, c)) + 1j * rng.standard_normal(
        (kk, 9, c))
    return torch.from_numpy(psi).to(device)


@pytest.fixture(scope="module")
def b2_system(card):
    """The B2 preset (kk = 224, two types that mix within row tiles)."""
    sys_ = build_synthetic_b2(rc=8.0, nsp=1, device="cpu")
    return HaydockOperator(sys_.ham.ee[:, :, 9:, 9:], sys_.ham.iz,
                           sys_.ham.cols).to(card)


@pytest.mark.parametrize("c", [1, 9, 13, 40])
def test_spmv_dot_kernel_matches_plain(system, card, c):
    _, op = system
    psi = _psi(op.kk, c, 1, card)
    n = hk.spmv_dot.launches
    y, apart = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
    assert hk.spmv_dot.launches == n + 1
    y0, apart0 = hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi)
    torch.cuda.synchronize()
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    assert (apart - apart0).abs().max() <= BAR * apart0.abs().max()
    y1, apart1 = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
    assert torch.equal(y, y1) and torch.equal(apart, apart1)  # no atomics


@pytest.mark.parametrize("c", [9, 40])
def test_update_norm_kernel_matches_plain(system, card, c):
    _, op = system
    kk = op.kk
    psi = _psi(kk, c, 2, card)
    v = _psi(kk, c, 3, card)[:kk]
    pmn = _psi(kk, c, 4, card)[:kk].contiguous()
    a = torch.linspace(-1.0, 1.0, c, dtype=torch.float64, device=card)
    out0, nrm0 = hk.update_norm_ref(a, psi, v, pmn)
    n = hk.update_norm.launches
    out, nrm = hk.update_norm(a, psi, v, pmn)
    assert hk.update_norm.launches == n + 1
    assert out.data_ptr() == pmn.data_ptr()  # written in place
    torch.cuda.synchronize()
    assert (out - out0).abs().max() <= BAR * out0.abs().max()
    assert (nrm - nrm0).abs().max() <= BAR * nrm0.abs().max()


def test_recursion_kernels_match_plain(system, card):
    _, op = system
    lld = 6
    psi0 = scalar_start_vectors(op.kk, [0, 3, 7], card)
    n1, n3 = hk.spmv_dot.launches, hk.update_norm.launches
    a, b2 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld)
    assert hk.spmv_dot.launches - n1 == lld - 1
    assert hk.update_norm.launches - n3 == lld - 1
    a0, b20 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld,
                                   plain=True)
    assert (a - a0).abs().max() <= 1e-11
    assert (b2 - b20).abs().max() <= 1e-11


@pytest.mark.parametrize("c", [1, 9, 13, 33])
def test_spmv_dot_pipelined_kernel_matches_plain(system, card, c):
    """K2' vs its plain version (13, 33: chain counts that are no multiple
    of the chain tile); its y equals that of K1' bit for bit, and a rerun
    gives the same bits (no floating-point atomics)."""
    _, op = system
    psi = _psi(op.kk, c, 5, card)
    n = hk.spmv_dot_pipelined.launches
    y, a = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi)
    assert hk.spmv_dot_pipelined.launches == n + 1
    y0, a0 = hk.spmv_dot_pipelined_ref(op.hs, op.iz, op.cols, psi)
    torch.cuda.synchronize()
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    assert (a - a0).abs().max() <= BAR * a0.abs().max()
    y1, apart = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
    assert torch.equal(y, y1)
    assert (a - apart.sum(0)).abs().max() <= 1e-13 * a.abs().max()
    y2, a2 = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi)
    assert torch.equal(y, y2) and torch.equal(a, a2)


def test_recursion_roll_matches_plain(system, card):
    _, op = system
    lld = 6
    psi0 = scalar_start_vectors(op.kk, [0, 3, 7], card)
    n1, n2 = hk.spmv_dot.launches, hk.spmv_dot_pipelined.launches
    a, b2 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld,
                                 roll=True)
    assert hk.spmv_dot_pipelined.launches - n2 == lld - 1
    assert hk.spmv_dot.launches == n1
    a0, b20 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld,
                                   plain=True, roll=True)
    assert (a - a0).abs().max() <= 1e-11
    assert (b2 - b20).abs().max() <= 1e-11


@pytest.mark.parametrize("c", [9, 13])
def test_spmv_kernels_on_b2(b2_system, card, c):
    """Both SpMVs on two types mixed within row tiles: each matches its
    plain version, K2's y equals K1's bit for bit, and reruns give the
    same bits."""
    op = b2_system
    assert op.hs.shape[0] == 2
    psi = _psi(op.kk, c, 6, card)
    y, apart = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
    y2, a2 = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi)
    y0, apart0 = hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi)
    torch.cuda.synchronize()
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    assert (apart - apart0).abs().max() <= BAR * apart0.abs().max()
    assert (a2 - apart0.sum(0)).abs().max() <= BAR * a2.abs().max()
    assert torch.equal(y, y2)
    y1, apart1 = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
    y3, a3 = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi)
    assert torch.equal(y, y1) and torch.equal(apart, apart1)
    assert torch.equal(y2, y3) and torch.equal(a2, a3)


def test_pipelined_ticket_counter_is_left_zero(system, card):
    """K2's last block resets the shared ticket counter, so one zeroed
    counter per stream serves every launch."""
    _, op = system
    psi = _psi(op.kk, 9, 7, card)
    _, a = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi)
    ticket = hk._ticket(card)
    for _ in range(3):
        _, a1 = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi)
        assert hk._ticket(card) is ticket
        torch.cuda.synchronize()
        assert int(ticket.item()) == 0 and torch.equal(a, a1)


# ----------------------------------------------------------------------
# K4 block_step
@pytest.fixture(scope="module")
def block_system(card):
    """bcc with spin-orbit coupling and the HoH tables (d = 18)."""
    return build_synthetic_bcc(rc=16.0, ndim=4000, lld=6, nsp=2, hoh=True,
                               device="cpu")


def _blocks(kk, d, r, seed, device):
    """Random (kk+1, d, r d) start blocks with a zero row kk."""
    rng = np.random.default_rng(seed)
    psi = np.zeros((kk + 1, d, r * d), np.complex128)
    psi[:kk] = rng.standard_normal((kk, d, r * d)) \
        + 1j * rng.standard_normal((kk, d, r * d))
    return torch.from_numpy(psi).to(device)


def _block_operator(sys_, d, hoh, card):
    hb = sys_.ham
    sl = slice(0, d)  # d = 9: the up-spin sector
    return BlockOperator(hb.ee[..., sl, sl], hb.iz, hb.cols,
                         hb.lsham[..., sl, sl], hoh=hoh,
                         hso=hb.eeo[..., sl, sl] if hoh else None,
                         enim=hb.enim[..., sl, sl] if hoh else None).to(card)


def _k4_matches_plain(op, psi):
    """K4 (one launch, two with HoH) against its plain version: y, the Gram
    partials and their sum within 1e-12 of scale; a rerun bit-identical."""
    n = bk.block_step.launches
    y, g = op(psi, gram=True)
    assert bk.block_step.launches == n + (2 if op.hoh else 1)
    y0, g0 = op(psi, gram=True, plain=True)
    torch.cuda.synchronize()
    assert g.shape == g0.shape == (bk.nrowblk(op.kk, psi.shape[1]),
                                   psi.shape[2] // psi.shape[1],
                                   psi.shape[1], psi.shape[1])
    for got, want in ((y, y0), (g, g0), (g.sum(0), g0.sum(0))):
        assert (got - want).abs().max() <= BAR * want.abs().max()
    y1, g1 = op(psi, gram=True)
    assert torch.equal(y, y1) and torch.equal(g, g1)


@pytest.mark.parametrize("hoh", [False, True])
@pytest.mark.parametrize("d", [9, 18])
def test_block_step_kernel_matches_plain(block_system, card, d, hoh):
    op = _block_operator(block_system, d, hoh, card)
    _k4_matches_plain(op, _blocks(op.kk, d, 2, 8, card))


def test_block_step_kernel_on_b2(card):
    """Two types mixed within row tiles, two start blocks, d = 18."""
    sys_ = build_synthetic_b2(rc=8.0, nsp=2, device="cpu")
    hb = sys_.ham
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(card)
    assert op.hs.shape[0] == 2
    _k4_matches_plain(op, _blocks(op.kk, 18, 2, 9, card))


def test_block_step_kernel_reruns_bit_identical(block_system, card):
    """d = 18 with the onsite term and the Gram: five launches give the
    same bits, and the table stays whole in shared memory (one chunk)."""
    op = _block_operator(block_system, 18, False, card)
    psi = _blocks(op.kk, 18, 1, 14, card)
    assert bk.chunks(18, 1, 1, op.cols.shape[1], True, True) == 1
    y, g = op(psi, gram=True)
    for _ in range(4):
        y1, g1 = op(psi, gram=True)
        assert torch.equal(y, y1) and torch.equal(g, g1)


def test_block_step_chunks_two_types_at_d18(card):
    """Two types of width 18 do not fit shared memory together: the kernel
    walks the slot quads in chunks, and matches its plain version."""
    sys_ = build_synthetic_b2(rc=8.0, nsp=2, device="cpu")
    hb = sys_.ham
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(card)
    nslots = op.cols.shape[1]
    assert bk.chunks(18, 2, 2, nslots, True, True) > 1
    assert bk.chunks(9, 2, 2, nslots, True, True) == 1
    _k4_matches_plain(op, _blocks(op.kk, 18, 1, 15, card))


def test_block_step_kernel_pads_and_adds(block_system, card):
    """The HoH step's first launch: y with a zero row kk, no onsite, add or
    Gram; then add alone."""
    op = _block_operator(block_system, 18, False, card)
    psi = _blocks(op.kk, 18, 1, 10, card)
    y, g = bk.block_step(op.hs, op.iz, op.cols, psi, pad=True)
    y0, _ = bk.block_step_ref(op.hs, op.iz, op.cols, psi, pad=True)
    torch.cuda.synchronize()
    assert g is None and y.shape == (op.kk + 1, 18, 18)
    assert not y[op.kk].any()
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    add = psi[:op.kk]
    z, _ = bk.block_step(op.hs, op.iz, op.cols, psi, add=add)
    z0, _ = bk.block_step_ref(op.hs, op.iz, op.cols, psi, add=add)
    torch.cuda.synchronize()
    assert (z - z0).abs().max() <= BAR * z0.abs().max()


@pytest.mark.parametrize("hoh", [False, True])
def test_block_recursions_match_plain(block_system, card, hoh):
    """block_lanczos and chebyshev_moments through K4 against the plain
    versions on the card: 1e-11; one launch per H psi (two with HoH)."""
    op = _block_operator(block_system, 18, hoh, card)
    psi0 = block_start_vectors(op.kk, [0, 5], card)
    lld = 6
    per = 2 if hoh else 1
    n = bk.block_step.launches
    a, b2 = block_lanczos(op, psi0, lld)
    assert bk.block_step.launches - n == per * (lld - 1)
    a0, b20 = block_lanczos(op, psi0, lld, plain=True)
    assert (a - a0).abs().max() <= 1e-11 and (b2 - b20).abs().max() <= 1e-11
    n = bk.block_step.launches
    mu = chebyshev_moments(op, psi0, lld, 2.5 / 1.7, -0.25)
    assert bk.block_step.launches - n == per * (lld + 1)
    mu0 = chebyshev_moments(op, psi0, lld, 2.5 / 1.7, -0.25, plain=True)
    assert (mu - mu0).abs().max() <= 1e-11


# ----------------------------------------------------------------------
# K4 on the slab and on the impurity's combined table
@pytest.fixture(scope="module")
def embedded(card):
    """The slab (four types: the chunked route) and the impurity with one
    and three impurities (the local zone's route), with the HoH tables."""
    kw = dict(rc=20.0, nsp=2, hoh=True, lld=6, device="cpu")
    return {"surface": build_synthetic_surface(**kw),
            "impurity-1": build_synthetic_impurity(inclu=IMPURITIES[:1],
                                                   **kw),
            "impurity-3": build_synthetic_impurity(**kw)}


def _embedded_operator(sys_, d, hoh, card):
    blocks, blocks_o, iz_rows, iz_sp, nmax = sys_._spmv_tables()
    hb, sl = sys_.ham, slice(0, d)
    return BlockOperator(blocks[..., sl, sl], iz_rows, hb.cols,
                         hb.lsham[..., sl, sl], iz_onsite=iz_sp, hoh=hoh,
                         hso=blocks_o[..., sl, sl] if hoh else None,
                         enim=hb.enim[..., sl, sl] if hoh else None,
                         nmax=nmax).to(card)


@pytest.mark.parametrize("hoh", [False, True])
@pytest.mark.parametrize("d", [9, 18])
@pytest.mark.parametrize("name", ["surface", "impurity-1", "impurity-3"])
def test_block_step_kernel_on_embedded(embedded, card, name, d, hoh):
    """K4 against its plain version on the combined table (the local zone
    from global memory, the rest compacted) and on the slab, three start
    blocks; with HoH its first launch alone too."""
    op = _embedded_operator(embedded[name], d, hoh, card)
    zone = op.zone()
    assert (zone is None) == (name == "surface")
    psi = _blocks(op.kk, d, 3, 16, card)
    _k4_matches_plain(op, psi)
    y, _ = bk.block_step(op.hs, op.iz, op.cols, psi, pad=True, zone=zone)
    y0, _ = bk.block_step_ref(op.hs, op.iz, op.cols, psi, pad=True)
    torch.cuda.synchronize()
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    assert not hk._ticket(card, 2).any()  # the tile counters, left zero
    if zone is not None:  # the tiles past the zone: one type, one chunk
        assert bk.chunks(d, zone.types.numel(), zone.otypes.numel(),
                         op.cols.shape[1], True, True) == 1


def test_impurity_block_recursion_on_card_matches_cpu(embedded, card):
    """The three-impurity preset's block recursion through K4 against the
    same on the CPU: 1e-12."""
    sys_ = embedded["impurity-3"]
    want = sys_.run_block()
    sys_.device = card
    try:
        got = sys_.run_block()
    finally:
        sys_.device = torch.device("cpu")
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= BAR


# ----------------------------------------------------------------------
# the Green functions on the card
@pytest.fixture(scope="module")
def b2_coefficients(card):
    """(a_b, b_b, a_inf, b_inf, mu) of the B2 preset's two start blocks."""
    sys_ = build_synthetic_b2(rc=8.0, nsp=2, device="cpu")
    hb = sys_.ham
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham)
    psi0 = block_start_vectors(op.kk, [0, 1], torch.device("cpu"))
    a_b, b2_b = (t.numpy() for t in block_lanczos(op, psi0, 8))
    b_b = zsqr(b2_b)
    a_inf, b_inf = get_terminf(a_b, b_b)
    mu = chebyshev_moments(op, psi0, 8, 2.5 / 1.7, -0.25).numpy()
    return a_b, b_b, a_inf, b_inf, mu


@pytest.mark.parametrize("sym_term", [False, True])
def test_bgreen_on_card_matches_cpu(b2_coefficients, card, sym_term):
    a_b, b_b, a_inf, b_inf, _ = b2_coefficients
    ene = np.linspace(-1.0, 0.5, 301)
    got = bgreen(a_b, b_b, a_inf, b_inf, ene, card, sym_term=sym_term)
    want = bgreen(a_b, b_b, a_inf, b_inf, ene, "cpu", sym_term=sym_term)
    assert got.shape == want.shape == (2, 18, 18, 301)
    assert np.abs(got - want).max() <= BAR * np.abs(want).max()


def test_chebyshev_green_on_card_matches_cpu(b2_coefficients, card):
    mu = b2_coefficients[4]
    ene = np.linspace(-1.4, 0.9, 301)
    got = chebyshev_green(mu, ene, -1.5, 1.0, card)
    want = chebyshev_green(mu, ene, -1.5, 1.0, "cpu")
    assert got.shape == want.shape == (2, 18, 18, 301)
    assert np.abs(got - want).max() <= BAR * np.abs(want).max()


def test_bgreen_eta_on_card_matches_cpu(b2_coefficients, card):
    """The 64 Gauss-Legendre nodes at one energy, one ``eta`` each."""
    a_b, b_b, a_inf, b_inf, _ = b2_coefficients
    x = 0.5 * (np.polynomial.legendre.leggauss(64)[0] + 1.0)
    ene, eta = np.full(64, -0.07), 1j * (1.0 - x) / x
    got = bgreen(a_b, b_b, a_inf, b_inf, ene, card, eta=eta)
    want = bgreen(a_b, b_b, a_inf, b_inf, ene, "cpu", eta=eta)
    assert np.abs(got - want).max() <= BAR * np.abs(want).max()


# ----------------------------------------------------------------------
# the exchange pair recursion
@pytest.mark.parametrize("hoh", [False, True])
def test_block_step_kernel_on_pair_start_blocks(block_system, card, hoh):
    """K4 on the exchange run's start blocks (two sites per block, complex
    phases; the onsite pair's block one site) and on H applied to them."""
    pairs = exchange_pairs(block_system.cluster, 3) - 1
    op = _block_operator(block_system, 18, hoh, card)
    psi = pair_start_vectors(op.kk, pairs, card)
    assert psi.shape[2] == 18 * 13
    _k4_matches_plain(op, psi)
    _k4_matches_plain(op, bk.block_step(op.hs, op.iz, op.cols, psi,
                                        pad=True)[0])


@pytest.mark.parametrize("recur", ["block", "chebyshev"])
def test_pair_recursion_on_card_matches_cpu(card, recur, tmp_path):
    """The exchange run through K4 on the card against the same on the
    CPU: the chains within 1e-12, Jij/Dij/Aij within 1e-8 mRy."""
    out = []
    for device in (card, "cpu"):
        sys_ = build_synthetic_exchange(nshell=3, rc=16.0, ndim=4000, lld=6,
                                        nsp=2, device=device)
        sys_.cfg.control.recur = recur
        sys_.cfg.energy.channels_ldos = 300
        sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = -1.5, 1.0
        wd = tmp_path / str(device)
        wd.mkdir()
        n = bk.block_step.launches
        xc = ExchangeCalculation(sys_, sys_.cfg.lattice.ijpair, str(wd))
        res = xc.run()
        steps = 6 - 1 if recur == "block" else 6 + 1
        assert bk.block_step.launches - n == (steps if device == card else 0)
        out.append((xc, res))
    (got, rg), (want, rw) = out
    names = ("mu",) if recur == "chebyshev" else ("a_b", "b_b")
    for k in names:
        assert np.abs(getattr(got, k) - getattr(want, k)).max() <= BAR
    for g, w in zip(rg, rw):
        for k in ("jij", "dmi", "aij"):
            assert np.abs(np.asarray(g[k]) - np.asarray(w[k])).max() <= 1e-8


# ----------------------------------------------------------------------
# the Kubo moments
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("hoh", [False, True])
def test_block_step_kernel_kubo_forms(block_system, card, hoh, pad):
    """K4 in the Kubo forms: a velocity table alone (one launch), and with
    HoH ``v psi - vo (hs psi)`` (two), against their plain versions within
    1e-12 of scale; a rerun bit-identical."""
    hb = block_system.ham
    v, _, _, _ = build_velocity_operators(block_system, np.array(
        [0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    vop = kubo.VelocityOperator(v, hb.iz, hb.cols,
                                0.05 * np.roll(v, 1, axis=1) if hoh
                                else None).to(card)
    kk = hb.kk
    psi = _blocks(kk, 18, 2, 21, card)
    hpsi = _blocks(kk, 18, 2, 22, card) if hoh else None
    n = bk.block_step.launches
    y = vop(psi, hpsi=hpsi, pad=pad)
    assert bk.block_step.launches == n + (2 if hoh else 1)
    y0 = vop(psi, hpsi=hpsi, pad=pad, plain=True)
    torch.cuda.synchronize()
    assert y.shape == y0.shape == (kk + pad, 18, 36)
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    if pad:
        assert not y[kk].any()
    assert torch.equal(y, vop(psi, hpsi=hpsi, pad=pad))


@pytest.mark.parametrize("hoh", [False, True])
def test_kubo_moments_on_card_matches_cpu(card, hoh, tmp_path):
    """The conductivity moments of the B2 preset's two types side by side
    (the atoms given an overlap with HoH) through K4 on the card against
    the same on the CPU: mu and the integrand within 1e-12 of scale; K4
    launched ``kubo.launches`` times."""
    out = []
    for device in (card, "cpu"):
        sys_ = build_synthetic_b2(rc=12.0, nsp=2, hoh=hoh, device=device)
        sys_.cfg.control.cond_ll = 12
        sys_.cfg.energy.channels_ldos = 300
        if hoh:
            for at in sys_.atoms:
                at.potential.obar[:] = -0.05
            sys_.build_hamiltonian()
        calc = ConductivityCalculation(sys_, str(tmp_path))
        v_a, v_b, vo_a, vo_b = build_velocity_operators(
            sys_, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
        a, b = 1.9, -0.2
        n = bk.block_step.launches
        mu = calc.compute_moments(v_a, v_b, a, b, 12, vo_a=vo_a, vo_b=vo_b)
        assert bk.block_step.launches - n == (
            kubo.launches(12, 12, hoh) if device == card else 0)
        em = sys_.emesh
        integrand = calc.conductivity_tensor(mu, em, 1.5 / 1.7, -0.25, 12)
        out.append((mu.cpu(), integrand))
    (mu, ig), (mu0, ig0) = out
    assert mu.shape == (18, 18, 12, 12, 2)
    assert (mu - mu0).abs().max() <= BAR * mu0.abs().max()
    assert np.abs(ig - ig0).max() <= BAR * np.abs(ig0).max()


# ----------------------------------------------------------------------
# the orbital moment
@pytest.mark.parametrize("r", [1, 16])
def test_block_step_kernel_orbital_form(block_system, card, r):
    """K4 in the orbital form: R start blocks, the lsham onsite term, no
    Gram, a zero row kk appended by the caller; against its plain version
    within 1e-12 of scale, a rerun bit-identical, one launch."""
    hb = block_system.ham
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(card)
    psi = _blocks(hb.kk, 18, r, 31, card)
    n = bk.block_step.launches
    y, g = op(psi)
    assert bk.block_step.launches == n + 1 and g is None
    y0, _ = op(psi, plain=True)
    torch.cuda.synchronize()
    assert y.shape == y0.shape == (hb.kk, 18, 18 * r)
    assert (y - y0).abs().max() <= BAR * y0.abs().max()
    assert torch.equal(y, op(psi)[0])


def test_orbital_moment_on_card_matches_cpu(card, tmp_path):
    """The orbital trace over 40 sites of the bcc preset (nsp=2) in groups
    of 16 through K4 on the card against the same on the CPU: mu within
    1e-12 of scale, Lz(E) too; K4 launched ``orbital.launches`` times."""
    out = []
    for device in (card, "cpu"):
        sys_ = build_synthetic_bcc(rc=12.0, ndim=4000, lld=10, nsp=2,
                                   device=device)
        cl, hb = sys_.cluster, sys_.ham
        op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(device)
        xy = [torch.as_tensor(np.append(cl.cr[:, k] * cl.alat, 0.0),
                              device=device) for k in (0, 1)]
        sites = np.linspace(0, cl.kk - 1, 40).astype(int)
        n = bk.block_step.launches
        mu = orbital.orbital_moments(op, *xy, sites, 10, 1.5 / 1.7, -0.25,
                                     16)
        assert bk.block_step.launches - n == (
            orbital.launches(10, 40, 16) if device == card else 0)
        lz = orbital.OrbitalMoment(sys_, str(tmp_path)).run(n_sites=40,
                                                           group=16)
        out.append((mu.cpu(), lz))
    (mu, lz), (mu0, lz0) = out
    assert (mu - mu0).abs().max() <= BAR * mu0.abs().max()
    assert np.abs(lz - lz0).max() <= BAR * np.abs(lz0).max()


# ----------------------------------------------------------------------
# the active-set wavefront through the kernels
WF = dict(rc=45.0, ndim=100000, lld=8)  # kk = 2 636


@pytest.fixture(scope="module")
def wavefront_system(card):
    """The wavefront's CPU test fixture with the HoH tables (``nsp=2``,
    spin-orbit coupling), built on the CPU."""
    return build_synthetic_bcc(nsp=2, hoh=True, device="cpu", **WF)


def _packs(run):
    """``run()`` with K4's table cache emptied first; returns its result
    and the number of tables it packed."""
    hk._TABLES.clear()
    n = hk.packed_table.builds
    out = run()
    return out, hk.packed_table.builds - n


@pytest.mark.parametrize("roll", [False, True])
def test_scalar_wavefront_through_the_kernels(wavefront_system, card, roll):
    """K1' (K2' with ``roll``) and K3' on the plan's prefixes against the
    same wavefront's plain version and the full-width kernel route: 1e-11;
    one launch of each per step."""
    hb = wavefront_system.ham
    kk, lld = wavefront_system.cluster.kk, WF["lld"]
    hs = np.ascontiguousarray(hb.ee[:, :, :9, :9])
    psi0 = scalar_start_vectors(kk, [0, 3], card)
    p = wavefront.make_plan(hb.cols, kk, [0, 3], lld)
    assert len(p.stages) > 2 and p.stages[-1][0] == kk
    spmv = hk.spmv_dot_pipelined if roll else hk.spmv_dot
    n, m = spmv.launches, hk.update_norm.launches
    a, b2 = wavefront.lanczos_coefficients_wavefront(
        hs, hb.iz, hb.cols, psi0, lld, p, roll=roll)
    assert spmv.launches - n == hk.update_norm.launches - m == lld - 1
    a0, b20 = wavefront.lanczos_coefficients_wavefront(
        hs, hb.iz, hb.cols, psi0, lld, p, roll=roll, plain=True)
    op = HaydockOperator(hs, hb.iz, hb.cols).to(card)
    ad, b2d = (t.cpu().numpy() for t in op.coefficients(psi0, lld, roll=roll))
    for got, want in ((a, a0), (b2, b20), (a, ad), (b2, b2d)):
        assert np.abs(got - want).max() <= 1e-11


@pytest.mark.parametrize("case", ["block", "block-hoh", "chebyshev"])
def test_block_wavefront_through_k4(wavefront_system, card, case):
    """K4 on the plan's prefixes (d = 18, spin-orbit coupling; HoH on a
    two-hop plan) against the same wavefront's plain version and the
    full-width K4 route: 1e-11; K4 launched once per H application (twice
    with HoH) and each table packed once for all stages."""
    hb = wavefront_system.ham
    kk, lld = wavefront_system.cluster.kk, WF["lld"]
    hoh = case == "block-hoh"
    lld = 3 if hoh else lld
    kw = dict(hoh=True, hso=hb.eeo, enim=hb.enim) if hoh else {}
    tabs = hb.ee, hb.lsham, hb.iz, hb.cols
    psi0 = block_start_vectors(kk, [0], card)
    per = 2 if hoh else 1
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham, **kw).to(card)
    if case == "chebyshev":
        p = wavefront.make_plan_chebyshev(hb.cols, kk, [0], lld)
        ab = (2.5 / 1.7, -0.25)

        def run(plain=False):
            return (wavefront.chebyshev_moments_wavefront(
                *tabs, psi0, lld, *ab, p, plain=plain, **kw),)
        dense = (chebyshev_moments(op, psi0, lld, *ab).cpu().numpy(),)
        steps = lld + 1
    else:
        p = wavefront.make_plan(hb.cols, kk, [0], lld,
                                hops_per_step=2 if hoh else 1)

        def run(plain=False):
            return wavefront.block_lanczos_wavefront(
                *tabs, psi0, lld, p, plain=plain, **kw)
        dense = tuple(t.cpu().numpy() for t in block_lanczos(op, psi0, lld))
        steps = lld - 1
    assert p.work < 0.7 * p.dense_work and len(p.stages) > 1
    assert sum(s for _, s in p.stages) == steps
    n = bk.block_step.launches
    got, packs = _packs(run)
    assert bk.block_step.launches - n == per * steps
    assert packs == 1 + per  # hs (and -eeo with HoH), the onsite table
    want = run(plain=True)
    for g, w, d in zip(got, want, dense):
        assert np.abs(g - w).max() <= 1e-11
        assert np.abs(g - d).max() <= 1e-11


@pytest.mark.parametrize("hoh", [False, True])
def test_impurity_wavefront_through_k4(card, hoh, monkeypatch):
    """The three-impurity preset at ``rc=220`` (kk = 27 316), lld 12, with
    the threshold lowered: its block recursion runs the wavefront, the
    local zone's route reaching the last per-atom row of the permuted
    table (the permutation reorders the zone's rows), against the same
    with ``plain=True`` and the full-width K4 route: 1e-11."""
    sys_ = build_synthetic_impurity(rc=220.0, nsp=2, hoh=hoh, lld=12,
                                    device="cpu")
    sys_.device = card
    calls = []
    make = wavefront._block_operator

    def spy(*a, **k):
        calls.append(make(*a, **k))
        return calls[-1]

    monkeypatch.setattr(wavefront, "_block_operator", spy)
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "20000")
    n = bk.block_step.launches
    got, packs = _packs(sys_.run_block)
    assert bk.block_step.launches - n == (2 if hoh else 1) * 11
    (op,) = calls
    zone = op.zone()
    nmax = sys_.cluster.nmax
    assert op.nmax >= nmax and zone is not None and zone.nl >= op.nmax
    assert sorted(op.iz[:op.nmax].tolist())[:nmax] == list(range(nmax))
    assert packs <= 2 * (2 if hoh else 1) + 2  # both routes, once each
    sys_.plain = True
    want = sys_.run_block()
    sys_.plain = False
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "999999999")
    dense = sys_.run_block()
    assert len(calls) == 2
    for g, w, d in zip(got, want, dense):
        assert np.abs(g - w).max() <= 1e-11
        assert np.abs(g - d).max() <= 1e-11


# ----------------------------------------------------------------------
# row slabs and ranks on the card
def _slab_tables(sys_, rank, card):
    """Rank ``rank``'s slab of two of ``sys_``'s tables (its own rows,
    then its halo, then the zero sentinel)."""
    from types import SimpleNamespace

    from rslmtoasa_tpu_torch.ops import rowslab

    return rowslab.Slab(SimpleNamespace(rank=rank, world=2), sys_.ham.cols,
                        card)


@pytest.mark.parametrize("rank", [0, 1])
def test_kernels_on_slab_tables(block_system, card, rank):
    """K1', K3' and K4 (d = 18 and 9, both HoH launches) computing a slab's
    own rows while reading its halo rows (``nx`` > kk) against their plain
    versions: 1e-12 of scale."""
    from rslmtoasa_tpu_torch.ops import rowslab

    hb = block_system.ham
    slab = _slab_tables(block_system, rank, card)
    n, nx = slab.n_own, slab.nx
    assert 0 < n < nx
    hs9 = torch.as_tensor(np.ascontiguousarray(hb.ee[:, :, :9, :9]),
                          device=card)
    iz = slab.rows(hb.iz)
    x = _psi(nx, 9, 41, card)
    y, ap = hk.spmv_dot(hs9, iz, slab.cols, x)
    y0, ap0 = hk.spmv_dot_ref(hs9, iz, slab.cols, x)
    v = _psi(n, 9, 42, card)[:n].contiguous()
    pmn = _psi(n, 9, 43, card)[:n].contiguous()
    a = torch.linspace(-1.0, 1.0, 9, dtype=torch.float64, device=card)
    out0, nrm0 = hk.update_norm_ref(a, x, v, pmn)
    out, nrm = hk.update_norm(a, x, v, pmn.clone())
    torch.cuda.synchronize()
    assert y.shape == (n, 9, 9) and ap.shape == (hk.nrowblk(n), 9)
    for got, want in ((y, y0), (ap, ap0), (out, out0), (nrm, nrm0)):
        assert (got - want).abs().max() <= BAR * want.abs().max()
    for d in (18, 9):
        sl = slice(0, d)
        for hoh in (False, True):
            op = rowslab.slab_operator(
                slab, hb.ee[..., sl, sl], hb.lsham[..., sl, sl], hb.iz,
                hoh=hoh, hso=hb.eeo[..., sl, sl] if hoh else None,
                enim=hb.enim[..., sl, sl] if hoh else None)
            xb = _blocks(nx, d, 1, 44, card)
            hx = slab.extend(op.hs_apply(xb)[:n]) if hoh else None
            if hoh:
                hx[n:nx] = _blocks(nx - n - 1, d, 1, 45, card)[:nx - n]
            got = op(xb, gram=True, hpsi=hx)
            want = op(xb, gram=True, plain=True, hpsi=hx)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert (g - w).abs().max() <= BAR * w.abs().max()


def test_slab_recursions_two_ranks_share_the_card(block_system, card):
    """Two ranks on the one card over gloo: the block (HoH off and on),
    Chebyshev and scalar recursions on row slabs through the kernels
    against each rank's single-rank full-width kernel route: 1e-11."""
    from rslmtoasa_tpu_torch.parallel import launch

    hb = block_system.ham
    base = dict(hs=hb.ee, lsham=hb.lsham, iz=hb.iz, cols=hb.cols)
    res = launch.run(
        "rslmtoasa_tpu_torch.parallel.stages:slab_cases", 2, device="cuda",
        share_cards=True, cases={
            "bcc": dict(kinds=("block", "cheb", "scalar")),
            "hoh": dict(hoh=True, hso=hb.eeo, enim=hb.enim,
                        kinds=("block",))},
        starts=[0], lld=6, **base)
    for case, out in res.items():
        for kind in out["wall"]:
            got, want = out[kind], out[kind + "_1"]
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert np.abs(g - w).max() <= 1e-11, (case, kind)
    assert res["hoh"]["launches"]["block"]["block_step"] == 2 * 5
    assert res["bcc"]["launches"]["scalar"]["spmv_dot"] == 5


def test_one_nccl_rank(block_system, card):
    """World size 1 over NCCL: the chain-sharded block recursion (its
    CUDA-tensor all-gather) gives the single rank's bits."""
    from rslmtoasa_tpu_torch.parallel import launch

    hb = block_system.ham
    res = launch.run("rslmtoasa_tpu_torch.parallel.stages:chain_block", 1,
                     device="cuda", share_cards=False, hs=hb.ee,
                     lsham=hb.lsham, iz=hb.iz, cols=hb.cols, starts=[0, 5],
                     lld=6)
    assert res["backend"] == "nccl" and res["world"] == 1
    for g, w in zip(res["block"], res["block_1"]):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (one NCCL rank on each)")
    return card


def test_slabs_and_chains_over_nccl_one_card_a_rank(block_system,
                                                    two_cards):
    """Two NCCL ranks, one card each: the block (HoH off and on),
    Chebyshev and scalar recursions on row slabs (their halo exchanges
    batched point to point) against each rank's single-rank full width
    (1e-11), the all-gather and halo SpMVs against the whole table's
    (1e-12), and the chain-sharded block recursion against one rank
    (1e-12)."""
    from rslmtoasa_tpu_torch.parallel import launch

    hb = block_system.ham
    base = dict(hs=hb.ee, lsham=hb.lsham, iz=hb.iz, cols=hb.cols, lld=6)
    slabs, spmv, chains = launch.run(
        "rslmtoasa_tpu_torch.parallel.stages:many", 2, device="cuda",
        share_cards=False, calls=[
            ("slab_cases", dict(cases={
                "bcc": dict(kinds=("block", "cheb", "scalar")),
                "hoh": dict(hoh=True, hso=hb.eeo, enim=hb.enim,
                            kinds=("block",))}, starts=[0], **base)),
            ("spmv_suite", {}),
            ("chain_block", dict(starts=[0, 5], **base))])
    for case, out in slabs.items():
        for kind in out["wall"]:
            got, want = out[kind], out[kind + "_1"]
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert np.abs(g - w).max() <= 1e-11, (case, kind)
            assert out["exchanges"][kind] > 0
    for k in ("step", "halo"):
        assert np.abs(spmv[k] - spmv["dense"]).max() <= 1e-12, k
    assert chains["backend"] == "nccl" and chains["world"] == 2
    for g, w in zip(chains["block"], chains["block_1"]):
        assert np.abs(g - w).max() <= 1e-12
