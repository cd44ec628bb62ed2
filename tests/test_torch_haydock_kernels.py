"""The Haydock kernels' plain versions and the port's recursion against the
JAX package's Pallas kernels (interpret mode) and complex128 recursion.

The Pallas kernels work on the realified flat-stencil layout in df64
pairs; the inputs here are complex128 on the ELL layout, mapped to the
flat layout through ``fs.planes``/``fs.cols`` as in
``tests/test_pallas_conv.py``.  Pallas df64 lands about 1e-13 from
complex128, so the bar is that test's own: 1e-12 of the output's scale.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rslmtoasa_tpu.models.presets import build_synthetic_bcc
from rslmtoasa_tpu.ops import lanczos as jl
from rslmtoasa_tpu.ops import pallas_conv as pc
from rslmtoasa_tpu.ops.stencil_conv import build_conv_stencil
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.ops.lanczos import (
    HaydockOperator,
    lanczos_coefficients,
    scalar_start_vectors,
)

CPU = torch.device("cpu")
BAR = 1e-12


@pytest.fixture(scope="module")
def small_system():
    js = build_synthetic_bcc(rc=16.0, ndim=4000, lld=6)
    st = build_conv_stencil(js.cluster)
    fs = pc.build_flat_stencil(st)
    hs_split = np.asarray(jl.split_complex(js.ham.ee[0, :, :9, :9]))
    ts = system_from_numpy(*system_to_numpy(js), CPU)
    op = HaydockOperator(ts.ham.ee[:, :, :9, :9], ts.ham.iz, ts.ham.cols)
    return js, st, fs, hs_split, op


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _to_flat(x, fs):
    """(kk, 9, C) complex -> df64 pair of (C, nxp, 18, roww) float32."""
    flat = np.zeros((x.shape[2], fs.nxp, 18, fs.roww))
    flat[:, fs.planes, :9, fs.cols] = np.moveaxis(x.real, 2, 1)
    flat[:, fs.planes, 9:, fs.cols] = np.moveaxis(x.imag, 2, 1)
    hi = flat.astype(np.float32)
    lo = (flat - hi).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _from_flat(hi, lo, fs):
    """df64 pair of (C, nxp, 18, roww) -> (kk, 9, C) complex128."""
    v = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    g = v[:, fs.planes, :, fs.cols]  # (kk, C, 18)
    return np.moveaxis(g[..., :9] + 1j * g[..., 9:], 1, 2)


def _block_sums(contrib):
    kk = contrib.shape[0]
    out = np.zeros((hk.nrowblk(kk), contrib.shape[1]))
    for blk in range(out.shape[0]):
        out[blk] = contrib[blk * hk.ROWS_PER_BLOCK:
                           (blk + 1) * hk.ROWS_PER_BLOCK].sum(0)
    return out


def test_spmv_dot_ref_matches_pallas(small_system):
    js, st, fs, hs_split, op = small_system
    kk, c = op.kk, 4
    rng = np.random.default_rng(3)
    psi = np.zeros((kk + 1, 9, c), np.complex128)
    psi[:kk] = _complex(rng, (kk, 9, c))
    # Entries below one on a 2^-6 grid.  The Pallas kernel's df64 chunk
    # grid is built for entries below one (the recursion's unit chains);
    # with full-mantissa entries its float32 sums of bf16 chunk products
    # round at about 1.6e-12 of max|y| (seen with float32-exact random
    # entries), which would measure the df64 engine and not the port.
    # On this grid those sums are exact.
    psi = np.round(psi / (1.25 * np.abs(psi).max()) * 64) / 64
    wt, hsc, dxs, colshifts = pc.pack_flat_kernel(hs_split, st)
    vh, vl, aph, apl = pc.conv_spmv_df64_pallas(
        wt, jnp.asarray(fs.mask), _to_flat(psi[:kk], fs), hsc, nchunks=7,
        d=18, dxs=dxs, colshifts=colshifts, interpret=True)
    y_ref = _from_flat(vh, vl, fs)
    a_ref = (np.asarray(aph, np.float64)
             + np.asarray(apl, np.float64)).sum(axis=(1, 2, 3))

    y, apart = hk.spmv_dot(op.hs, op.iz, op.cols, torch.from_numpy(psi))
    y, apart = y.numpy(), apart.numpy()
    assert y.shape == (kk, 9, c) and apart.shape == (hk.nrowblk(kk), c)
    assert np.abs(y - y_ref).max() <= BAR * np.abs(y_ref).max()
    a = apart.sum(0)
    assert np.abs(a - a_ref).max() <= BAR * max(1.0, np.abs(a_ref).max())
    # the partials are Re<psi|y> summed over blocks of ROWS_PER_BLOCK rows
    contrib = (psi[:kk].conj() * y).real.sum(1)
    assert np.abs(apart - _block_sums(contrib)).max() <= 1e-13 * max(
        1.0, np.abs(apart).max())


def test_update_norm_ref_matches_pallas(small_system):
    js, st, fs, hs_split, op = small_system
    kk, c = op.kk, 4
    rng = np.random.default_rng(5)
    a = rng.standard_normal(c)
    psi = np.zeros((kk + 1, 9, c), np.complex128)
    psi[:kk] = _complex(rng, (kk, 9, c))
    v = _complex(rng, (kk, 9, c))
    pmn = _complex(rng, (kk, 9, c))
    a_hi = a.astype(np.float32)
    a_ds = (jnp.asarray(a_hi), jnp.asarray((a - a_hi).astype(np.float32)))
    oh, ol, nh, nl = pc.lanczos_update_pallas(
        a_ds, _to_flat(psi[:kk], fs), _to_flat(v, fs), _to_flat(pmn, fs),
        d=18, interpret=True)
    out_ref = _from_flat(oh, ol, fs)
    nrm_ref = (np.asarray(nh, np.float64)
               + np.asarray(nl, np.float64)).sum(axis=(1, 2, 3))

    # the generalised plain update at (alpha, beta, gamma) = (1, -a, 1)
    ones = torch.ones(c, dtype=torch.float64)
    out = torch.from_numpy(pmn.copy())
    b2_out = torch.empty(c, dtype=torch.float64)
    nrm = hk.update_norm_ref((ones, torch.from_numpy(-a), ones),
                             torch.from_numpy(v), torch.from_numpy(psi), out,
                             b2_out)
    out, nrm, b2_out = out.numpy(), nrm.numpy(), b2_out.numpy()
    assert out.shape == (kk, 9, c) and nrm.shape == (hk.nrowblk(kk), c)
    assert np.abs(out - out_ref).max() <= BAR * np.abs(out_ref).max()
    assert np.abs(nrm.sum(0) - nrm_ref).max() <= BAR * np.abs(nrm_ref).max()
    assert np.abs(b2_out - nrm_ref).max() <= BAR * np.abs(nrm_ref).max()
    contrib = (np.abs(out) ** 2).sum(1)
    assert np.abs(nrm - _block_sums(contrib)).max() <= 1e-13 * np.abs(
        nrm).max()


def _start(js, atoms):
    return jl.scalar_start_vectors(js.cluster.kk, atoms)


def test_lanczos_matches_complex128(small_system):
    """The port's recursion (plain versions on the CPU) vs the JAX
    complex128 recursion: same algorithm in another summation order."""
    js, st, fs, hs_split, op = small_system
    lld = 6
    psi0 = _start(js, [0, 3])
    blk = js.ham.ee[:, :, :9, :9]
    a_ref, b_ref = jl.lanczos_coefficients(
        jnp.asarray(blk), jnp.asarray(js.ham.iz), jnp.asarray(js.ham.cols),
        jnp.asarray(psi0), lld)
    p0 = scalar_start_vectors(op.kk, [0, 3], CPU)
    assert np.array_equal(p0.numpy(), psi0)
    a, b2 = lanczos_coefficients(op.hs, op.iz, op.cols, p0, lld)
    assert a.shape == (lld, 18) and a.dtype == torch.float64
    assert np.abs(a.numpy() - np.asarray(a_ref)).max() <= 1e-12
    assert np.abs(b2.numpy() - np.asarray(b_ref)).max() <= 1e-12
    assert b2[0].eq(1.0).all() and a[-1].eq(0.0).all()


def test_lanczos_matches_flat_df64(small_system):
    """The port's recursion vs the recursion through both Pallas kernels
    (the accelerator path of ``BulkSystem.run_lanczos``)."""
    js, st, fs, hs_split, op = small_system
    lld = 6
    wt, hsc, dxs, colshifts = pc.pack_flat_kernel(hs_split, st)
    p0 = pc.flat_start_vectors(fs, [0, 3], 18, orbitals=range(9))
    a_ref, b_ref = pc.lanczos_coefficients_flat_df64(
        wt, hsc, fs.mask, p0, lld, dxs=dxs, colshifts=colshifts,
        interpret=True, roll=False)
    a, b2 = op.coefficients(scalar_start_vectors(op.kk, [0, 3], CPU), lld)
    assert np.abs(a.numpy() - a_ref).max() <= 1e-11
    assert np.abs(b2.numpy() - b_ref).max() <= 1e-11


def test_cpu_dispatch_runs_plain_versions(small_system):
    """A CPU tensor goes to the plain version: no launch is counted, and
    the result equals the plain version's bit for bit."""
    js, st, fs, hs_split, op = small_system
    rng = np.random.default_rng(7)
    psi = torch.zeros((op.kk + 1, 9, 3), dtype=torch.complex128)
    psi[:op.kk] = torch.from_numpy(_complex(rng, (op.kk, 9, 3)))
    n1, n3 = hk.spmv_dot.launches, hk.update_norm.launches
    y, apart = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
    y0, apart0 = hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi)
    assert torch.equal(y, y0) and torch.equal(apart, apart0)
    r = apart.sum(0)
    b2 = (psi.abs() ** 2).sum((0, 1))
    outs = []
    for fn in (hk.update_norm, hk.update_norm_ref):
        pmn = psi.clone()
        a_out, b2_out = torch.empty(3, dtype=torch.float64), torch.empty(
            3, dtype=torch.float64)
        part = fn((r, b2, torch.ones(3, dtype=torch.float64)), y, psi, pmn,
                  b2_out, a_out)
        outs.append((pmn, part, a_out, b2_out))
    assert all(torch.equal(g, w) for g, w in zip(*outs))
    assert (hk.spmv_dot.launches, hk.update_norm.launches) == (n1, n3)


def test_other_devices_raise(small_system):
    """Neither CPU nor CUDA: no plain fallback, the wrapper raises."""
    js, st, fs, hs_split, op = small_system
    meta = torch.empty((op.kk + 1, 9, 2), dtype=torch.complex128,
                       device="meta")
    with pytest.raises(ValueError, match="no Haydock kernel"):
        hk.spmv_dot(op.hs, op.iz, op.cols, meta)
    with pytest.raises(ValueError, match="no Haydock kernel"):
        s = (torch.empty(2, device="meta"),) * 3
        hk.update_norm(s, meta[:-1], meta, meta.clone(), s[0])


def test_block_spmv_multi_type_matches_jax():
    """The plain SpMV's per-type branch (a two-type B2 cluster)."""
    from rslmtoasa_tpu.models.presets import build_synthetic_b2

    js = build_synthetic_b2(rc=9.0, nsp=1)
    hb = js.ham
    assert hb.ee.shape[0] == 2
    rng = np.random.default_rng(11)
    kk = hb.cols.shape[0]
    psi = np.zeros((kk + 1, 9, 5), np.complex128)
    psi[:kk] = _complex(rng, (kk, 9, 5))
    blk = hb.ee[:, :, 9:, 9:]
    y_ref = np.asarray(jl.block_spmv(jnp.asarray(blk), jnp.asarray(hb.iz),
                                     jnp.asarray(hb.cols), jnp.asarray(psi)))
    op = HaydockOperator(blk, hb.iz, hb.cols)
    y = op(torch.from_numpy(psi)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-13 * np.abs(y_ref).max()


def test_spmv_dot_pipelined_ref_matches_pallas_roll(small_system):
    """The plain version of K2' vs the rolling-DMA Pallas kernel, whose
    dot partials leave the kernel summed over the planes."""
    js, st, fs, hs_split, op = small_system
    kk, c = op.kk, 4
    rng = np.random.default_rng(13)
    psi = np.zeros((kk + 1, 9, c), np.complex128)
    psi[:kk] = _complex(rng, (kk, 9, c))
    # the 2^-6 grid below one, as in test_spmv_dot_ref_matches_pallas
    psi = np.round(psi / (1.25 * np.abs(psi).max()) * 64) / 64
    wt, hsc, dxs, colshifts = pc.pack_flat_kernel(hs_split, st)
    vh, vl, aph, apl = pc.conv_spmv_df64_pallas_roll(
        wt, jnp.asarray(fs.mask), _to_flat(psi[:kk], fs), hsc, nchunks=7,
        d=18, dxs=dxs, colshifts=colshifts, interpret=True)
    y_ref = _from_flat(vh, vl, fs)
    a_ref = (np.asarray(aph, np.float64)
             + np.asarray(apl, np.float64)).sum(axis=(1, 2))

    y, a = hk.spmv_dot_pipelined(op.hs, op.iz, op.cols,
                                 torch.from_numpy(psi))
    y, a = y.numpy(), a.numpy()
    assert y.shape == (kk, 9, c) and a.shape == (c,)
    assert np.abs(y - y_ref).max() <= BAR * np.abs(y_ref).max()
    assert np.abs(a - a_ref).max() <= BAR * max(1.0, np.abs(a_ref).max())
    # the same y as the plain K1', and a the sum of its partials
    y1, apart = hk.spmv_dot_ref(op.hs, op.iz, op.cols, torch.from_numpy(psi))
    assert np.array_equal(y, y1.numpy())
    assert np.abs(a - apart.sum(0).numpy()).max() <= 1e-13 * max(
        1.0, np.abs(a).max())


def _roll_run(op, roll):
    return op.coefficients(scalar_start_vectors(op.kk, [0, 3], CPU), 6,
                           roll=roll)


def test_lanczos_roll_matches_flat_df64_roll(small_system):
    """The port's K2' recursion vs the JAX recursion through the
    rolling-DMA Pallas kernel (``roll=True``, interpret mode)."""
    js, st, fs, hs_split, op = small_system
    wt, hsc, dxs, colshifts = pc.pack_flat_kernel(hs_split, st)
    p0 = pc.flat_start_vectors(fs, [0, 3], 18, orbitals=range(9))
    a_ref, b_ref = pc.lanczos_coefficients_flat_df64(
        wt, hsc, fs.mask, p0, 6, dxs=dxs, colshifts=colshifts,
        interpret=True, roll=True)
    a, b2 = _roll_run(op, True)
    assert np.abs(a.numpy() - a_ref).max() <= 1e-11
    assert np.abs(b2.numpy() - b_ref).max() <= 1e-11


def test_lanczos_roll_matches_complex128_and_k1(small_system):
    """``roll=True`` vs the JAX complex128 recursion (1e-12) and vs the
    port's own K1' engine (1e-13: only the dot's summation order
    differs)."""
    js, st, fs, hs_split, op = small_system
    blk = js.ham.ee[:, :, :9, :9]
    a_ref, b_ref = jl.lanczos_coefficients(
        jnp.asarray(blk), jnp.asarray(js.ham.iz), jnp.asarray(js.ham.cols),
        jnp.asarray(_start(js, [0, 3])), 6)
    a, b2 = _roll_run(op, True)
    assert np.abs(a.numpy() - np.asarray(a_ref)).max() <= 1e-12
    assert np.abs(b2.numpy() - np.asarray(b_ref)).max() <= 1e-12
    a1, b21 = _roll_run(op, False)
    assert (a - a1).abs().max() <= 1e-13
    assert (b2 - b21).abs().max() <= 1e-13


@pytest.mark.parametrize("env, roll", [("1", True), (None, False)])
def test_rslmto_roll_selects_the_engine(small_system, monkeypatch, env,
                                        roll):
    """``roll=None`` reads RSLMTO_ROLL: with it set a CPU run goes through
    the plain K2' and never the plain K1', and the other way round."""
    js, st, fs, hs_split, op = small_system
    if env is None:
        monkeypatch.delenv("RSLMTO_ROLL", raising=False)
    else:
        monkeypatch.setenv("RSLMTO_ROLL", env)
    calls = {"k1": 0, "k2": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(hk, "spmv_dot_ref", spy("k1", hk.spmv_dot_ref))
    monkeypatch.setattr(hk, "spmv_dot_pipelined_ref",
                        spy("k2", hk.spmv_dot_pipelined_ref))
    n1, n2 = hk.spmv_dot.launches, hk.spmv_dot_pipelined.launches
    lanczos_coefficients(op.hs, op.iz, op.cols,
                         scalar_start_vectors(op.kk, [0], CPU), 4)
    assert calls == ({"k1": 0, "k2": 3} if roll else {"k1": 3, "k2": 0})
    # CPU tensors reach the plain versions: no launch is counted
    assert (hk.spmv_dot.launches, hk.spmv_dot_pipelined.launches) == (n1, n2)


def test_pipelined_on_other_devices_raises(small_system):
    js, st, fs, hs_split, op = small_system
    meta = torch.empty((op.kk + 1, 9, 2), dtype=torch.complex128,
                       device="meta")
    with pytest.raises(ValueError, match="no Haydock kernel"):
        hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, meta)


def _jax_preset(name):
    from rslmtoasa_tpu.models.presets import build_synthetic_b2

    if name == "b2":
        js = build_synthetic_b2(rc=8.0, nsp=1)
        return js.ham.ee[:, :, 9:, 9:], js
    if name == "bcc8":
        js = build_synthetic_bcc(rc=8.0, ndim=2000, lld=8, nsp=1)
    else:
        js = build_synthetic_bcc(rc=16.0, ndim=4000, lld=6)
    return js.ham.ee[:, :, :9, :9], js


@pytest.mark.parametrize("preset, kk_want", [("bcc8", 180), ("b2", 224),
                                             ("bcc16", 536)])
def test_packed_table_matches_jax_block_spmv(preset, kk_want):
    """The type table realified into the SpMV kernels' m16n8k8 B
    fragments, multiplied as the kernels' fragments combine it, against
    the JAX package's complex128 ``block_spmv``.
    bcc rc=8 (kk = 180) and rc=16 (kk = 536) are no multiple of the
    32-row tile; B2 has two types that mix within row tiles."""
    blk, js = _jax_preset(preset)
    hb = js.ham
    kk = hb.cols.shape[0]
    assert kk == kk_want
    if preset == "b2":
        iz = np.asarray(hb.iz)
        assert any(len(set(iz[i:i + hk.ROWS_PER_BLOCK])) == 2
                   for i in range(0, kk, hk.ROWS_PER_BLOCK))
    rng = np.random.default_rng(17)
    c = 6
    psi = np.zeros((kk + 1, 9, c), np.complex128)
    psi[:kk] = _complex(rng, (kk, 9, c))
    y_ref = np.asarray(jl.block_spmv(jnp.asarray(blk), jnp.asarray(hb.iz),
                                     jnp.asarray(hb.cols), jnp.asarray(psi)))
    op = HaydockOperator(blk, hb.iz, hb.cols)
    table = hk.packed_table(op.hs)
    ntype, nslots = op.hs.shape[:2]
    assert table.shape == (ntype, hk.nquads(nslots), hk.NTILE, 32, 2)
    assert table.dtype == torch.float64 and table.is_contiguous()
    y = hk.spmv_packed_ref(table, op.iz, op.cols,
                           torch.from_numpy(psi)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-13 * np.abs(y_ref).max()


def test_pack_table_realifies_and_pads():
    """Spot entries of the packed table: b0/b1 weigh the real/imaginary
    part of input q into real output n as [[Hr, -Hi], [Hi, Hr]] does, and
    the padding (input 135, outputs 18..23) is zero."""
    rng = np.random.default_rng(19)
    hs = torch.from_numpy(_complex(rng, (2, 15, 9, 9)))
    tab = hk.pack_table(hs)
    for ty, j, nt, lane in [(0, 0, 0, 0), (1, 5, 1, 13), (0, 33, 0, 2),
                            (1, 20, 2, 1), (0, 7, 2, 6)]:
        g, t = divmod(lane, 4)
        q, n = 4 * j + t, 8 * nt + g
        a, ro = divmod(n, 2)
        if q >= 135 or a >= 9:
            assert tab[ty, j, nt, lane].abs().max() == 0
            continue
        h = hs[ty, q // 9, a, q % 9]
        want = (h.real, -h.imag) if ro == 0 else (h.imag, h.real)
        assert tab[ty, j, nt, lane].tolist() == [float(w) for w in want]
    assert tab[:, 33, :, 3::4].abs().max() == 0  # q = 135
    assert tab[:, :, 2, 8:].abs().max() == 0  # outputs 18..23 (g >= 2)


def test_packed_table_is_cached(small_system):
    """The table is packed once per operator and packed again when hs
    changes in place."""
    js, st, fs, hs_split, op = small_system
    hs = op.hs.clone()
    table = hk.packed_table(hs)
    assert hk.packed_table(hs) is table
    hs.mul_(2.0)
    table2 = hk.packed_table(hs)
    assert table2 is not table and torch.equal(table2, 2.0 * table)


# ----------------------------------------------------------------------
# K3' with its normalisation deferred
DEFERRED_LLD, DEFERRED_STARTS, DEFERRED_C = 8, [0, 3], 13


@functools.lru_cache(maxsize=None)
def _deferred_reference(preset):
    """The preset's tables, the first 13 start chains of atoms 0 and 3,
    and the JAX package's complex128 coefficients of those chains (each
    chain recurs on its own, so the first c columns of it are the
    reference of c chains)."""
    blk, js = _jax_preset(preset)
    hb = js.ham
    kk = hb.cols.shape[0]
    psi0 = np.ascontiguousarray(
        jl.scalar_start_vectors(kk, DEFERRED_STARTS)[..., :DEFERRED_C])
    a_ref, b_ref = (np.asarray(x) for x in jl.lanczos_coefficients(
        jnp.asarray(blk), jnp.asarray(hb.iz), jnp.asarray(hb.cols),
        jnp.asarray(psi0), DEFERRED_LLD))
    return blk, hb, psi0, a_ref, b_ref


@pytest.mark.parametrize("preset", ["bcc8", "b2"])
@pytest.mark.parametrize("c", [1, 9, 13])
def test_deferred_recursion_matches_jax(preset, c):
    """The recursion with its normalisation deferred (the plain versions on
    the CPU) against the JAX package's complex128 ``lanczos_coefficients``
    (1e-12, that test's bar), on one stage and on two wavefront stages
    (the hop-ordered tables, the first stage the prefix the plan gives
    its first steps, the second all rows)."""
    from rslmtoasa_tpu_torch.ops import wavefront as pwf

    blk, hb, psi0, a_ref, b_ref = _deferred_reference(preset)
    kk, lld = hb.cols.shape[0], DEFERRED_LLD
    psi0 = torch.from_numpy(np.ascontiguousarray(psi0[..., :c]))
    a_ref, b_ref = a_ref[:, :c], b_ref[:, :c]
    a, b2 = HaydockOperator(blk, hb.iz, hb.cols).coefficients(psi0, lld)
    assert a.shape == (lld, c) and b2[0].eq(1.0).all() and a[-1].eq(0).all()
    assert np.abs(a.numpy() - a_ref).max() <= 1e-12
    assert np.abs(b2.numpy() - b_ref).max() <= 1e-12
    plan = pwf.make_plan(hb.cols, kk, DEFERRED_STARTS, lld, granularity=32)
    n0, s0 = plan.stages[0]
    assert n0 < kk and 0 < s0 < lld - 1
    iz_w, cols_w, _ = plan.permute_tables(hb.iz, hb.cols)
    a2, b22 = HaydockOperator(blk, iz_w, cols_w).coefficients(
        pwf.permuted_start(psi0, plan), lld,
        stages=((n0, s0), (kk, lld - 1 - s0)))
    assert np.abs(a2.numpy() - a_ref).max() <= 1e-12
    assert np.abs(b22.numpy() - b_ref).max() <= 1e-12


def test_update_norm_ref_general_coefficients():
    """The plain update at general (alpha, beta, gamma), and the deferred
    step's coefficients, against NumPy: written over the first kk rows of
    pmn (its last row untouched), the row-block partials of |out|^2 and
    their sum."""
    rng = np.random.default_rng(23)
    kk, c = 70, 5  # three row blocks, the last one partial
    v = _complex(rng, (kk, 9, c))
    psi = _complex(rng, (kk + 1, 9, c))
    pmn = _complex(rng, (kk + 1, 9, c))
    r, b2, b2p = rng.standard_normal(c), rng.random(c) + 0.5, rng.random(
        c) + 0.5
    al, be, ga = rng.standard_normal((3, c))
    sb = np.sqrt(b2)
    cases = {"general": ((al, be, ga), (al, be, ga), False),
             "deferred": ((r, b2, b2p), (1 / sb, -(r / b2) / sb,
                                         -sb / np.sqrt(b2p)), True)}
    for name, (s, (x, y, z), deferred) in cases.items():
        want = x * v + y * psi[:kk] + z * pmn[:kk]
        out = torch.from_numpy(pmn.copy())
        b2_out = torch.empty(c, dtype=torch.float64)
        a_out = torch.empty(c, dtype=torch.float64) if deferred else None
        part = hk.update_norm_ref(tuple(torch.from_numpy(t) for t in s),
                                  torch.from_numpy(v), torch.from_numpy(psi),
                                  out, b2_out, a_out)
        out = out.numpy()
        assert np.abs(out[:kk] - want).max() <= 1e-14 * np.abs(want).max()
        assert np.array_equal(out[kk], pmn[kk]), name
        contrib = (np.abs(want) ** 2).sum(1)
        assert part.shape == (3, c)
        assert np.abs(part.numpy() - _block_sums(contrib)).max() <= 1e-13 * (
            np.abs(part.numpy()).max())
        norm = contrib.sum(0)
        assert np.abs(b2_out.numpy() - norm).max() <= 1e-13 * norm.max()
        if deferred:
            assert np.abs(a_out.numpy() - r / b2).max() <= 1e-15 * np.abs(
                r / b2).max()


@pytest.mark.parametrize("nrb", [1, 2, 7, 16, 30, 844])
def test_fold_norm_adds_in_the_kernels_order(nrb):
    """``fold_norm`` gives the bits of K3''s finish: runs of
    ceil(sqrt(nrowblk)) row blocks, each added in order from 0, then the
    runs in order."""
    rng = np.random.default_rng(nrb)
    part = rng.random((nrb, 3)) * 10.0 ** rng.uniform(-3, 3, (nrb, 3))
    ln = math.ceil(math.sqrt(nrb))
    assert hk.run_length(nrb) == ln
    want = []
    for ch in range(3):
        runs = []
        for start in range(0, nrb, ln):
            s = 0.0
            for j in range(start, min(nrb, start + ln)):
                s += part[j, ch]
            runs.append(s)
        total = 0.0
        for s in runs:
            total += s
        want.append(total)
    got = hk.fold_norm(torch.from_numpy(part)).numpy()
    assert np.array_equal(got, np.array(want))


@pytest.mark.parametrize("kk, c, want", [
    (512, 9, (9, 3, 2)), (1000, 9, (9, 3, 2)), (27000, 9, (9, 3, 4)),
    (27000, 144, (144, 2, 2)), (512, 144, (144, 2, 2)),
    (4096, 13, (13, 3, 4)), (64, 1, (1, 3, 2)), (40, 600, (200, 1, 2))])
def test_update_plan_fills_the_card(kk, c, want):
    """K3''s grid: the fewest threads per chain (3, 2 or 1) that a block
    of at most 288 threads holds, so that each thread takes 6 to 18
    elements of a piece; blocks of the fewest rows that give a thread 9
    elements, halved while the grid holds fewer than two blocks per SM
    (132 SMs), down to one piece of 2 rows; the chains in equal tiles of
    at most 256."""
    got = hk.update_plan(kk, c, 132)
    assert got == want
    ct, kr, rows = got
    assert kr * ct <= hk.UPD_THREADS and 18 % kr == 0
    nblocks = hk.nrowblk(kk) * (hk.ROWS_PER_BLOCK // rows) * -(-c // ct)
    assert nblocks >= 2 * 132 or rows == hk.PIECE_ROWS
    assert 9 * rows >= hk.UPD_EPT * kr or nblocks < 2 * 132 * 2
