"""The recursion's start blocks in compact form (``StartBlocks``) on the CPU.

* made dense, the pair start blocks hold the bits of the JAX package's
  ``pair_start_vectors`` (its live chains, in the port's layout) and of the
  port's former ``pair_start_vectors``, which built them dense;
* the block and Chebyshev dispatches on the wavefront (``RSLMTO_WAVEFRONT_KK``
  lowered, as ``tests/test_torch_wavefront.py`` does) give from the compact
  form the dense tensor's coefficients bit for bit, with spin-orbit coupling
  and in the collinear spin sectors, building only the first stage's n0 + 1
  rows and never the (kk+1, 18, 18 R) tensor; the full width alike; the
  dispatch's routes counter names the route taken;
* a Jij table of the port on a box where the wavefront engages, through the
  benchmark's harness, against the kind ``exchange_cone``'s sub-box
  reference on a seeded potential, one ``start-blocks`` span a table;
* that reference equals the whole-box reference (``reference/jij.py
  exchange_table``) where the sub-boxes are smaller than the box;
* two gloo ranks on the chain-sharded route from the compact form equal one
  rank, and each rank builds only its share of the chains.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness, jobs
from benchmark.reference.jij import exchange_table
from rslmtoasa_tpu.models.exchange import pair_start_vectors as jax_starts
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models.exchange import (
    SIGNS,
    pair_chains,
    pair_start_blocks,
)
from rslmtoasa_tpu_torch.ops import wavefront as pwf
from rslmtoasa_tpu_torch.ops.block_lanczos import StartBlocks, port_layout
from rslmtoasa_tpu_torch.parallel import dispatch as pdispatch
from rslmtoasa_tpu_torch.parallel import launch

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = dict(rc=45.0, ndim=100000, lld=8, nsp=2)  # kk = 2 636
AB = (1.5, -0.25)  # H~ = (H - b) / a of the Chebyshev moments
CELL = "bccfe100-jij-block"
SEED = 2900000033


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def bcc():
    """The port's fixture system, its one-shell pairs (R = 5, C = 90) and
    its tables as host arrays."""
    sys_ = presets.build_synthetic_bcc(device="cpu", **FIXTURE)
    hb = sys_.ham
    pairs = presets.exchange_pairs(sys_.cluster, 1) - 1
    return dict(kk=sys_.cluster.kk, pairs=pairs,
                tabs=(hb.ee, hb.lsham, hb.iz, hb.cols))


@pytest.fixture
def lowered(monkeypatch):
    """The wavefront's threshold under the fixture's kk, one rank."""
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "1000")
    monkeypatch.setattr(pdispatch, "_mesh_cache",
                        {"mesh": None, "checked": True})
    pdispatch.local_routes.clear()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t).view(torch.int64)


# ----------------------------------------------------------------------
# the form
def test_dense_form_holds_the_dense_tensors_bits(bcc):
    kk, pairs = bcc["kk"], bcc["pairs"]
    blocks = pair_start_blocks(kk, pairs, CPU)
    chains = pair_chains(pairs)
    got = blocks.dense()
    assert got.shape == blocks.shape == (kk + 1, 18, 18 * len(chains))
    assert torch.equal(got, torch.from_numpy(port_layout(
        np.asarray(jax_starts(kk, pairs))[chains])))
    # the dense tensor as the port built it before the compact form
    want = torch.zeros(got.shape, dtype=torch.complex128)
    eye = torch.eye(18, dtype=torch.complex128)
    for r, ch in enumerate(chains):
        i, j = pairs[ch // 4]
        asign, bsign = (1.0, 1.0) if i == j else SIGNS[ch % 4]
        want[i, :, 18 * r:18 * (r + 1)] = asign * eye
        want[j, :, 18 * r:18 * (r + 1)] = bsign * eye
    assert torch.equal(_bits(got), _bits(want))
    assert blocks.rows.tolist() == sorted({int(x) for x in pairs.ravel()})
    # a spin sector's cut, and a selection of chains with repeats
    cut = got.view(kk + 1, 18, -1, 18)[:, 9:, :, 9:].reshape(kk + 1, 9, -1)
    assert torch.equal(blocks.sector(9).dense(), cut)
    sel = blocks.select([2, 0, 0]).dense()
    assert torch.equal(sel, torch.cat([got[..., 36:54], got[..., :18],
                                       got[..., :18]], -1))
    # whole chains cut as from the tensor, and nothing else
    assert torch.equal(blocks[:, :, 18:54].dense(), got[..., 18:54])
    for idx in ((slice(None), slice(None), slice(9, 36)),
                (slice(1, None), slice(None), slice(None))):
        with pytest.raises(IndexError, match="whole"):
            blocks[idx]


def test_first_stage_rows_and_their_limit(bcc):
    kk, pairs = bcc["kk"], bcc["pairs"]
    blocks = pair_start_blocks(kk, pairs, CPU)
    plan = pwf.make_plan(bcc["tabs"][3], kk, blocks.rows, 6,
                         granularity=128)
    n0 = plan.stages[0][0]
    got = pwf.permuted_start(blocks, plan)
    assert got.shape == (n0 + 1, 18, 18 * len(pair_chains(pairs)))
    assert torch.equal(_bits(got), _bits(pwf.permuted_start(blocks.dense(),
                                                            plan)))
    far = StartBlocks(kk, [[(int(plan.perm[-1]), 1.0)]], CPU)
    with pytest.raises(ValueError, match="first stage"):
        pwf.permuted_start(far, plan)
    with pytest.raises(ValueError, match="outside the cluster"):
        StartBlocks(kk, [[(kk, 1.0)]], CPU)


# ----------------------------------------------------------------------
# the dispatch
def _no_dense(monkeypatch):
    """Forbid the dense tensor; return the shapes ``permuted_start``
    gives."""
    def dense(self):
        raise AssertionError("the (kk+1, d, R d) start tensor was built")
    monkeypatch.setattr(StartBlocks, "dense", dense)
    shapes, start = [], pwf.permuted_start

    def recorded(psi0, plan):
        out = start(psi0, plan)
        shapes.append((tuple(out.shape), plan.stages[0][0]))
        return out
    monkeypatch.setattr(pwf, "permuted_start", recorded)
    return shapes


@pytest.mark.parametrize("soc", [True, False])
def test_wavefront_from_the_compact_form_bit_for_bit(bcc, lowered,
                                                     monkeypatch, soc):
    """With spin-orbit coupling one 18-wide recursion, without it two
    9-wide spin sectors, each through the wavefront."""
    kk, pairs = bcc["kk"], bcc["pairs"]
    ee, lsham, iz, cols = bcc["tabs"]
    lsham = lsham if soc else np.zeros_like(lsham)
    blocks = pair_start_blocks(kk, pairs, CPU)
    dense = blocks.dense()
    want_b = pdispatch.block_lanczos_auto(ee, lsham, iz, cols, dense, 5)
    want_c = pdispatch.chebyshev_moments_auto(ee, lsham, iz, cols, dense, 4,
                                              *AB, guard=False)
    pdispatch.local_routes.clear()
    shapes = _no_dense(monkeypatch)
    got_b = pdispatch.block_lanczos_auto(ee, lsham, iz, cols, blocks, 5)
    got_c = pdispatch.chebyshev_moments_auto(ee, lsham, iz, cols, blocks, 4,
                                             *AB, guard=False)
    for g, w in zip(got_b + (got_c,), want_b + (want_c,)):
        assert g.shape == w.shape and np.array_equal(g, w)
    sectors = 1 if soc else 2
    assert pdispatch.local_routes == {"wavefront_block": sectors,
                                "wavefront_cheb": sectors}
    assert len(shapes) == 2 * sectors
    c = 18 * len(pair_chains(pairs)) // sectors
    for (n1, d, cc), n0 in shapes:
        assert (n1, d, cc) == (n0 + 1, 18 // sectors, c) and n0 < kk


def test_full_width_from_the_compact_form(bcc, monkeypatch):
    """Below the threshold the full width recurs the dense tensor, the same
    bits as from the tensor."""
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "999999999")
    monkeypatch.setattr(pdispatch, "_mesh_cache",
                        {"mesh": None, "checked": True})
    blocks = pair_start_blocks(bcc["kk"], bcc["pairs"][1:], CPU)
    pdispatch.local_routes.clear()
    got = pdispatch.block_lanczos_auto(*bcc["tabs"], blocks, 3)
    want = pdispatch.block_lanczos_auto(*bcc["tabs"], blocks.dense(), 3)
    assert pdispatch.local_routes == {"full_block": 2}
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ----------------------------------------------------------------------
# the Jij table against the benchmark's sub-box reference
def _small_root(tmp_path, n: int, lld: int, npairs: int) -> str:
    """The benchmark with the new cell's configuration cut to an n^3 box,
    lld ``lld`` and 200 energy channels, its traffic to the first
    ``npairs`` pairs."""
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    cell = harness.Cell(root, CELL)
    path = os.path.join(root, "benchmark", "configs",
                        "bccfe-nsp2-box100.json")
    cfg = dict(cell.config, n1=n, n2=n, n3=n)
    cfg["namelists"]["control"]["lld"] = lld
    cfg["namelists"]["energy"]["channels_ldos"] = 200
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    tpath = os.path.join(root, "benchmark", "traffic", "jij-block-cone.json")
    traffic = dict(cell.traffic, pairs=cell.traffic["pairs"][:npairs])
    with open(tpath, "w") as fh:
        json.dump(traffic, fh)
    return root


def test_jij_table_on_the_wavefront_against_the_cone_reference(
        tmp_path, monkeypatch):
    """Box 14 (2 744 atoms), lld 5, the onsite and nearest pairs (R = 5):
    the pair recursion takes the wavefront.  The port's table and the
    sub-box reference differ only in the order of their sums (the
    wavefront's permuted rows, the grid's), so the chains agree to
    roundoff, and the Green functions and the exchange within what the
    real-axis poles make of it; the complex64 control reads 1e-5 to 1e-3
    on these numbers at box 30 (PERF.md)."""
    root = _small_root(tmp_path, 14, 5, 2)
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "1000")
    monkeypatch.setattr(pdispatch, "_mesh_cache",
                        {"mesh": None, "checked": True})
    pdispatch.local_routes.clear()
    cell = harness.Cell(root, CELL)
    # the harness's run without its check that JAX is not loaded (this
    # module loads it, for the JAX package's start blocks)
    m, records, slots = harness.execute(cell, SEED, 0.01, False, "cpu", 0.0)
    got, _ = cell.kind.compare(cell, records, slots,
                               harness.draw(SEED, len(records) - 1), CPU,
                               jobs.seeded_state(cell.config, SEED))
    jobs_ = 1 + m.n_jobs  # the warm-up and the window
    assert pdispatch.local_routes == {"wavefront_block": jobs_}
    assert m.calls["start-blocks"] == m.n_jobs
    assert m.calls["wavefront-plan"] == m.n_jobs
    assert got["ham"] == 0.0  # both build the blocks alike
    assert got["coef"] <= 1e-12  # roundoff of the sums' order
    assert got["terminator"] <= 1e-12
    assert got["green"] <= 1e-8  # relative, near the poles
    assert got["jij"] <= 1e-8  # mRy
    # mRy: the files print seven digits of values up to ~25 mRy here
    assert got["twoindex"] <= 1e-5


def test_cone_reference_equals_the_whole_box(tmp_path):
    """Box 12, lld 4: each pair's sub-box is smaller than the box, and the
    tables agree with the whole box's to roundoff in the chains and their
    terminators; the Green functions and the exchange carry it through the
    real-axis poles (1e-11 to 1e-10 read)."""
    root = _small_root(tmp_path, 12, 4, 2)
    cell = harness.Cell(root, CELL)
    box, kind = cell.box(), cell.kind
    pairs = kind.pair_sites(cell, box)
    for pair in pairs:
        assert all(s < 12 for s in kind.cone_box(box, pair, 3).dims)
    state = jobs.seeded_state(cell.config, SEED)
    sub = kind.reference(cell, state, CPU, torch.complex128)
    whole = exchange_table(box, cell.run_params(), state, pairs, CPU,
                           torch.complex128)

    def rel(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    for key in ("coef", "term"):
        for g, w in zip(sub[key], whole[key]):
            assert g.shape == w.shape and rel(g, w) <= 1e-13
    assert rel(sub["gij"], whole["gij"]) <= 1e-9
    for key in ("jij", "dmi", "aij"):
        assert np.abs(sub[key] - whole[key]).max() <= 1e-9 * max(
            1.0, np.abs(whole[key]).max())
    assert np.array_equal(sub["blocks"], whole["blocks"])


# ----------------------------------------------------------------------
# two ranks
def test_two_ranks_build_their_share_only():
    out = launch.run("rslmtoasa_tpu_torch.parallel.stages:"
                     "pair_chains_sharded", 2, device="cpu", lld=5)
    sharded, one = out["sharded"], out["one"]
    assert sharded["routes"] == {"chains_block": 1}
    assert one["routes"] == {"full_block": 1}
    kk1 = int(sharded["built"][0][0])
    # R = 9 chains: 5 a rank (chain 0 copied once on rank 1), all 9 alone
    assert sharded["built"] == [(kk1, 18.0, 90.0)] * 2
    assert one["built"] == [(kk1, 18.0, 162.0)] * 2
    for g, w in zip(sharded["chains"], one["chains"]):
        assert g.shape == w.shape == (5, 9, 18, 18)
        assert np.abs(g - w).max() <= 1e-12
