"""The multi-rank dry run: ``python -m rslmtoasa_tpu_torch.dryrun N
[device=cuda|cpu]``.

The port's counterpart of the JAX package's ``__graft_entry__.py
dryrun_multichip`` (:36).  It spawns N ranks (:mod:`.parallel.launch`; on
the card by default, the ranks sharing cards over gloo where there are
more ranks than cards) and runs on every rank each stage of that dry run
that has a counterpart in the port, each held at the JAX dry run's bar:

* the chain-sharded scalar and block recursions and Chebyshev moments
  against one rank (1e-12);
* the DOS all-reduce (exact);
* the all-gather and the halo SpMV against the whole table's (1e-12);
* the row-sharded scalar recursion against the unsharded one (1e-9);
* ``run_block`` and ``run_chebyshev`` over the ranks against one rank
  (1e-12);
* the conductivity's unit partition against one rank (1e-12);
* the exchange pair driver over the ranks against one rank: its chains
  within 1e-12, Jij/Dij/Aij within 1e-9 mRy, ten times the JAX dry run's
  1e-10.  Jij/Dij/Aij move linearly with the chains, by ~1e4 mRy per
  unit (:func:`.parallel.stages.exchange_roundoff`): chains that differ
  by roundoff (~3e-15, as a rank's share recurred at another batch width
  can round on the card) read up to ~1e-10 mRy, chains wrong at 1e-12
  read ~3e-8 mRy, and the bar lies between;
* the row-slab block recursion and Chebyshev moments on a layered
  (surface-type) table and on an impurity table with local rows against
  one rank (1e-10).

The JAX dry run's multi-site conv engine stages (chain-sharded and
grid-sharded, on corrected stencils too) and its df64 Kubo stage have no
counterpart: those engines are TPU workarounds the port leaves behind, and
the row slabs take the grid-sharded engines' place.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

NOT_APPLICABLE = (
    "ms conv engine chain-sharded (TPU multi-site conv engine)",
    "grid-sharded ms conv engines, plain and corrected stencils (replaced "
    "by the row slabs)",
    "df64 ms Kubo moments (TPU df64 engine)",
)

#: stage -> bar (max abs difference), the JAX dry run's
BARS = {"scalar": 1e-12, "block": 1e-12, "cheb": 1e-12, "spmv_step": 1e-12,
        "spmv_halo": 1e-12, "rowsharded_scalar": 1e-9, "run_block": 1e-12,
        "run_cheb": 1e-12, "cond": 1e-12, "exchange_chains": 1e-12,
        "exchange": 1e-9, "slab_layered": 1e-10, "slab_impurity": 1e-10}


def _err(a, b) -> float:
    if isinstance(a, tuple):
        return max(_err(x, y) for x, y in zip(a, b))
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def run_stages():
    """Every stage on this rank; raises where a bar is missed.  Returns
    the stages' differences and the raw results."""
    from .models.presets import build_synthetic_bcc
    from .parallel import stages
    from .parallel.mesh import make_mesh

    mesh = make_mesh()
    dev = stages._device()
    t0 = time.perf_counter()
    chain = stages.chain_suite()
    errs = {k: _err(chain[k], chain[k + "_1"])
            for k in ("scalar", "block", "cheb", "run_block", "run_cheb",
                      "cond", "exchange_chains", "exchange")}
    n = chain["scalar"][0].shape[1]
    if not np.allclose(chain["dos"], 3 * mesh.world, rtol=0, atol=0):
        raise AssertionError(f"DOS all-reduce gave {chain['dos'][:3]}, "
                             f"want {3 * mesh.world}")
    if not np.allclose(chain["scalar"][1][0], 1.0) or n != 16:
        raise AssertionError("chain-sharded scalar: b2[0] != 1 or chains "
                             "lost")
    sp = stages.spmv_suite()
    errs["spmv_step"] = _err(sp["step"], sp["dense"])
    errs["spmv_halo"] = _err(sp["halo"], sp["dense"])

    sysb = build_synthetic_bcc(rc=8.0, ndim=2000, lld=5, nsp=2, device=dev)
    hb = sysb.ham
    lsham = hb.lsham
    hs_l, lsh_l, iz_l = stages.layered_tables(hb.ee, lsham,
                                              sysb.cluster.cr)
    hs_i, iz_r, iz_o = stages.impurity_tables(hb.ee, hb.iz)
    res = stages.slab_cases({
        "scalar": dict(hs=hb.ee, lsham=lsham, iz=hb.iz, kinds=("scalar",)),
        "layered": dict(hs=hs_l, lsham=lsh_l, iz=iz_l),
        "impurity": dict(hs=hs_i, lsham=lsham, iz=iz_r, iz_onsite=iz_o,
                         nmax=6),
    }, cols=hb.cols, starts=[0, 1], lld=5)
    errs["rowsharded_scalar"] = _err(res["scalar"]["scalar"],
                                     res["scalar"]["scalar_1"])
    for case in ("layered", "impurity"):
        errs["slab_" + case] = max(
            _err(res[case][k], res[case][k + "_1"]) for k in ("block",
                                                              "cheb"))
    bad = {k: v for k, v in errs.items() if not v <= BARS[k]}
    if bad:
        raise AssertionError(f"rank {mesh.rank}: over the dry run's bars: "
                             f"{bad}")
    return {"errors": errs, "bars": BARS,
            "seconds": time.perf_counter() - t0,
            "world": mesh.world, "device": str(dev), "chain": chain,
            "spmv": sp, "slabs": res}


def run(n: int, device: str = "cuda"):
    """The dry run on ``n`` ranks; returns rank 0's :func:`run_stages`."""
    from .parallel import launch

    return launch.run("rslmtoasa_tpu_torch.dryrun:run_stages", n,
                      device=device, timeout=1200.0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n, device = 2, "cuda"
    for arg in argv:
        if arg.startswith("device="):
            device = arg[7:]
        else:
            n = int(arg)
    if torch.device(device).type == "cuda":
        from .utils.device import resolve_device

        resolve_device(device)
    out = run(n, device)
    for k, v in out["errors"].items():
        print(f"  {k:18s} max |diff| {v:.3e}  (bar {out['bars'][k]:.0e})")
    for k in NOT_APPLICABLE:
        print(f"  not applicable: {k}")
    print(f"dry run ok on {n} ranks ({out['device']}, "
          f"{out['seconds']:.1f} s on rank 0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
