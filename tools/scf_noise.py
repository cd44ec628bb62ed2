"""How far the port's SCF scalars move under roundoff-sized changes of the
Green function, with no kernel involved.

    JAX_PLATFORMS=cpu python tools/scf_noise.py [block|chebyshev] [K] [BOX] [DEVICE]

Runs the port's bcc preset (``rc=120, ndim=1_000_000, lld=20``, ``nsp=2``,
box ``BOX``, default 10, so kk = 1000; the Chebyshev window (-1.5, 1.0))
on ``DEVICE`` (``cpu``, the default, or ``cuda``) through the kernels'
plain versions, for one and for two SCF iterations:
* with g0 scaled by 1 + k 1e-14 for k = -K..K (default 6), and prints each
  k's etot, Fermi level and ql against k = 0 after two iterations, and the
  spread of each over k after one and after two;
* on ``cuda``, also through K4 (k = 0), against the plain run;
* on ``cpu`` with ``recur='block'``, also with g0 from the JAX package's
  NumPy ``bgreen`` (one atom at a time) in place of the port's torch one,
  and prints both g0's largest difference per energy and the scalars'
  moves.

Neither perturbation touches the recursion; what moves the scalars after
the second iteration is the native atomic-sphere solver, whose eigenvalue
searches stop at |de| <= 1e-8.  Run it from the repository's root.
"""

import copy
import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")
from rslmtoasa_tpu_torch.models import scf as scf_mod  # noqa: E402
from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc  # noqa

PORT_GREEN = {"block": scf_mod.bgreen, "chebyshev": scf_mod.chebyshev_green}
NAME = {"block": "bgreen", "chebyshev": "chebyshev_green"}


def run(base, recur, green, nstep, plain=True):
    setattr(scf_mod, NAME[recur], green)
    try:
        sys_ = copy.deepcopy(base)
        sys_.plain = plain
        with tempfile.TemporaryDirectory() as work:
            scf = scf_mod.SelfConsistency(sys_, workdir=work)
            scf.run(nstep=nstep)
    finally:
        setattr(scf_mod, NAME[recur], PORT_GREEN[recur])
    pot = sys_.atoms[0].potential
    return pot.etot, scf.fermi, pot.ql.copy()


def numpy_bgreen(a_b, b_b, a_inf, b_inf, ene, device, sym_term=False):
    from rslmtoasa_tpu.physics import greens as jax_greens

    return np.stack([jax_greens.bgreen(a_b[:, n], b_b[:, n], a_inf[n],
                                       b_inf[n], ene, sym_term=sym_term)
                     for n in range(a_b.shape[1])])


def compared_bgreen(*args, **kw):
    """The port's g0, after printing how far NumPy's lies from it."""
    got = PORT_GREEN["block"](*args, **kw)
    want = numpy_bgreen(*args, **kw)
    rel = (np.abs(got - want).max(axis=(1, 2))
           / np.abs(want).max(axis=(1, 2))).max()
    print(f"  g0 torch vs NumPy: largest difference per energy {rel:.3e} "
          "of that energy's scale", flush=True)
    return got


def moved(row, ref):
    return (f"etot {row[0] - ref[0]:+.3e} fermi {row[1] - ref[1]:+.3e} "
            f"ql {np.abs(row[2] - ref[2]).max():.3e}")


def main(recur="block", kmax=6, box=10, device="cpu"):
    base = build_synthetic_bcc(device=device, nsp=2, rc=120.0,
                               ndim=1_000_000, lld=20, box=box)
    base.cfg.control.recur = recur
    if recur == "chebyshev":
        base.cfg.energy.energy_min, base.cfg.energy.energy_max = (-1.5, 1.0)
    green = PORT_GREEN[recur]
    ks = range(-kmax, kmax + 1)
    for nstep in (1, 2):
        rows = []
        for k in ks:
            scaled = (lambda *a, _k=k, **kw: green(*a, **kw)
                      * (1.0 + _k * 1e-14))
            rows.append(run(base, recur, scaled, nstep))
        ref = rows[kmax]
        if nstep == 2:
            for k, row in zip(ks, rows):
                print(f"{recur}, box {box}, {device}, 2 iterations, g0 "
                      f"times 1 + {k} 1e-14 against k = 0: {moved(row, ref)}",
                      flush=True)
        etot, fermi = (np.array([r[i] for r in rows]) for i in (0, 1))
        ql = np.array([r[2] for r in rows])
        print(f"{recur}, box {box}, {device}, {nstep} iteration(s), g0 times "
              f"1 + k 1e-14, |k| <= {kmax}: spread of etot "
              f"{np.ptp(etot):.3e}, fermi {np.ptp(fermi):.3e}, ql "
              f"{np.ptp(ql, axis=0).max():.3e}", flush=True)
        if device != "cpu":
            k4 = run(base, recur, green, nstep, plain=False)
            print(f"{recur}, box {box}, {device}, {nstep} iteration(s), K4 "
                  f"against plain: {moved(k4, ref)}", flush=True)
        elif recur == "block":
            a = run(base, recur, green, nstep)
            b = run(base, recur, compared_bgreen, nstep)
            c = run(base, recur, numpy_bgreen, nstep)
            assert a[0] == b[0]  # compared_bgreen returns the port's g0
            dql = np.abs(a[2] - c[2]).max()
            print(f"{recur}, {nstep} iteration(s), NumPy's bgreen against "
                  f"the port's: etot {abs(a[0] - c[0]):.3e}, fermi "
                  f"{abs(a[1] - c[1]):.3e}, ql {dql:.3e}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0] if args else "block",
         int(args[1]) if len(args) > 1 else 6,
         int(args[2]) if len(args) > 2 else 10,
         args[3] if len(args) > 3 else "cpu")
