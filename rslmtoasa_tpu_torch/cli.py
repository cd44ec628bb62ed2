"""Command-line driver (the reference binary ``rslmto.x`` equivalent).

Usage (reference ``source/os.f90 argument_parser`` :34-158 and
``calculation.f90 process`` :175-211)::

    python -m rslmtoasa_tpu_torch [input.nml] [nml=extra.nml ...]
                                  [output=dir] [device=cuda|cpu]

Reads the namelist input and runs the self-consistent field of a bulk,
surface or impurity cluster (``pre_processing`` ``none``, ``bravais``,
``buildsurf``, ``newclubulk`` or ``newclusurf``), writing the reference's
output files (totaldos.out, <El>_out.nml, report.out and, after a
``bravais`` SCF, the PAOFLOW export rs2paoham.dat), and prints the
hierarchical timing report.  The other ``&calculation`` branches:

* ``post_processing='exchange'``: the exchange couplings of a bulk or
  surface cluster (jij.out, dij.out, aij.out, jtens.out and the two-index
  files, or jijk.out for ``njijk > 0``);
* ``post_processing='conductivity'``: the Kubo-Bastin conductivity of a
  bulk or surface cluster (cond_total.out, cond_total_orb_{real,im}.out
  and, per type, <El>_cond.out and <El>_cond_orb_{real,im}.out);
* ``post_processing='paoflow2rs'``, ``'exchange_p2rs'`` and
  ``'conductivity_p2rs'``: the SCF, exchange or conductivity on the
  Hamiltonian read from ``paoham.dat`` beside the input file;
* ``post_processing='orbital_modern'``: the orbital moment's KPM trace
  over ``min(kk, 2000)`` sites, written to fort.50;
* ``processing='sd'``: atomistic spin dynamics (``&sd``), an SCF per step,
  written to output.lammpstrj.

The recursions run on ``device`` (default ``cuda``; without a card that
raises).  Under ``torchrun --nproc_per_node=N -m rslmtoasa_tpu_torch
input.nml`` each process joins the process group
(:func:`.parallel.mesh.init_distributed`: NCCL on ``cuda:LOCAL_RANK``,
gloo with ``device=cpu`` or with ``RSLMTO_SHARE_CARDS=1`` where ranks
share cards) and the recursions are split over the ranks
(:mod:`.parallel.dispatch`).  Every rank runs the host parts (the
Hamiltonian, the fits, the atomic-sphere solver, the mixer), as the
reference's ranks do; only rank 0 writes into ``output`` and logs, the
others write into a temporary directory that is removed at their end.  ``&lattice write_artifacts`` (or ``RSLMTO_WRITE_GEOM``) writes
the geometry exports ``clust``, ``map``, ``str.out``, ``sbar`` and
``view.sbar`` after the system is built (``utils/artifacts.py``).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

from .config import JobConfig
from .utils.device import resolve_device
from .utils.logger import g_logger
from .utils.namelist import read_namelists
from .utils.timer import g_timer

VALID_PRE = {"none", "bravais", "buildsurf", "newclubulk", "newclusurf"}
VALID_PROC = {"none", "sd"}
VALID_POST = {"none", "exchange", "exchange_p2rs", "conductivity",
              "conductivity_p2rs", "paoflow2rs", "orbital_modern"}
P2RS = ("paoflow2rs", "exchange_p2rs", "conductivity_p2rs")


def parse_args(argv):
    input_file = "input.nml"
    extra = []
    outdir = "."
    device = "cuda"
    for arg in argv:
        if arg.startswith("nml="):
            extra.append(arg[4:])
        elif arg.startswith("output="):
            outdir = arg[7:]
        elif arg.startswith("device="):
            device = arg[7:]
        else:
            input_file = arg
    return input_file, extra, outdir, device


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    input_file, extra, outdir, device = parse_args(argv)
    dev = resolve_device(device)
    from .parallel.mesh import init_distributed, rank

    dev = init_distributed(device=device) or dev
    if rank() != 0:
        scratch = tempfile.mkdtemp(prefix=f"rslmto_rank{rank()}_")
        level = g_logger.level
        g_logger.level = 100  # above fatal: only rank 0 logs
        try:
            return _run(input_file, extra, scratch, dev, quiet=True)
        finally:
            g_logger.level = level
            shutil.rmtree(scratch, ignore_errors=True)
    return _run(input_file, extra, outdir, dev)


def _run(input_file, extra, outdir, dev, quiet: bool = False) -> int:
    if not os.path.exists(input_file):
        g_logger.error(f"input file {input_file} not found")
        return 1
    nml = read_namelists(input_file)
    for path in extra:
        nml.merge(read_namelists(path))
    cfg = JobConfig.from_namelists(nml, fname=input_file)
    os.makedirs(outdir, exist_ok=True)
    if cfg.atoms.database in ("", "./", "."):
        cfg.atoms.database = os.path.dirname(os.path.abspath(input_file))
    return run_calculation(cfg, outdir, device=dev, quiet=quiet)


def run_calculation(cfg: JobConfig, workdir: str = ".",
                    device="cuda", quiet: bool = False) -> int:
    """Run the dispatched pipeline for a built config (the body of
    ``calculation%process``, calculation.f90:175-211)."""
    pre = (cfg.calculation.pre_processing or "none").strip()
    proc = (cfg.calculation.processing or "none").strip()
    post = (cfg.calculation.post_processing or "none").strip()
    for val, ok in ((pre, VALID_PRE), (proc, VALID_PROC), (post, VALID_POST)):
        if val not in ok:
            g_logger.error(f"invalid calculation stage {val!r}")
            return 1

    from .models.bulk import BulkSystem
    from .utils import artifacts

    os.makedirs(workdir, exist_ok=True)
    sys_ = BulkSystem.build(cfg, workdir, device=device)
    if artifacts.wanted(cfg):
        # clust/map/sbar/str.out interop exports (structb writes,
        # lattice.f90:1819+)
        artifacts.export_geometry(sys_, workdir)
    run_system(sys_, workdir)
    if not quiet:
        print(g_timer.report())
        from .utils.alloc import g_alloc

        print(g_alloc.report())
    return 0


def run_system(sys_, workdir: str):
    """The ``&calculation`` branches of ``sys_.cfg`` on a built system
    (``paoham.dat`` is read beside ``cfg.control.fname``); returns the
    branch's calculation object."""
    calc = sys_.cfg.calculation
    pre = (calc.pre_processing or "none").strip()
    proc = (calc.processing or "none").strip()
    post = (calc.post_processing or "none").strip()
    if post in P2RS:
        # an external PAOFLOW TB Hamiltonian in place of the LMTO-built one
        # (post_processing_paoflow2rs, calculation.f90 :643-838); every
        # recursion operator is built after it
        from .models.paoflow import import_paoflow

        sys_.build_hamiltonian()
        import_paoflow(sys_, os.path.join(os.path.dirname(os.path.abspath(
            sys_.cfg.control.fname or "input.nml")), "paoham.dat"))
        sys_.freeze_ham = True
    if post in ("exchange", "exchange_p2rs"):
        return run_exchange(sys_, workdir)
    if post in ("conductivity", "conductivity_p2rs"):
        from .models.conductivity import ConductivityCalculation

        calc = ConductivityCalculation(sys_, workdir)
        calc.run(cond_type=sys_.cfg.control.cond_type)
    elif post == "orbital_modern":
        from .models.orbital import OrbitalMoment

        # the exact trace up to 2000 sites, a subsample beyond
        calc = OrbitalMoment(sys_, workdir)
        calc.run(n_sites=min(sys_.cluster.kk, 2000))
    elif post == "paoflow2rs":
        from .models.scf import SelfConsistency

        calc = SelfConsistency(sys_, workdir)
        calc.run()
    elif proc == "sd":
        from .models.spin_dynamics import SpinDynamics

        calc = SpinDynamics(sys_, workdir)
        calc.run()
    else:
        calc = run_scf(sys_, workdir, pre)
    return calc


def run_exchange(sys_, workdir: str):
    """``post_processing='exchange'`` (JAX ``cli.py`` :130-147): the pairs
    of ``&lattice ijpair`` and the two-index split, or with ``njijk > 0``
    the three pairs of each ``ijktrio`` row and Jijk."""
    from .models.exchange import ExchangeCalculation, trio_pairs

    lat = sys_.cfg.lattice
    if lat.njijk > 0:
        xc = ExchangeCalculation(sys_, trio_pairs(lat.ijktrio), workdir)
        xc.run()
        xc.calculate_jijk(lat.ijktrio)
    else:
        if lat.ijpair is None:
            raise ValueError("post_processing='exchange' needs &lattice "
                             "njij > 0 and ijpair")
        xc = ExchangeCalculation(sys_, lat.ijpair, workdir)
        xc.run()
        xc.calculate_exchange_twoindex()
    return xc


def run_scf(sys_, workdir: str, pre: str):
    """The self-consistent field, with the post-SCF exports of
    ``pre_processing='bravais'``."""
    from .models.scf import SelfConsistency

    scf = SelfConsistency(sys_, workdir)
    state = scf.run()
    g_logger.info(
        f"SCF finished: converged={state.converged} "
        f"delta={state.delta:.3e}"
    )
    scf.report()
    if pre == "bravais" and getattr(scf, "bands", None) is not None:
        # post-SCF exports of pre_processing_bravais (calculation.f90
        # :619-621): rs2pao + orbital quadrupoles
        from .models.paoflow import export_rs2pao

        export_rs2pao(sys_, os.path.join(workdir, "rs2paoham.dat"))
        scf.bands.calculate_orbital_quadrupoles(scf.last_g0, workdir)
    return scf


if __name__ == "__main__":
    raise SystemExit(main())
