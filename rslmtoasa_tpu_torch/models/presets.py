"""Built-in synthetic system presets (no external database files needed).

Used by the benchmark and the compile-check entry points: a bcc
transition-metal-like species with physically plausible spd band
parameters (magnitudes typical of 3d metals; values chosen here, not
taken from any database file).
"""

from __future__ import annotations

import os

import numpy as np

from ..atoms.potential import Element, Potential, SymbolicAtom
from ..config import (
    AtomsCfg,
    CalculationCfg,
    ControlCfg,
    EnergyCfg,
    HamiltonianCfg,
    JobConfig,
    LatticeCfg,
    MixCfg,
    SelfCfg,
)
from ..utils.device import resolve_device
from ..utils.namelist import Namelists, parse_namelists, write_namelist


def synthetic_bcc_atom(label: str = "X") -> SymbolicAtom:
    el = Element(symbol=label, atomic_number=26.0, core=18.0, valence=8.0,
                 f_core=0, num_quant_s=4, num_quant_p=4, num_quant_d=3)
    pot = Potential()
    pot.ws_r = 2.66
    # spd tight-binding band centers/widths (Ry), spin-split d band
    pot.center_band[:, 0] = [-0.40, 0.34, -0.21]
    pot.center_band[:, 1] = [-0.18, 0.40, -0.05]
    pot.width_band[:, 0] = [0.40, 0.26, 0.12]
    pot.width_band[:, 1] = [0.40, 0.27, 0.14]
    pot.pl[:, 0] = [4.67, 4.41, 3.87]
    pot.pl[:, 1] = [4.67, 4.43, 3.68]
    pot.ql[0, :, 0] = [0.33, 0.37, 4.37]
    pot.ql[0, :, 1] = [0.36, 0.44, 2.13]
    pot.ql[2, :, 0] = [0.007, 0.005, 0.045]
    pot.ql[2, :, 1] = [0.006, 0.007, 0.012]
    pot.xi_p[:] = 0.012
    pot.xi_d[:] = 0.004
    # orthogonal-representation parameters consistent with the bands,
    # so predls (potential.py:167) is well-defined AND idempotent:
    # with c == enu (cme = 0) it maps center->center, width->srdel
    # scaled by wow^(1/2-I) ~ 1 — the exchange module's predls call
    # (exchange.f90 ordering) then cannot poison a re-run
    pot.enu = pot.center_band.copy()
    pot.c = pot.center_band.copy()
    pot.srdel = pot.width_band.copy()
    from ..atoms.potential import QM_CANONICAL as _QM

    pot.qpar = np.broadcast_to(_QM[:3, None], (3, 2)).copy() + 0.05
    return SymbolicAtom(element=el, potential=pot, label=label)


def synthetic_bcc_config(rc: float = 50.0, ndim: int = 10000,
                         lld: int = 16, nsp: int = 1,
                         channels_ldos: int = 2500) -> JobConfig:
    lat = LatticeCfg(rc=rc, ndim=ndim, alat=2.8612, wav=1.4088,
                     crystal_sym="bcc", ntype=1, r2=9.0)
    lat.ct = np.zeros(50)
    lat.ct[0] = 3.0
    return JobConfig(
        calculation=CalculationCfg(pre_processing="bravais"),
        control=ControlCfg(calctype="B", nsp=nsp, lld=lld,
                           recur="lanczos" if nsp == 1 else "block"),
        lattice=lat,
        atoms=AtomsCfg(database="", labels=["X"]),
        scf=SelfCfg(nstep=1),
        energy=EnergyCfg(channels_ldos=channels_ldos, energy_min=-1.0,
                         energy_max=0.5, fermi=-0.07),
        mix=MixCfg(beta=0.3, mixtype="linear"),
        hamiltonian=HamiltonianCfg(),
        namelists=Namelists(),
    )


def build_synthetic_bcc(rc: float = 50.0, ndim: int = 10000, lld: int = 16,
                        nsp: int = 1, hoh: bool = False, box: int = 0,
                        device="cuda"):
    """Geometry + Hamiltonian for the synthetic bcc system.

    Returns a ready :class:`~rslmtoasa_tpu_torch.models.bulk.BulkSystem`
    with the Hamiltonian built, recursing on ``device``.  ``box=n``
    builds the full n x n x n supercell box
    (the reference's ``pbc=.true.`` cluster shape, ``lattice.f90
    bravais`` :1082-1089) instead of the spherical ``rc`` cut — the
    cell grid is then fully occupied, which is the shape the conv
    engines are speed-of-light on.
    """
    from .bulk import BulkSystem

    cfg = synthetic_bcc_config(rc=rc, ndim=ndim, lld=lld, nsp=nsp)
    cfg.hamiltonian.hoh = hoh
    sys_ = BulkSystem.__new__(BulkSystem)
    sys_.cfg = cfg
    sys_.workdir = "."
    sys_.device = resolve_device(device)
    sys_.atoms = [synthetic_bcc_atom()]
    sys_.sbars = None
    sys_.sbarvecs = None
    sys_.ham = None

    from ..geometry import bravais_cluster, neighbor_map, primitive_cell, sbar_for_cluster
    from ..physics.energy_mesh import EnergyMesh

    cell = primitive_cell("bcc")
    if box:
        cl = bravais_cluster(cell, alat=cfg.lattice.alat, rc=rc,
                             ndim=ndim, wav=cfg.lattice.wav, pbc=True,
                             pbc_dims=(box, box, box))
    else:
        cl = bravais_cluster(cell, alat=cfg.lattice.alat, rc=rc,
                             ndim=ndim, wav=cfg.lattice.wav)
    neighbor_map(cl, ct1=3.0)
    sys_.cluster = cl
    sys_.sbars, sys_.sbarvecs = sbar_for_cluster(cl.cr_ang, cl.iu, cl.wav, 9.0)
    sys_.emesh = EnergyMesh.build(cfg.energy)
    sys_.build_hamiltonian()
    return sys_


def build_synthetic_b2(rc: float = 9.0, ndim: int = 10000, lld: int = 8,
                       nsp: int = 2, hoh: bool = False, device="cuda"):
    """Two-species B2 (CsCl) synthetic system: the smallest multi-site
    cell, used to exercise the multi-site conv engines
    (ops/msconv.py) against the gather engines."""
    from .bulk import BulkSystem

    cfg = synthetic_bcc_config(rc=rc, ndim=ndim, lld=lld, nsp=nsp)
    cfg.lattice.crystal_sym = "b2"
    cfg.lattice.ntype = 2
    cfg.atoms.labels = ["X", "Y"]
    cfg.hamiltonian.hoh = hoh
    sys_ = BulkSystem.__new__(BulkSystem)
    sys_.cfg = cfg
    sys_.workdir = "."
    sys_.device = resolve_device(device)
    at2 = synthetic_bcc_atom("Y")
    at2.potential.center_band[:, 0] = [-0.30, 0.28, -0.15]
    at2.potential.center_band[:, 1] = [-0.22, 0.31, -0.09]
    at2.potential.width_band[:, 0] = [0.37, 0.24, 0.11]
    at2.potential.width_band[:, 1] = [0.37, 0.25, 0.13]
    sys_.atoms = [synthetic_bcc_atom(), at2]
    sys_.sbars = None
    sys_.sbarvecs = None
    sys_.ham = None

    from ..geometry import (
        bravais_cluster,
        neighbor_map,
        primitive_cell,
        sbar_for_cluster,
    )
    from ..physics.energy_mesh import EnergyMesh

    cell = primitive_cell("b2")
    cl = bravais_cluster(cell, alat=cfg.lattice.alat, rc=rc, ndim=ndim,
                         wav=cfg.lattice.wav)
    neighbor_map(cl, ct1=3.0)
    sys_.cluster = cl
    sys_.sbars, sys_.sbarvecs = sbar_for_cluster(cl.cr_ang, cl.iu, cl.wav,
                                                 9.0)
    sys_.emesh = EnergyMesh.build(cfg.energy)
    sys_.build_hamiltonian()
    return sys_


# ----------------------------------------------------------------------
# slab and impurity clusters on the bcc preset's atoms
BAND_SHIFT = 0.01  # Ry: type k beyond the bulk has its bands moved by k times this
SURFACE = "0 0 1"  # the slab's Miller normal
IMPURITIES = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [1.0, 0.0, 0.0]])
# The slab's surface Madelung shifts, mixed in at 5 %: with the bulk's
# fixed Fermi level each surface layer lacks ~0.3 electrons after the first
# iteration, and the whole shift (vmix 1) moves its bands by ~3 Ry, out of
# the Chebyshev window.  At 5 % two iterations stay within it.
SLAB_CHARGE = "&charge\n vmix = 0.05\n/\n"


def shifted_bcc_atom(label: str, k: int) -> SymbolicAtom:
    """:func:`synthetic_bcc_atom` with its band centres (and ``c``,
    ``enu`` with them) moved by ``k * BAND_SHIFT``, so that the types of a
    slab or an impurity cluster differ."""
    at = synthetic_bcc_atom(label)
    pot = at.potential
    for a in (pot.center_band, pot.enu, pot.c):
        a += k * BAND_SHIFT
    return at


def synthetic_embedded_config(calctype: str, rc: float, lld: int, nsp: int,
                              nlay: int = 3, inclu=IMPURITIES) -> JobConfig:
    """The bcc preset's config as a bcc(001) slab of ``nlay`` surface
    layers (``calctype='S'``, ``buildsurf``) or as the bcc host with an
    impurity at each row of ``inclu`` (``'I'``, ``newclubulk``); block
    recursion, one label per type: ``X`` (bulk), ``S1..`` or ``I1..``."""
    cfg = synthetic_bcc_config(rc=rc, ndim=1_000_000, lld=lld, nsp=nsp)
    cfg.control.calctype = calctype
    cfg.control.recur = "block"
    lat = cfg.lattice
    inclu = np.atleast_2d(np.asarray(inclu, dtype=np.float64))
    if calctype == "S":
        labels = [f"S{k}" for k in range(1, nlay + 1)]
        cfg.calculation.pre_processing = "buildsurf"
        lat.surftype, lat.nlay = SURFACE, nlay
        cfg.namelists = parse_namelists(SLAB_CHARGE)
    else:
        labels = [f"I{k}" for k in range(1, inclu.shape[0] + 1)]
        cfg.calculation.pre_processing = "newclubulk"
        lat.nclu, lat.inclu = inclu.shape[0], inclu
    cfg.atoms.labels = ["X"] + labels
    lat.ntype = len(cfg.atoms.labels)
    return cfg


def build_synthetic_embedded(cfg: JobConfig, hoh: bool = False,
                             device="cuda"):
    """``BulkSystem.build`` of :func:`synthetic_embedded_config`'s config
    on the shifted bcc atoms (type k gets ``k * BAND_SHIFT``), with its
    Hamiltonian built, recursing on ``device``."""
    from .bulk import BulkSystem

    cfg.hamiltonian.hoh = hoh
    atoms = [shifted_bcc_atom(label, k)
             for k, label in enumerate(cfg.atoms.labels)]
    sys_ = BulkSystem.build(cfg, device=device, atoms=atoms)
    sys_.build_hamiltonian()
    return sys_


def build_synthetic_surface(rc: float = 340.0, nlay: int = 3, nsp: int = 2,
                            hoh: bool = False, lld: int = 16, device="cuda"):
    """A bcc(001) slab of ``nlay`` surface types over the bcc host
    (``rc=340``: kk = 27 798, three rec atoms, four types)."""
    return build_synthetic_embedded(
        synthetic_embedded_config("S", rc, lld, nsp, nlay=nlay), hoh, device)


def build_synthetic_impurity(rc: float = 220.0, inclu=IMPURITIES,
                             nsp: int = 2, hoh: bool = False, lld: int = 16,
                             device="cuda"):
    """The bcc host with one impurity species at each row of ``inclu``
    (lattice units; ``rc=220``: kk = 27 316, a local zone of 60 atoms for
    the three defaults)."""
    return build_synthetic_embedded(
        synthetic_embedded_config("I", rc, lld, nsp, inclu=inclu), hoh,
        device)


# ----------------------------------------------------------------------
# the exchange configuration on the bcc preset
EXCHANGE_SHELLS = 5  # neighbour shells of atom 1 with one pair each


def exchange_pairs(cluster, nshell: int = EXCHANGE_SHELLS) -> np.ndarray:
    """The onsite pair (1, 1) and one pair (1, j) per neighbour shell of
    atom 1, nearest first: (nshell + 1, 2), 1-based.  j is the first atom
    at the shell's distance in ``np.argsort`` order, as
    ``tests/test_exchange.py`` picks its nn and 2nn."""
    d = np.linalg.norm(cluster.cr_ang - cluster.cr_ang[0], axis=1)
    order = np.argsort(d)
    shells = np.unique(np.round(d[order], 6))[1:nshell + 1]
    js = [int(order[np.argmax(np.isclose(d[order], r))]) for r in shells]
    return np.array([[1, 1]] + [[1, j + 1] for j in js], dtype=np.int64)


def synthetic_exchange(sys_, nshell: int = EXCHANGE_SHELLS):
    """Make the bcc preset ``sys_`` (:func:`build_synthetic_bcc`) an
    exchange run: ``post_processing='exchange'``, ``ijpair`` from
    :func:`exchange_pairs` and one trio (atom 1, its nn, its 2nn; z
    displacement) in ``ijktrio``.  ``njijk`` stays 0: set it to 1 for the
    trio route.  Returns ``sys_``."""
    cfg, lat = sys_.cfg, sys_.cfg.lattice
    pairs = exchange_pairs(sys_.cluster, nshell)
    cfg.calculation.post_processing = "exchange"
    lat.njij, lat.ijpair = len(pairs), pairs
    lat.njijk = 0
    lat.ijktrio = np.array([[1.0, pairs[1, 1], pairs[2, 1], 0.0, 0.0, 1.0]])
    return sys_


def build_synthetic_exchange(nshell: int = EXCHANGE_SHELLS, **kw):
    """:func:`build_synthetic_bcc` (keywords as there) as an exchange run
    (:func:`synthetic_exchange`)."""
    return synthetic_exchange(build_synthetic_bcc(**kw), nshell)


def _write_input(sys_, where: str, lattice: dict, control: dict,
                 post: str, sd=None) -> str:
    """``input.nml`` of a run of a spherical bcc preset (no ``box``) with
    post-processing ``post``, the ``&lattice`` and ``&control`` entries
    given added, with ``sd`` (the entries of ``&sd``) ``processing='sd'``,
    and its element files, into the directory ``where``; returns the
    input's path."""
    from .scf import SelfConsistency

    cfg = sys_.cfg
    lat, en, ctl = cfg.lattice, cfg.energy, cfg.control
    text = "".join([
        write_namelist("calculation", {
            "pre_processing": cfg.calculation.pre_processing,
            "processing": "none" if sd is None else "sd",
            "post_processing": post}),
        write_namelist("control", {
            "calctype": ctl.calctype, "nsp": ctl.nsp, "lld": ctl.lld,
            "recur": ctl.recur, **control}),
        write_namelist("lattice", {
            "rc": lat.rc, "ndim": lat.ndim, "alat": lat.alat,
            "wav": lat.wav, "crystal_sym": lat.crystal_sym,
            "ntype": lat.ntype, "r2": lat.r2, "ct": [lat.ct[0]],
            **lattice}),
        write_namelist("atoms", {"database": "", "label": cfg.atoms.labels}),
        write_namelist("energy", {
            "channels_ldos": en.channels_ldos, "energy_min": en.energy_min,
            "energy_max": en.energy_max, "fermi": en.fermi}),
        write_namelist("hamiltonian", {"hoh": cfg.hamiltonian.hoh}),
        "" if sd is None else write_namelist("sd", sd),
    ])
    path = os.path.join(where, "input.nml")
    with open(path, "w") as fh:
        fh.write(text)
    SelfConsistency(sys_, workdir=where).save_checkpoints()
    for at in sys_.atoms:
        os.replace(os.path.join(where, f"{at.element.symbol}_out.nml"),
                   os.path.join(where, f"{at.label}.nml"))
    return path


def write_exchange_input(sys_, where: str) -> str:
    """``input.nml`` of the exchange run of a spherical bcc preset
    (:func:`synthetic_exchange`, no ``box``) and its element files, into the
    directory ``where``; returns the input's path."""
    lat = sys_.cfg.lattice
    lattice = {"njij": lat.njij, "ijpair": lat.ijpair}
    if lat.njijk > 0:
        lattice.update(njijk=lat.njijk, ijktrio=lat.ijktrio)
    return _write_input(sys_, where, lattice, {},
                        sys_.cfg.calculation.post_processing)


def write_conductivity_input(sys_, where: str,
                             post: str = "conductivity") -> str:
    """``input.nml`` of a conductivity run (``post_processing`` ``post``:
    ``'conductivity'`` or ``'conductivity_p2rs'``) of a spherical bcc
    preset, with its ``&control`` moments (``cond_ll``), start units
    (``cond_calctype``, ``random_vec_num``) and operators (``linear_in``,
    ``linear_out``), and its element files, into the directory ``where``;
    returns the input's path."""
    ctl = sys_.cfg.control
    return _write_input(sys_, where, {}, {
        "cond_ll": ctl.cond_ll, "cond_calctype": ctl.cond_calctype,
        "random_vec_num": ctl.random_vec_num, "linear_in": ctl.linear_in,
        "linear_out": ctl.linear_out}, post)


def write_input(sys_, where: str, post: str = "none", sd=None) -> str:
    """``input.nml`` of an SCF-driven run of a spherical bcc preset
    (``post_processing`` ``post``: ``'none'``, ``'paoflow2rs'`` or
    ``'orbital_modern'``; with ``sd``, the entries of ``&sd``,
    ``processing='sd'``) and its element files, into the directory
    ``where``; returns the input's path."""
    return _write_input(sys_, where, {}, {}, post, sd)
