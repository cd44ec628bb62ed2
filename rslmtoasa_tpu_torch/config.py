"""Typed configuration mirroring the reference namelist groups.

Each dataclass carries the defaults of the corresponding Fortran
``restore_to_default`` routine and knows how to update itself from a parsed
:class:`~rslmtoasa_tpu.utils.namelist.Namelists`:

* ``&calculation``  — reference ``source/calculation.f90:175-211``
* ``&lattice``      — ``source/lattice.f90`` (``restore_to_default`` :920-980)
* ``&atoms``        — ``source/lattice.f90 atomlist`` / ``source/element.f90``
* ``&self``         — ``source/self.f90 restore_to_default``
* ``&energy``       — ``source/energy.f90:149-172``
* ``&control``      — ``source/control.f90:352-385``
* ``&mix``          — ``source/mix.f90``
* ``&hamiltonian``  — ``source/hamiltonian.f90`` namelist include
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from .utils.namelist import Namelists, read_namelists


def _get(nml: Namelists, group: str, key: str, default):
    g = nml.get(group)
    if g is None:
        return default
    v = g.get_scalar(key, default)
    return v


@dataclass
class CalculationCfg:
    pre_processing: str = "none"
    processing: str = "none"
    post_processing: str = "none"
    verbose: bool = False

    @classmethod
    def from_namelists(cls, nml: Namelists) -> "CalculationCfg":
        return cls(
            pre_processing=_get(nml, "calculation", "pre_processing", "none"),
            processing=_get(nml, "calculation", "processing", "none"),
            post_processing=_get(nml, "calculation", "post_processing", "none"),
            verbose=bool(_get(nml, "calculation", "verbose", False)),
        )


@dataclass
class ControlCfg:
    """Global knobs (reference ``source/control.f90``)."""

    calctype: str = "B"  # B bulk, S surface, I impurity
    nsp: int = 1  # 1 scalar, 2 +SOC, 3 noncollinear, 4 nc+SOC
    lld: int = 16
    llsp: int = 16
    npold: int = 9
    recur: str = "block"
    terminator: int = 5
    txc: int = 1
    nmdir: int = 1  # number of magnetisation directions (1 or 3)
    lrot: bool = False
    incorb: bool = False
    svac: bool = False
    blockrec: bool = False
    do_asd: bool = False
    asd_jij: bool = False
    hyperfine: bool = False
    sym_term: bool = False
    random_vec_num: int = 1
    cond_ll: int = 200
    linear_in: str = "charge"
    linear_out: str = "charge"
    cond_calctype: str = "per_type"
    #: legacy selector kept by older reference versions (the committed
    #: conductivity inputs still carry it; the modern reference ignores
    #: it, but the stored fccPt references were GENERATED with the
    #: legacy 'spin' branch active — see models/conductivity.run)
    cond_type: str = "charge"
    fname: str = ""

    @classmethod
    def from_namelists(cls, nml: Namelists, fname: str = "") -> "ControlCfg":
        c = cls(fname=fname)
        g = nml.get("control")
        if g is None:
            return c
        for k in (
            "calctype nsp lld llsp npold recur terminator txc nmdir lrot incorb "
            "svac blockrec do_asd asd_jij hyperfine sym_term random_vec_num "
            "cond_ll linear_in linear_out cond_calctype cond_type"
        ).split():
            if g.has(k):
                setattr(c, k, g.get_scalar(k, getattr(c, k)))
        # nmdir follows nsp=3 (collinear 3-direction averaging) unless given
        if not g.has("nmdir"):
            c.nmdir = 3 if c.nsp == 3 else 1
        return c


@dataclass
class LatticeCfg:
    """Geometry inputs (reference ``&lattice``)."""

    ndim: int = 9_900_000
    npe: int = 49
    rc: float = 0.0
    r2: float = 0.0
    alat: float = 0.0
    celldm: float = 0.0
    wav: float = 0.0
    crystal_sym: str = "bcc"
    ntype: int = 0
    nbas: int = 0
    nrec: int = 1
    ct: np.ndarray = field(default_factory=lambda: np.zeros(50))
    surftype: str = "none"
    nlay: int = 0
    nclu: int = 0
    pbc: bool = False
    b1: bool = False
    b2: bool = False
    b3: bool = False
    n1: int = 0
    n2: int = 0
    n3: int = 0
    njij: int = 0
    ijpair: Optional[np.ndarray] = None
    njijk: int = 0
    ijktrio: Optional[np.ndarray] = None  # (njijk, 6): i j k dx dy dz
    # explicit basis for crystal_sym='file'
    a: Optional[np.ndarray] = None  # (3,3) columns are primitive vectors
    crd: Optional[np.ndarray] = None  # (3, nbas)
    izp: Optional[np.ndarray] = None
    no: Optional[np.ndarray] = None
    izpsurf: Optional[np.ndarray] = None
    inclu: Optional[np.ndarray] = None
    #: export clust/map/sbar/str.out/mad.mat geometry artifacts for
    #: reference-tooling interop (lattice.f90:1819+, charge.f90:1823)
    write_artifacts: bool = False

    @classmethod
    def from_namelists(cls, nml: Namelists) -> "LatticeCfg":
        c = cls()
        g = nml.get("lattice")
        if g is None:
            return c
        for k in (
            "ndim npe rc r2 alat celldm wav crystal_sym ntype nbas nrec surftype "
            "nlay nclu pbc b1 b2 b3 n1 n2 n3 njij njijk write_artifacts"
        ).split():
            if g.has(k):
                setattr(c, k, g.get_scalar(k, getattr(c, k)))
        ct = np.zeros(50)
        g.fill_array("ct", ct)
        c.ct = ct
        if g.has("njij") and c.njij > 0:
            ij = np.zeros((c.njij, 2), dtype=np.int64)
            g.fill_array("ijpair", ij)
            c.ijpair = ij
        if g.has("njijk") and c.njijk > 0:
            tr = np.zeros((c.njijk, 6))
            g.fill_array("ijktrio", tr)
            c.ijktrio = tr
        if g.has("nclu") and c.nclu > 0:
            inc = np.zeros((c.nclu, 3))
            g.fill_array("inclu", inc)
            c.inclu = inc
        if g.has("a"):
            a = np.zeros((3, 3))
            g.fill_array("a", a)
            c.a = a
        if g.has("crd"):
            nb = max(c.nbas, c.ntype, 1)
            crd = np.zeros((3, nb))
            g.fill_array("crd", crd)
            c.crd = crd
        return c


@dataclass
class AtomsCfg:
    database: str = "./"
    labels: List[str] = field(default_factory=list)

    @classmethod
    def from_namelists(cls, nml: Namelists, ntype: int) -> "AtomsCfg":
        c = cls()
        g = nml.get("atoms")
        if g is None:
            return c
        c.database = g.get_scalar("database", "./")
        labels = np.empty(max(ntype, 64), dtype=object)
        labels[:] = ""
        g.fill_array("label", labels)
        c.labels = [str(x) for x in labels if x]
        return c


@dataclass
class SelfCfg:
    """SCF loop parameters (reference ``source/self.f90``)."""

    ws_all: bool = True
    mix_all: bool = True
    magnetic_mixing: bool = False
    mixmag_all: bool = True
    conv_thr: float = 0.5e-8
    nstep: int = 1
    freeze: bool = False
    rigid_band: bool = False
    orbital_polarization: bool = False
    ws_max: float = 9.99
    cold: bool = False
    init: Optional[str] = None

    @classmethod
    def from_namelists(cls, nml: Namelists) -> "SelfCfg":
        c = cls()
        g = nml.get("self")
        if g is None:
            return c
        for k in (
            "ws_all mix_all magnetic_mixing mixmag_all conv_thr nstep freeze "
            "rigid_band orbital_polarization ws_max cold init"
        ).split():
            if g.has(k):
                setattr(c, k, g.get_scalar(k, getattr(c, k)))
        return c


@dataclass
class EnergyCfg:
    """Energy-mesh parameters (reference ``source/energy.f90:149-208``)."""

    channels_ldos: int = 6000
    energy_min: float = -5.5
    energy_max: float = 5.5
    fermi: float = -0.05
    fix_fermi: bool = False

    @classmethod
    def from_namelists(cls, nml: Namelists, calctype: str = "B") -> "EnergyCfg":
        if calctype == "B":
            c = cls(6000, -5.5, 5.5, -0.05, False)
        elif calctype == "I":
            c = cls(3000, -1.5, 0.5, -0.05, True)
        else:  # 'S'
            c = cls(6000, -1.5, 0.5, -0.05, True)
        g = nml.get("energy")
        if g is None:
            return c
        for k in "channels_ldos energy_min energy_max fermi fix_fermi".split():
            if g.has(k):
                setattr(c, k, g.get_scalar(k, getattr(c, k)))
        return c


@dataclass
class MixCfg:
    beta: float = 0.01
    mixtype: str = "broyden"
    magbeta: float = 0.05

    @classmethod
    def from_namelists(cls, nml: Namelists) -> "MixCfg":
        c = cls()
        g = nml.get("mix")
        if g is None:
            return c
        for k in "beta mixtype magbeta".split():
            if g.has(k):
                setattr(c, k, g.get_scalar(k, getattr(c, k)))
        return c


@dataclass
class HamiltonianCfg:
    hoh: bool = False
    local_axis: bool = False
    orb_pol: bool = False

    @classmethod
    def from_namelists(cls, nml: Namelists) -> "HamiltonianCfg":
        c = cls()
        g = nml.get("hamiltonian")
        if g is None:
            return c
        for k in "hoh local_axis orb_pol".split():
            if g.has(k):
                setattr(c, k, g.get_scalar(k, getattr(c, k)))
        return c


@dataclass
class JobConfig:
    """Everything parsed from one input file (plus the file's own namelists
    for element/parameter groups embedded in it)."""

    calculation: CalculationCfg
    control: ControlCfg
    lattice: LatticeCfg
    atoms: AtomsCfg
    scf: SelfCfg
    energy: EnergyCfg
    mix: MixCfg
    hamiltonian: HamiltonianCfg
    namelists: Namelists
    fname: str = ""

    @classmethod
    def from_file(cls, path: str) -> "JobConfig":
        nml = read_namelists(path)
        return cls.from_namelists(nml, fname=path)

    @classmethod
    def from_namelists(cls, nml: Namelists, fname: str = "") -> "JobConfig":
        control = ControlCfg.from_namelists(nml, fname=fname)
        lattice = LatticeCfg.from_namelists(nml)
        return cls(
            calculation=CalculationCfg.from_namelists(nml),
            control=control,
            lattice=lattice,
            atoms=AtomsCfg.from_namelists(nml, lattice.ntype),
            scf=SelfCfg.from_namelists(nml),
            energy=EnergyCfg.from_namelists(nml, control.calctype or "B"),
            mix=MixCfg.from_namelists(nml),
            hamiltonian=HamiltonianCfg.from_namelists(nml),
            namelists=nml,
            fname=fname,
        )
