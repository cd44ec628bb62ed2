"""Per-species potential parameters and representations.

Mirrors the reference ``source/potential.f90`` (type :41-99, defaults
:300-410, file loading :199-295) and the two key transforms of
``source/symbolic_atom.f90``:

* :meth:`Potential.build_pot` — expand the (s,p,d) tight-binding band
  parameters to 9-orbital spin-average/difference arrays used by the
  Hamiltonian assembly (``build_pot`` :163-195),
* :meth:`Potential.predls` — transform orthogonal-representation potential
  parameters (C, sqrt(delta), q) to the tight-binding representation
  (``predls`` :205-239, with the canonical screening ``qm_canonical``).

Energies are in Rydberg, lengths in Bohr unless noted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


#: canonical screening constants used by predls (math.f90 qm_canonical)
QM_CANONICAL = np.array([0.348485, 0.053030, 0.010714])

#: l quantum number per spd orbital (cubic or spherical order, same l counts)
L_OF_ORB = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])


@dataclass
class Element:
    """Element identity (reference ``source/element.f90``)."""

    symbol: str = ""
    atomic_number: float = 0.0
    core: float = 0.0
    valence: float = 0.0
    f_core: int = 0
    num_quant_s: int = 0
    num_quant_p: int = 0
    num_quant_d: int = 0


class Potential:
    """Potential parameter state for one species (lmax=2, spd)."""

    def __init__(self, lmax: int = 2):
        self.lmax = lmax
        nl = lmax + 1
        # tight-binding representation band parameters, shape (lmax+1, 2)
        self.center_band = np.zeros((nl, 2))
        self.width_band = np.zeros((nl, 2))
        self.shifted_band = np.zeros((nl, 2))
        self.obar = np.zeros((nl, 2))
        self.gravity_center = np.zeros((nl, 2))
        # moments: ql(3, 0:lmax, 2) and log-derivative pl(0:lmax, 2)
        self.ql = np.zeros((3, nl, 2))
        self.pl = np.zeros((nl, 2))
        # orthogonal representation parameters (0:lmax, 2)
        self.c = np.zeros((nl, 2))
        self.enu = np.zeros((nl, 2))
        self.ppar = np.zeros((nl, 2))
        self.qpar = np.zeros((nl, 2))
        self.srdel = np.zeros((nl, 2))
        self.vl = np.zeros((nl, 2))
        self.pnu = np.zeros((nl, 2))
        self.qi = np.zeros((nl, 2))
        self.dele = np.zeros((nl, 2))
        # energies / radii
        self.ws_r = 0.0
        self.sumec = 0.0
        self.sumev = 0.0
        self.etot = 0.0
        self.utot = 0.0
        self.ekin = 0.0
        self.rhoeps = 0.0
        self.vmad = 0.0
        # magnetic state
        self.mom = np.array([0.0, 0.0, 1.0])
        self.lmom = np.zeros(3)
        self.mom0 = np.zeros(3)
        self.mom1 = np.zeros(3)
        self.mtot = 0.0
        # hyperfine contact fields [H_core, H_val] in Tesla
        self.hyper_field = np.zeros(2)
        # SOC strengths
        self.xi_p = np.zeros(2)
        self.xi_d = np.zeros(2)
        self.rac = np.zeros(2)
        # band-shift/renormalisation used in LDOS reconstruction
        self.cshi = np.zeros(18)
        self.dw_l = np.ones(18)
        # 9-orbital expanded parameters (complex; built by build_pot)
        self.cx = np.zeros((9, 2), dtype=np.complex128)
        self.wx = np.zeros((9, 2), dtype=np.complex128)
        self.cex = np.zeros((9, 2), dtype=np.complex128)
        self.obx = np.zeros((9, 2), dtype=np.complex128)
        self.cx0 = np.zeros(9, dtype=np.complex128)
        self.cx1 = np.zeros(9, dtype=np.complex128)
        self.wx0 = np.zeros(9, dtype=np.complex128)
        self.wx1 = np.zeros(9, dtype=np.complex128)
        self.cex0 = np.zeros(9, dtype=np.complex128)
        self.cex1 = np.zeros(9, dtype=np.complex128)
        self.obx0 = np.zeros(9, dtype=np.complex128)
        self.obx1 = np.zeros(9, dtype=np.complex128)

    # ----------------------------------------------------------- build_pot
    def build_pot(self) -> None:
        """Expand (s,p,d) band parameters to 9 orbitals and form the
        spin-average (x0) / spin-difference (x1) combinations."""
        for arr9, arr3 in (
            (self.cx, self.center_band),
            (self.wx, self.width_band),
            (self.cex, self.shifted_band),
            (self.obx, self.obar),
        ):
            arr9[0, :] = arr3[0, :]
            arr9[1:4, :] = arr3[1, :]
            arr9[4:9, :] = arr3[2, :]
        self.cx0 = 0.5 * (self.cx[:, 0] + self.cx[:, 1])
        self.cx1 = 0.5 * (self.cx[:, 0] - self.cx[:, 1])
        self.wx0 = 0.5 * (self.wx[:, 0] + self.wx[:, 1])
        self.wx1 = 0.5 * (self.wx[:, 0] - self.wx[:, 1])
        self.cex0 = 0.5 * (self.cex[:, 0] + self.cex[:, 1])
        self.cex1 = 0.5 * (self.cex[:, 0] - self.cex[:, 1])
        self.obx0 = 0.5 * (self.obx[:, 0] + self.obx[:, 1])
        self.obx1 = 0.5 * (self.obx[:, 0] - self.obx[:, 1])

    # -------------------------------------------------------------- predls
    def predls(self, wsm: float) -> None:
        """Orthogonal -> tight-binding representation transform.

        ``wsm`` is the global average Wigner-Seitz radius in Bohr
        (the reference passes ``lattice%wav * ang2au``).
        """
        wow = wsm / self.ws_r
        nl = self.lmax + 1
        ii = np.arange(1, nl + 1)[:, None]  # Fortran I = 1..lmax+1
        qm = QM_CANONICAL[:nl, None]
        dele = self.srdel * wow ** (0.5 - ii)
        qi = self.qpar * wow ** (1 - 2 * ii)
        cme = self.c - self.enu
        x = 1.0 - (qi - qm) * cme / (dele * dele)
        y = (qi - qm) / ((cme * (qi - qm)) - dele * dele)
        self.center_band = cme * x + self.enu + self.vmad
        self.shifted_band = cme * x
        self.width_band = dele * x
        self.obar = y
        self.qi = qi
        self.dele = dele

    # ----------------------------------------------------- LKAG d-matrix
    def d_matrix(self, e: float) -> np.ndarray:
        """LKAG exchange Delta_l(E) 9x9 diagonal matrix
        (symbolic_atom.f90 ``d_matrix`` :241-263)."""
        cu = self.c[:, 0] + self.vmad
        cd = self.c[:, 1] + self.vmad
        wu = self.dele[:, 0]
        wd = self.dele[:, 1]
        wuwd = wu * wd
        wu2 = wu * wu
        wd2 = wd * wd
        de = (cd * wu2 - cu * wd2 + (wd2 - wu2) * e) / wuwd
        return np.diag(de[L_OF_ORB]).astype(np.complex128)


@dataclass
class SymbolicAtom:
    """Element + potential pair for one inequivalent species
    (reference ``source/symbolic_atom.f90``)."""

    element: Element
    potential: Potential
    label: str = ""
    source_file: str = ""

