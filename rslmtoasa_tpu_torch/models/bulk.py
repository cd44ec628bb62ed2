"""Calculation pipeline: geometry -> Hamiltonian -> recursion -> LDOS.

Mirrors the reference's ``pre_processing`` setups (``calculation.f90``
``bravais`` :550-623, ``buildsurf`` and ``newclubulk``) followed by the
recursion pieces of ``self%run`` (``self.f90`` :676-764): scalar Haydock
(bulk only), block Lanczos and Chebyshev.  Geometry, structure constants
and the Hamiltonian are built on the host (NumPy); the recursion runs on
``device`` through the Haydock kernels (K1'-K3') or the block step (K4).  An impurity's recursion runs on the
combined row table ``[hall; ee]``: one row per local-zone atom, then one
per species (``HamiltonianBlocks.blocks``, ``iz_eff``), with the species
as the onsite index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..atoms.potential import SymbolicAtom
from ..config import JobConfig
from ..geometry import (
    bravais_cluster,
    build_surf_full,
    neighbor_map,
    newclu,
    primitive_cell,
    sbar_for_cluster,
)
from ..ops.block_lanczos import (
    BlockOperator,
    block_lanczos,
    block_start_vectors,
)
from ..ops.lanczos import scalar_start_vectors
from ..ops.ldos import orbital_density
from ..parallel.dispatch import (
    block_lanczos_auto,
    chebyshev_moments_auto,
    lanczos_auto,
)
from ..physics.energy_mesh import EnergyMesh
from ..physics.hamiltonian import HamiltonianBlocks, build_bulkham
from ..physics.harmonics import rotmag_loc
from ..utils.device import resolve_device
from ..utils.logger import g_logger
from ..utils.timer import g_timer


# where the reference's behaviour is in question (ROADMAP.md queue 3):
# the scalar Haydock path on a surface or an impurity cluster, and an
# impurity in a slab
SCALAR_EMBEDDED = ("ROADMAP queue 3, 'the scalar path on surface and "
                   "impurity clusters'")
NEWCLUSURF = "ROADMAP queue 3, 'an impurity in a slab (newclusurf)'"


def refuse_scalar_embedded(calctype: str):
    """Raise for the scalar recursion on a surface or impurity cluster."""
    if calctype in ("S", "I"):
        raise NotImplementedError(
            f"recur='lanczos' with calctype={calctype!r}: run "
            f"recur='block' or 'chebyshev'; the scalar path is "
            f"{SCALAR_EMBEDDED}")


@dataclass
class BulkSystem:
    cfg: JobConfig
    workdir: str = "."
    cluster: object = None
    atoms: List[SymbolicAtom] = field(default_factory=list)
    sbars: Optional[list] = None
    sbarvecs: Optional[list] = None
    ham: Optional[HamiltonianBlocks] = None
    emesh: Optional[EnergyMesh] = None
    # None means the card: resolve_device("cuda") raises without one;
    # a caller that wants the CPU passes it
    device: Optional[torch.device] = None
    # run the recursions through the kernels' plain versions (on any
    # device): the reference a card run is checked against
    plain: bool = False
    # keep ``ham`` as it is (a PAOFLOW-imported Hamiltonian)
    freeze_ham: bool = False

    def __post_init__(self):
        self.device = resolve_device(
            "cuda" if self.device is None else self.device)

    @classmethod
    def build(cls, cfg: JobConfig, workdir: str = ".", device="cuda",
              atoms: Optional[List[SymbolicAtom]] = None) -> "BulkSystem":
        """Geometry, structure constants and species of ``cfg``; the
        species from the element files unless ``atoms`` gives them."""
        if (cfg.calculation.pre_processing or "").strip() == "newclusurf":
            raise NotImplementedError(
                f"pre_processing='newclusurf': {NEWCLUSURF}")
        sys = cls(cfg=cfg, workdir=workdir, device=device)
        lat = cfg.lattice
        # historical defaults when &lattice omits ct / r2 (the reference's
        # commented-out build_data fallback ct = alat + 0.1, r2 = ct^2 —
        # inputs like example/exchange/bccFe rely on them)
        if lat.ct[0] == 0.0:
            lat.ct[:] = lat.alat + 0.1
        if lat.r2 == 0.0:
            lat.r2 = float(lat.ct[0]) ** 2
        with g_timer.section("geometry"):
            # crystal_sym='file' reads the general user cell from a
            # lattice.nml sidecar next to the input file (build_data
            # 'file' branch, lattice.f90:925 -> build_from_lattice :660)
            lattice_file = os.path.join(
                os.path.dirname(os.path.abspath(cfg.control.fname or ".")),
                "lattice.nml")
            cell = primitive_cell(lat.crystal_sym, lat.celldm,
                                  lattice_file=lattice_file)
            cl = bravais_cluster(
                cell,
                alat=lat.alat,
                rc=lat.rc,
                ndim=lat.ndim,
                npe=lat.npe,
                wav=lat.wav,
                calctype=cfg.control.calctype,
                pbc=bool(lat.pbc),
                pbc_dims=(lat.n1, lat.n2, lat.n3),
                pbc_wrap=(bool(lat.b1), bool(lat.b2), bool(lat.b3)),
            )
            cl._ct1 = float(lat.ct[0])
            if cell.iu is not None and cfg.control.calctype == "B":
                # bookkeeping straight from the user lattice.nml
                cl.iu = cell.iu.copy()
                cl.ib = cell.ib.copy()
                cl.irec = cell.irec.copy()
                cl.nrec = cell.nrec
                cl.atlist = np.concatenate([cl.ib, cl.irec]) \
                    if cl.nbulk else cl.irec.copy()
                cl.ntype = max(cl.ntype, int(cl.iz.max()))
            if cfg.control.calctype == "I":
                cl = newclu(cl, lat.inclu, cell.ntot)
            elif cfg.control.calctype == "S":
                cl = build_surf_full(cl, lat.surftype, int(lat.nlay),
                                     cell.ntot)
            neighbor_map(cl, ct1=float(lat.ct[0]))
        g_logger.info(
            f"cluster built: kk={cl.kk}, nnmax={cl.nn.shape[1]}, "
            f"ntype={cl.ntype}"
        )
        with g_timer.section("structure-constants"):
            sys.sbars, sys.sbarvecs = sbar_for_cluster(
                cl.cr_ang, cl.iu, cl.wav, lat.r2
            )
        sys.cluster = cl
        with g_timer.section("element-db"):
            sys.atoms = list(atoms) if atoms is not None else [
                SymbolicAtom.from_file(label, cfg.atoms.database or workdir)
                for label in cfg.atoms.labels]
        sys.emesh = EnergyMesh.build(cfg.energy)
        return sys

    # ------------------------------------------------------------------
    def build_hamiltonian(self) -> HamiltonianBlocks:
        """``run_recursion`` setup part: build_pot + build_bulkham.

        When ``freeze_ham`` is set (PAOFLOW-imported Hamiltonians), the
        existing blocks are kept as they are."""
        if self.freeze_ham and self.ham is not None:
            return self.ham
        for at in self.atoms:
            at.potential.build_pot()
        with g_timer.section("build-bulkham"):
            self.ham = build_bulkham(
                self.cluster,
                self.atoms,
                self.sbars,
                self.sbarvecs,
                hoh=self.cfg.hamiltonian.hoh,
                with_soc=self.cfg.control.nsp in (2, 4),
            )
        return self.ham

    # ------------------------------------------------------------------
    def run_lanczos(self):
        """Scalar Haydock recursion for all rec atoms (nsp=1 path).

        Returns (a, b2) with shape (lld, 18, nrec): per-orbital chains in the
        reference's ordering (9 up-spin then 9 down-spin orbitals).
        """
        refuse_scalar_embedded(self.cfg.control.calctype)
        cl = self.cluster
        hb = self.ham
        lld = self.cfg.control.lld
        rec_atoms = [int(j) - 1 for j in cl.irec]
        with g_timer.section("recursion"):
            psi0 = scalar_start_vectors(cl.kk, rec_atoms, self.device)
            a_list = []
            b_list = []
            for s in (0, 1):  # spin channels are decoupled for nsp=1
                blk = hb.ee[:, :, 9 * s : 9 * (s + 1), 9 * s : 9 * (s + 1)]
                a, b2 = lanczos_auto(blk, hb.iz, hb.cols, psi0, lld,
                                     plain=self.plain)
                a_list.append(a)
                b_list.append(b2)
        nrec = len(rec_atoms)
        # chains are laid out c = atom*9 + orbital; merge spins -> 18
        a = np.zeros((lld, 18, nrec))
        b2 = np.zeros((lld, 18, nrec))
        for ia in range(nrec):
            a[:, 0:9, ia] = a_list[0][:, ia * 9 : (ia + 1) * 9]
            a[:, 9:18, ia] = a_list[1][:, ia * 9 : (ia + 1) * 9]
            b2[:, 0:9, ia] = b_list[0][:, ia * 9 : (ia + 1) * 9]
            b2[:, 9:18, ia] = b_list[1][:, ia * 9 : (ia + 1) * 9]
        return a, b2

    # ------------------------------------------------------------------
    def _cached_psi0(self, kk: int, rec_atoms):
        """Identity start blocks on ``self.device``, reused across SCF
        iterations (only the Hamiltonian changes per iteration)."""
        key = (kk, tuple(rec_atoms), self.device)
        cached = getattr(self, "_psi0_block", None)
        if cached is None or cached[0] != key:
            self._psi0_block = (key, block_start_vectors(kk, rec_atoms,
                                                         self.device))
        return self._psi0_block[1]

    # ------------------------------------------------------------------
    def _lsham(self) -> np.ndarray:
        hb = self.ham
        if hb.lsham is not None:
            return hb.lsham
        return np.zeros((hb.ee.shape[0], 18, 18), dtype=np.complex128)

    # ------------------------------------------------------------------
    def _spmv_tables(self):
        """Block-row tables of the recursion: the combined ``[hall; ee]``
        rows with per-atom row indices in an impurity's local zone, the
        per-type rows otherwise.  Returns (blocks, blocks_o, iz_rows,
        iz_species, nmax): ``iz_species`` indexes the onsite tables and
        the first ``nmax`` rows of ``blocks`` are per-atom."""
        hb = self.ham
        if hb.blocks is not None:
            return hb.blocks, hb.blocks_o, hb.iz_eff, hb.iz, self.cluster.nmax
        return hb.ee, hb.eeo, hb.iz, hb.iz, 0

    # ------------------------------------------------------------------
    def run_block(self):
        """Block-Lanczos recursion (``recur_b``) for all rec atoms on
        ``self.device``.

        Returns host (a_b, b2_b) of shape (lld, nrec, 18, 18).
        """
        cl = self.cluster
        hb = self.ham
        lld = self.cfg.control.lld
        hoh = self.cfg.hamiltonian.hoh
        rec_atoms = [int(j) - 1 for j in cl.irec]
        lsham = self._lsham()
        blocks, blocks_o, iz_rows, iz_sp, nmax = self._spmv_tables()
        with g_timer.section("block-recursion"):
            if self.cfg.hamiltonian.local_axis:
                # rotate the full Hamiltonian to each rec atom's moment
                # frame before its recursion (recursion.f90 recur_b
                # :1830-1833 + hamiltonian rotate_to_local_axis
                # :2442-2462); one atom at a time, at the full width, as
                # the reference's serial loop
                a_parts, b_parts = [], []
                for ja in rec_atoms:
                    mom = self.atoms[int(cl.iz[ja]) - 1].potential.mom
                    op = BlockOperator(
                        rotmag_loc(blocks, mom), iz_rows, hb.cols,
                        rotmag_loc(lsham, mom), iz_onsite=iz_sp, hoh=hoh,
                        hso=rotmag_loc(blocks_o, mom) if hoh else None,
                        enim=rotmag_loc(hb.enim, mom) if hoh else None,
                        nmax=nmax,
                    ).to(self.device)
                    psi0 = block_start_vectors(cl.kk, [ja], self.device)
                    a_b, b2_b = block_lanczos(op, psi0, lld,
                                              plain=self.plain)
                    a_parts.append(a_b.cpu().numpy())
                    b_parts.append(b2_b.cpu().numpy())
                return (np.concatenate(a_parts, axis=1),
                        np.concatenate(b_parts, axis=1))
            psi0 = self._cached_psi0(cl.kk, rec_atoms)
            return block_lanczos_auto(
                blocks, lsham, iz_rows, hb.cols, psi0, lld, hoh=hoh,
                hso=blocks_o if hoh else None,
                enim=hb.enim if hoh else None, iz_onsite=iz_sp, nmax=nmax,
                plain=self.plain)

    # ------------------------------------------------------------------
    def run_chebyshev(self, emesh):
        """Block Chebyshev/KPM moments (``chebyshev_recur``) for all rec
        atoms on ``self.device``.

        Returns host mu of shape (2*lld+2, nrec, 18, 18).
        """
        cl = self.cluster
        hb = self.ham
        lld = self.cfg.control.lld
        hoh = self.cfg.hamiltonian.hoh
        rec_atoms = [int(j) - 1 for j in cl.irec]
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0
        blocks, blocks_o, iz_rows, iz_sp, nmax = self._spmv_tables()
        psi0 = self._cached_psi0(cl.kk, rec_atoms)
        with g_timer.section("chebyshev-recursion"):
            return chebyshev_moments_auto(
                blocks, self._lsham(), iz_rows, hb.cols, psi0, lld, a, b,
                hoh=hoh, hso=blocks_o if hoh else None,
                enim=hb.enim if hoh else None, iz_onsite=iz_sp, nmax=nmax,
                plain=self.plain)

    # ------------------------------------------------------------------
    def ldos(self, a: np.ndarray, b2: np.ndarray):
        """Per-atom per-orbital LDOS on the energy mesh (``dos%density``).

        Returns tdens of shape (nrec, 18, npts).
        """
        em = self.emesh
        nrec = a.shape[2]
        out = np.zeros((nrec, 18, em.npts))
        with g_timer.section("ldos"):
            for ia in range(nrec):
                pot = self.atoms[int(self.cluster.iz[ia]) - 1].potential
                tdens, _, _ = orbital_density(
                    a[:, :, ia], b2[:, :, ia], em.ene, pot.dw_l, pot.cshi
                )
                out[ia] = tdens
        return out
