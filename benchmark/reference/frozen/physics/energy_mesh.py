"""Energy mesh for LDOS and integrals (reference ``source/energy.f90``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np



def _nint(x: float) -> int:
    """Fortran NINT: round half away from zero."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


@dataclass
class EnergyMesh:
    ene: np.ndarray  # (channels_ldos + 10,)
    edel: float
    fermi: float
    energy_min: float
    energy_max: float
    channels_ldos: int
    nv1: int
    enpt: int
    fix_fermi: bool = False
    chebfermi: float = 0.0

    @property
    def npts(self) -> int:
        return self.channels_ldos + 10

    @classmethod
    def build(cls, cfg, fermi: float = None) -> "EnergyMesh":
        """``e_mesh`` :174-208: even channel count, edel snapped so the Fermi
        level lands on a grid point."""
        fermi = cfg.fermi if fermi is None else fermi
        channels = cfg.channels_ldos
        if channels % 2 == 0:
            nv1 = channels + 1
        else:
            nv1 = channels
            channels = channels - 1
        edel = (cfg.energy_max - cfg.energy_min) / channels
        enpt = _nint((fermi - cfg.energy_min) / edel)
        edel = (fermi - cfg.energy_min) / enpt
        ene = cfg.energy_min + edel * np.arange(channels + 10, dtype=np.float64)
        return cls(
            ene=ene,
            edel=edel,
            fermi=fermi,
            energy_min=cfg.energy_min,
            energy_max=cfg.energy_max,
            channels_ldos=channels,
            nv1=nv1,
            enpt=enpt,
            fix_fermi=cfg.fix_fermi,
            chebfermi=fermi,
        )
