"""Atomistic spin dynamics with SCF-recomputed effective fields.

Port of ``rslmtoasa_tpu/models/spin_dynamics.py`` (the reference
``processing='sd'`` loop, ``spin_dynamics.f90 sd_run`` :410-457): each
time step runs the port's full :class:`~.scf.SelfConsistency` (its
recursion on the system's device, K4 for the block and Chebyshev paths),
takes the magnetic force on every moment (:func:`~.scf.magnetic_torques`,
``bands.f90 calculate_magnetic_torques`` :1280-1340: the d-channel
longitudinal field I = pref_0 m^(0) - pref_1 m^(1) from the spin-split
potential parameters), advances the moments with the LLG Euler predictor
(``asd_pred_euler`` :353-380) or the Depondt-Mertens rotation integrator
(``abspinlib/depondt.f90``), and streams a LAMMPS trajectory.  The moment
update is host NumPy, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.logger import g_logger
from .bulk import BulkSystem
from .scf import SelfConsistency, magnetic_torques

GAMA = 1.76e11  # gyromagnetic ratio (abspinlib Constants)
K_BOLT = 1.380649e-23
MUB = 9.274009994e-24


@dataclass
class SDParams:
    dt: float = 1.0e-16
    alpha: float = 0.05
    asd_step: int = 10
    sd_temp: float = 0.0
    integrator: str = "euler"
    sd_seed: int = 1234
    i_cons: int = 0  # 0 off, 2/3 Lagrange (constrain.f90 :80-93)
    lambda_t: float = 1.0

    @classmethod
    def from_namelists(cls, nml) -> "SDParams":
        p = cls()
        g = nml.get("sd")
        if g is None:
            return p
        for k in "dt alpha asd_step sd_temp integrator sd_seed i_cons " \
                 "lambda_t".split():
            if g.has(k):
                setattr(p, k, g.get_scalar(k, getattr(p, k)))
        return p


class MTGaussian:
    """Self-reproducible thermal-field RNG: MT19937 stream + the
    Marsaglia polar gasdev (same construction as the reference's
    ``abspinlib/randomnumbers.f90`` ``gasdev`` :214-256 over ``mtprng``
    MT19937 state).  Same seed -> the JAX package's stream bit for bit;
    the double stream differs from the Fortran ``mtprng`` one."""

    def __init__(self, seed: int = 1234):
        self._bits = np.random.Generator(np.random.MT19937(seed))
        self._spare = None

    def standard_normal(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        out = np.empty(n)
        i = 0
        if self._spare is not None:
            out[0] = self._spare
            self._spare = None
            i = 1
        while i < n:
            v1 = 2.0 * self._bits.random() - 1.0
            v2 = 2.0 * self._bits.random() - 1.0
            rsq = v1 * v1 + v2 * v2
            if rsq >= 1.0 or rsq == 0.0:
                continue  # gasdev rejection loop
            fac = np.sqrt(-2.0 * np.log(rsq) / rsq)
            out[i] = v1 * fac
            i += 1
            if i < n:
                out[i] = v2 * fac
                i += 1
            else:
                self._spare = v2 * fac
        return out.reshape(shape)


def constrain_field(mom_in: np.ndarray, mom_ref: np.ndarray,
                    bfield: np.ndarray, lambda_t: float = 1.0,
                    i_cons: int = 3) -> np.ndarray:
    """Constrained-moment Lagrange field (``abspinlib/constrain.f90
    constrain`` :56-120, i_cons 2/3): penalise deviation of each moment
    direction from its reference; mode 3 orthogonalises the penalty to
    the reference (b perpendicular to m).  Returns the corrected field;
    arrays are (3, N)."""
    e_in = mom_in / np.linalg.norm(mom_in, axis=0, keepdims=True)
    e_ref = mom_ref / np.linalg.norm(mom_ref, axis=0, keepdims=True)
    delta = e_in - e_ref
    if i_cons == 3:
        delta = delta - (delta * e_ref).sum(axis=0, keepdims=True) * e_ref
    return bfield - 2.0 * lambda_t * delta


def _rotate(bdup, emom, dt, lam):
    """Rotate ``emom`` about ``bdup`` by |bdup| dt GAMA / (1 + lam^2)."""
    lldamp = 1.0 / (1.0 + lam**2)
    bnorm = np.linalg.norm(bdup, axis=0) + 1.0e-15
    h = bdup / bnorm
    v = bnorm * dt * GAMA * lldamp
    cosv = np.cos(v)
    sinv = np.sin(v)
    u = 1.0 - cosv
    e = emom
    he = (h * e).sum(axis=0)
    e_new = (e * cosv[None, :]
             + h * (he * u)[None, :]
             + np.cross(h.T, e.T).T * sinv[None, :])
    e_new /= np.linalg.norm(e_new, axis=0)[None, :]
    return e_new


def depondt_evolve_first(lam, beff, emom, mmom, dt, temp, rng):
    """Depondt-Mertens predictor rotation (depondt.f90 :25-165).

    Returns (emom_new, b2eff, btherm).  All arrays (3, N).
    """
    n = emom.shape[1]
    btherm = rng.standard_normal((3, n))
    dp = (2.0 * lam * K_BOLT) / (dt * GAMA * MUB)
    sigma = np.sqrt(dp * temp / mmom)
    btherm = btherm * sigma[None, :]
    bloc = beff + btherm
    # transverse damping term: b + lam * (e x b)
    bdup = bloc + lam * np.cross(emom.T, bloc.T).T
    return _rotate(bdup, emom, dt, lam), bdup, btherm


def depondt_evolve_second(lam, beff, b2eff, emom, dt):
    """Corrector rotation with the averaged field (depondt.f90 :169-265)."""
    bdup = beff + lam * np.cross(emom.T, beff.T).T
    return _rotate(0.5 * (bdup + b2eff), emom, dt, lam)


class SpinDynamics:
    def __init__(self, sys: BulkSystem, workdir: str = ".", seed: int = 1234):
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir
        self.params = SDParams.from_namelists(sys.cfg.namelists)
        # the reference's reproducible MT19937 thermal field (mtprng.f90)
        self.rng = MTGaussian(self.params.sd_seed or seed)
        self.scf = SelfConsistency(sys, workdir)
        self.mom_ref = None  # constrained-moment reference directions

    # ------------------------------------------------------------------
    def step(self, mom_in: np.ndarray) -> np.ndarray:
        """One moment update from the current SCF state: the field, the
        constraint and the integrator; sets each rec atom's ``mom0`` and
        ``mom`` and returns the new directions (3, N)."""
        p = self.params
        atoms, iz_rec = self.sys.atoms, self.scf.iz_rec
        na = len(iz_rec)
        field = -magnetic_torques(atoms, iz_rec)
        if p.i_cons in (2, 3):
            # constrained-moment ASD (abspinlib/constrain.f90)
            if self.mom_ref is None:
                self.mom_ref = mom_in.copy()
            field = constrain_field(mom_in, self.mom_ref, field,
                                    p.lambda_t, p.i_cons)
        emom = np.zeros((3, na))
        if p.integrator == "depondt":
            # Depondt-Mertens rotation predictor-corrector; the effective
            # field is this step's SCF field for both stages
            mmom = np.linalg.norm(mom_in, axis=0)
            e_in = mom_in / mmom[None, :]
            e_pred, b2eff, _ = depondt_evolve_first(
                p.alpha, field, e_in, mmom, p.dt, p.sd_temp, self.rng)
            emom = depondt_evolve_second(p.alpha, field, b2eff, e_pred, p.dt)
            for i in range(na):
                atoms[iz_rec[i]].potential.mom0 = emom[:, i] * mmom[i]
        else:
            # Euler LLG predictor (asd_pred_euler :353-380)
            for i in range(na):
                m = mom_in[:, i]
                t1 = -GAMA * np.cross(m, field[:, i])
                t2 = -p.alpha * GAMA * np.cross(m, np.cross(m, field[:, i]))
                m_new = m + p.dt * (t1 + t2)
                atoms[iz_rec[i]].potential.mom0 = m_new
                emom[:, i] = m_new / np.linalg.norm(m_new)
        for i in range(na):
            atoms[iz_rec[i]].potential.mom = emom[:, i]
        return emom

    # ------------------------------------------------------------------
    def run(self):
        p = self.params
        sys = self.sys
        iz_rec = self.scf.iz_rec
        g_logger.info(
            f"spin dynamics: {p.asd_step} steps, dt={p.dt}, "
            f"alpha={p.alpha}, T={p.sd_temp}"
        )
        self.scf.run()
        mom_prev = np.stack(
            [sys.atoms[isp].potential.mom0 for isp in iz_rec], axis=1
        )
        timestep = 0.0
        traj_path = os.path.join(self.workdir, "output.lammpstrj")
        if os.path.exists(traj_path):
            os.remove(traj_path)
        for step in range(1, p.asd_step + 1):
            timestep += p.dt
            g_logger.info(f"spin dynamics step {step}")
            self.scf.run()
            emom = self.step(mom_prev.copy())
            for i in range(len(iz_rec)):
                mom_prev[:, i] = sys.atoms[iz_rec[i]].potential.mom0
            self._write_traj(emom, timestep)
        return mom_prev

    # ------------------------------------------------------------------
    def _write_traj(self, spins: np.ndarray, timestep: float):
        cl = self.sys.cluster
        na = spins.shape[1]
        path = os.path.join(self.workdir, "output.lammpstrj")
        with open(path, "a") as fh:
            fh.write("ITEM: TIMESTEP\n")
            fh.write(f" {timestep}\n")
            fh.write("ITEM: NUMBER OF ATOMS\n")
            fh.write(f" {na}\n")
            fh.write("ITEM: BOX BOUNDS xy xz yz\n")
            fh.write("    1.000000    0.000000    0.000000\n")
            fh.write("    0.000000    1.000000    0.000000\n")
            fh.write("    0.000000    0.000000    1.000000\n")
            fh.write("ITEM: ATOMS type x y z vx vy vz\n")
            for i in range(na):
                x, y, z = cl.cr[i]
                fh.write(
                    f"{int(cl.iz[i]):4d}"
                    + "".join(f"{v:12.4f}" for v in (x, y, z, *spins[:, i]))
                    + "\n"
                )
