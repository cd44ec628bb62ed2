"""Charge/moment mixing (reference ``source/mix.f90``).

``qia`` layout per recursion atom (18 columns):
cols 0-2  ql^(0) up (s,p,d), 3-5 ql^(0) down, 6-8 ql^(2) up, 9-11 ql^(2)
down, 12-14 pl up, 15-17 pl down (``save_to`` :273-333).

Linear and Srivastava-Broyden (J.Phys.A 17, L317) mixing with the
reference's two-vector history and reset-on-divergence logic
(``broydn`` :421-602).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from ..atoms.potential import SymbolicAtom


class Mixer:
    def __init__(self, nrec: int, beta: float = 0.1, mixtype: str = "linear",
                 magbeta: float = 1.0):
        self.nrec = nrec
        self.beta = beta
        self.mixtype = mixtype
        self.qia = np.zeros((nrec, 18))
        self.qia_new = np.zeros((nrec, 18))
        self.qia_old = np.zeros((nrec, 18))
        self.qiaprev = np.zeros((nrec, 18))
        n = nrec * 18
        self.v_broy = np.zeros(n)
        self.u_broy = np.zeros(n)
        self.fo_broy = np.zeros(n)
        self.muo_broy = np.zeros(n)
        self.fsqo = 1.0
        self.itr = 0
        self.nmix = 2
        self.delta = 0.0
        self.magbeta = np.full(nrec, magbeta)
        self.mag_old = np.zeros((nrec, 3))
        self.mag_new = np.zeros((nrec, 3))
        self.is_induced = np.zeros(nrec, dtype=bool)

    # ------------------------------------------------------------- save_to
    @staticmethod
    def _pack(pot) -> np.ndarray:
        row = np.zeros(18)
        row[0:3] = pot.ql[0, :, 0]
        row[3:6] = pot.ql[0, :, 1]
        row[6:9] = pot.ql[2, :, 0]
        row[9:12] = pot.ql[2, :, 1]
        row[12:15] = pot.pl[:, 0]
        row[15:18] = pot.pl[:, 1]
        return row

    def save_to(self, where: str, atoms: Sequence[SymbolicAtom],
                iz_rec: Sequence[int]):
        if where == "current":
            for it, isp in enumerate(iz_rec):
                pot = atoms[isp].potential
                row = self.qia[it]
                pot.ql[0, :, 0] = row[0:3]
                pot.ql[0, :, 1] = row[3:6]
                pot.ql[2, :, 0] = row[6:9]
                pot.ql[2, :, 1] = row[9:12]
                pot.pl[:, 0] = row[12:15]
                pot.pl[:, 1] = row[15:18]
            return
        dest = {"old": self.qia_old, "new": self.qia_new,
                "prev": self.qiaprev}[where]
        for it, isp in enumerate(iz_rec):
            dest[it] = self._pack(atoms[isp].potential)

    # --------------------------------------------------------------- mixpq
    def mixpq(self):
        if self.mixtype.strip() == "linear":
            self.qia = (1.0 - self.beta) * self.qia_old + self.beta * self.qia_new
        else:  # broyden
            mu = self.qia_old.reshape(-1).copy()
            f = self.qia_new.reshape(-1).copy()
            self._broydn(mu, f)
            self.qia = mu.reshape(self.nrec, 18)
        self.delta = float(
            np.sqrt(np.sum((self.qia_old[:, :12] - self.qia_new[:, :12]) ** 2))
            / 6.0 / self.nrec
        )

    def charge_transfer(self, atoms, iz_rec) -> np.ndarray:
        """dq per rec atom from the mixed occupations (mixpq tail)."""
        dq = np.zeros(self.nrec)
        for ia, isp in enumerate(iz_rec):
            dq[ia] = self.qia[ia, 0:6].sum() - atoms[isp].element.valence
        return dq

    def _broydn(self, mu: np.ndarray, f: np.ndarray):
        """Srivastava Jacobian-update Broyden with nmix=2 cycling."""
        pmix = amix = self.beta
        n = mu.size
        f -= mu
        fsq = float(f @ f) / n
        reset = False
        if self.itr == 0 or fsq > self.fsqo:
            reset = True
        if reset:
            self.itr = 0
        itr = self.itr
        if itr != 0:
            dmu = self.muo_broy.copy()
            df = self.fo_broy.copy()
        itrn = itr + 1
        self.muo_broy = mu.copy()
        self.fo_broy = f.copy()
        u, v = self.u_broy, self.v_broy
        if itr == 0:
            mu += pmix * f
        elif itr == 1:
            u_new = mu - dmu + amix * (f - df)
            v_new = f - df
            df2 = float(v_new @ v_new)
            v_new = v_new / df2
            t = float(v_new @ f)
            mu += amix * f - u_new * t
            self.u_broy = u_new
            self.v_broy = v_new
        else:
            dmu = mu - dmu
            df = f - df
            w1 = np.zeros(n)
            w2 = np.zeros(n)
            for _ in range(itr - 1):
                t = float(v @ f)
                w1 += u * t
                t = float(v @ df)
                w2 += u * t
            u_new = dmu + amix * df - w2
            v_new = df.copy()
            df2 = float(v_new @ v_new)
            v_new = v_new / df2
            t = float(v_new @ f)
            w1 += u_new * t
            mu += amix * f - w1
            self.u_broy = u_new
            self.v_broy = v_new
        self.itr = itrn
        self.fsqo = fsq
        if self.itr > self.nmix:
            self.itr = 1

    # -------------------------------------------------- magnetic mixing
    def mix_magnetic_moments(self, mtot: np.ndarray) -> np.ndarray:
        mag_mix = np.zeros((self.nrec, 3))
        for ia in range(self.nrec):
            if mtot[ia] < 0.5:
                self.is_induced[ia] = True
            mag_mix[ia] = ((1.0 - self.magbeta[ia]) * self.mag_old[ia]
                           + self.magbeta[ia] * self.mag_new[ia])
        return mag_mix
