"""Surface (layered 2-D Ewald) Madelung matrix and potential.

Implements the reference's surface electrostatics chain
(``source/charge.f90``): ``build_alelay`` :705-1010 (find the in-plane
primitive vectors of the slab lattice and the atomic basis of its 3-D
primitive cell), ``surfmat`` :642-698 (reciprocal cell + Ewald
parameters), ``set2d`` :1633-1692 (window of ``nbas`` layer sites around
the surface plane), ``latt2d`` :1450-1626 (2-D real/reciprocal lattice
vector lists), the monopole part of ``madl2d`` :1093-1375 (layered Ewald
sums of H. L. Skriver and N. M. Rosengaard, Phys. Rev. B 43, 9538 (1991))
and ``surfpot`` :491-572 (layer-resolved Madelung shifts vmad).

Only the monopole (ss) matrix ``dss`` is built: ``surfpot`` consumes
nothing else (the reference's dipole/quadrupole matrices dsz/ds3z2/... are
computed but never used by the SCF path).  ``madl2r`` :1382-1443 computes
only local variables that the reference discards, so it is omitted.

The e^{gz} erfc(beta + lambda z) products are evaluated through
``erfcx`` (scaled complementary error function) instead of the
reference's overflow guard (charge.f90 :1259-1272, which reuses a stale
variable when erfc underflows): exp(g z) erfc(beta + lambda z)
= exp(-beta^2 - (lambda z)^2) erfcx(beta + lambda z) exactly, since
g z = 2 beta lambda z.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc, erfcx

ANG2AU = 1.8897259886
# reference charge.f90 uses ang2au = 1.0d0/0.52917721d0 in surfmat
ANG2AU_CHG = 1.0 / 0.52917721


def _angle(a: np.ndarray, b: np.ndarray) -> float:
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na < 1e-30 or nb < 1e-30:
        return 0.0
    c = np.dot(a, b) / (na * nb)
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _rodrigues(v: np.ndarray, axis: np.ndarray, phi: float) -> np.ndarray:
    n = np.linalg.norm(axis)
    if n < 1e-30:
        return v.copy()
    k = axis / n
    return (v * np.cos(phi) + np.cross(k, v) * np.sin(phi)
            + k * np.dot(k, v) * (1.0 - np.cos(phi)))


def build_alelay(cr: np.ndarray, num: np.ndarray, miller: np.ndarray):
    """Find the slab's layered-lattice description (``build_alelay``).

    cr: (kk, 3) slab coordinates in lattice (alat) units; num: (kk,)
    crystal-site types; miller: surface normal (already 3-vector).

    Returns (bs, q3): bs (3,3) with columns [bsx, bsy, bsz] and q3
    (nq3, 3) basis positions of the 3-D primitive cell, both rotated so
    the surface normal is +z when the normal is not already [0,0,z].
    """
    kk = cr.shape[0]
    diff = 1.0e-4
    minpi = np.pi - diff
    # central atom (closest to the origin)
    d0 = np.linalg.norm(cr, axis=1)
    at = int(np.argmin(d0))
    h = cr @ miller
    same = (num == num[at])
    rel = cr - cr[at]
    dist = np.linalg.norm(rel, axis=1)
    same_layer = same & (np.abs(h - h[at]) < 1e-9)

    # bsx: nearest same-crystal-type atom in the same layer
    dmin0 = 1000.0
    bsx = None
    dmin2 = 1000.0
    bsz = None
    dmin3 = 1000.0
    for i in range(kk):
        if not same[i]:
            continue
        di = dist[i]
        if same_layer[i]:
            if di <= dmin0 and di > diff:
                bsx = rel[i].copy()
                dmin0 = di
            if (di > dmin0 and di < dmin3 and bsx is not None
                    and diff < _angle(rel[i], bsx) < minpi):
                dmin3 = di
        else:
            if di < dmin2 and di > diff:
                bsz = rel[i].copy()
                dmin2 = di
    # bsy: same-layer neighbor at dmin0 (else dmin3) with the smallest
    # nonzero angle to bsx
    bsy = None
    for target in (dmin0, dmin3):
        amin = minpi
        for i in range(kk):
            if not (same[i] and same_layer[i]):
                continue
            if abs(dist[i] - target) > 1e-9:
                continue
            ang = abs(_angle(rel[i], bsx))
            if diff < ang < minpi and ang < amin:
                bsy = rel[i].copy()
                amin = ang
        if bsy is not None:
            break
    if bsx is None or bsy is None or bsz is None:
        raise RuntimeError("build_alelay: could not find primitive vectors")

    # atoms inside the parallelepiped (check_atoms_in_volume /
    # check_within_volume, lattice.f90 :1947-2052): Gram-matrix solve
    A = np.stack([bsx, bsy, bsz], axis=1)
    gram = A.T @ A
    uvw = np.linalg.solve(gram, A.T @ rel.T).T
    inside = np.all((uvw >= 0.0) & (uvw <= 1.0), axis=1)
    in_idx = np.nonzero(inside)[0]

    # unique atoms modulo +-1 translations (identify_unique_atoms
    # :2120-2170)
    shifts = np.array([
        k * bsx + n * bsy + p * bsz
        for k in (-1, 0, 1) for n in (-1, 0, 1) for p in (-1, 0, 1)
    ])
    uniq = []
    for i in in_idx:
        dup = False
        for j in uniq:
            if np.any(np.linalg.norm(cr[i] - (cr[j] + shifts), axis=1)
                      < 1e-6):
                dup = True
                break
        if not dup:
            uniq.append(int(i))
    q3 = cr[uniq] - cr[uniq[0]]

    # rotate so the Miller normal becomes +z (build_alelay :920-1010)
    if abs(miller[0]) > 1e-12 or abs(miller[1]) > 1e-12:
        z = np.array([0.0, 0.0, 1.0])
        phi = _angle(z, miller)
        axis = np.cross(z, miller)
        new_x = _rodrigues(np.array([1.0, 0.0, 0.0]), axis, phi)
        new_y = _rodrigues(np.array([0.0, 1.0, 0.0]), axis, phi)
        new_x /= np.linalg.norm(new_x)
        new_y /= np.linalg.norm(new_y)
        new_z = miller / np.linalg.norm(miller)
        R = np.stack([new_x, new_y, new_z], axis=0)  # rows
        bsx = R @ bsx
        bsy = R @ bsy
        bsz = R @ bsz
        q3 = (R @ (cr[uniq]).T).T
        q3 = q3 - 0.0  # reference keeps absolute rotated coords here
    bs = np.stack([bsx, bsy, bsz], axis=1)
    return bs, q3


class SurfaceMadelung:
    """Layered 2-D Ewald monopole matrix ``dss`` (``surfmat``+``madl2d``).

    All geometry in lattice (alat) units; amax = bmax = alamda = 4
    (build_alelay :747-749).
    """

    def __init__(self, bs: np.ndarray, q3: np.ndarray, nbas: int,
                 alat: float, wav: float):
        self.alat = alat
        self.wav = wav
        self.nbas = nbas
        amax = bmax = self.alamda = 4.0
        bsx, bsy, bsz = bs[:, 0], bs[:, 1], bs[:, 2]
        bk = np.stack([np.cross(bsy, bsz), np.cross(bsz, bsx),
                       np.cross(bsx, bsy)], axis=1)
        self.vol = abs(float(bsx @ bk[:, 0]))
        bk = bk / self.vol * 2.0 * np.pi
        nq3 = q3.shape[0]
        self.sws = (3.0 * self.vol / (4.0 * np.pi) / nq3) ** (1.0 / 3.0)
        self.rmax = amax / self.alamda
        self.gmax = 2.0 * self.alamda * bmax
        self._set2d(bs, q3, nbas)
        self._latt2d(bs, bk)
        self.dss = self._madl2d()
        # on-site sphere correction (surfmat :690-692); wssurf defaults to
        # wav*ang2au for every site (charge.f90 :324)
        wssurf = self.wav * ANG2AU_CHG
        self.dss[np.diag_indices(nbas)] += 2.0 * (
            self.sws * self.alat * ANG2AU_CHG / wssurf
        )

    # ------------------------------------------------------------------
    def _set2d(self, bs, q3, nbas):
        """Window of nbas layer sites around z=0 (set2d :1633-1692)."""
        nlamb = nbas // 2
        nlama = nlamb - 1 if 2 * nlamb == nbas else nlamb
        bsz = bs[:, 2]
        ib = np.arange(-nlama, nlamb + 1)
        pos = (ib[:, None, None] * bsz[None, None, :]
               + q3[None, :, :]).reshape(-1, 3)
        order = np.argsort(pos[:, 2], kind="stable")
        pos = pos[order]
        zero = np.nonzero(np.abs(pos[:, 2]) < 1e-6)[0]
        if zero.size == 0:
            raise RuntimeError("set2d: no layer at z=0")
        isrf = int(zero[0])
        sel = pos[isrf - nlama : isrf + nlamb + 1]
        if sel.shape[0] != nbas:
            raise RuntimeError("set2d: window outside stacked layers")
        self.q = sel  # (nbas, 3)
        ar2d = bs[0, 0] * bs[1, 1] - bs[1, 0] * bs[0, 1]
        self.ar2d = abs(float(ar2d))

    # ------------------------------------------------------------------
    def _latt2d(self, bs, bk):
        """2-D real/reciprocal lattice vectors sorted by length
        (latt2d :1450-1626)."""
        q = self.q
        r1 = max(
            1e-6,
            float(np.max(np.linalg.norm(q[:, None] - q[None, :], axis=2))),
        ) * 1.001
        ra = self.rmax + r1
        ga = self.gmax
        dd = np.linalg.norm(bs, axis=0)
        dk = np.linalg.norm(bk, axis=0)
        ddm = 2.0 * np.pi / dd.max()
        dkm = 2.0 * np.pi / dk.max()
        numr = 2 * (int(ra / dkm) + 1) + 1
        numg = 2 * (int(ga / ddm) + 1) + 1

        def grid(v1, v2, n, cut):
            ab = np.arange(n) - (n // 2 + 1) + 1
            vecs = (ab[:, None, None] * v1[None, None, :2]
                    + ab[None, :, None] * v2[None, None, :2]).reshape(-1, 2)
            d = np.linalg.norm(vecs, axis=1)
            keep = d <= cut
            vecs, d = vecs[keep], d[keep]
            order = np.argsort(d, kind="stable")
            return vecs[order], d[order]

        self.rvec, self.dr = grid(bs[:, 0], bs[:, 1], numr, ra)
        self.nr0 = int(np.count_nonzero(self.dr <= self.rmax))
        self.gvec, self.dg = grid(bk[:, 0], bk[:, 1], numg, ga)

    # ------------------------------------------------------------------
    def _madl2d(self) -> np.ndarray:
        """Monopole layered-Ewald matrix DSS = 2 sws (AM + BM)
        (madl2d :1136-1165 diagonal, :1218-1310 off-diagonal,
        :1345-1352 scaling)."""
        nbas = self.nbas
        lam = self.alamda
        twolam = 2.0 * lam
        sqrt_pi = np.sqrt(np.pi)
        facbet = np.pi / self.ar2d / twolam
        facgau = -2.0 * sqrt_pi / self.ar2d / lam
        twos = 2.0 * self.sws

        dg = self.dg
        gnz = dg > 1e-12  # skip g = 0 (loop starts at I=2)
        dgi = dg[gnz]
        beta = dgi / twolam
        # layer-diagonal (R = R'): reciprocal + real sums
        bmdl_diag = facbet * np.sum(2.0 * erfc(beta) / beta)
        dr = self.dr[1 : self.nr0]  # real-space shells 2..NR0
        alpha = lam * dr
        bmdl_diag += float(np.sum(erfc(alpha) / dr)) - twolam / sqrt_pi

        am = np.full((nbas, nbas), facgau)
        bm = np.full((nbas, nbas), bmdl_diag)

        q = self.q
        iu, ju = np.triu_indices(nbas, k=1)  # (IQ > JQ) pairs
        qpp = q[iu] - q[ju]  # (np, 3)
        zpp = qpp[:, 2]
        dz = lam * zpp
        facerf = 2.0 * np.pi / self.ar2d
        erfcp = erfc(dz)
        erfcm = 2.0 - erfcp
        expz = np.where(dz > 12.0, 0.0, np.exp(-np.minimum(dz, 12.0) ** 2))
        am[iu, ju] = facgau * expz - zpp * facerf * erfcm
        am[ju, iu] = facgau * expz + zpp * facerf * erfcp

        # reciprocal off-diagonal: sum over g != 0 of
        # cos(g.rho) [e^{gz} erfc(beta+lam z) + e^{-gz} erfc(beta-lam z)]
        # / beta, via erfcx for the overflow-prone products
        gx, gy = self.gvec[gnz, 0], self.gvec[gnz, 1]
        phase = np.cos(np.outer(qpp[:, 0], gx) + np.outer(qpp[:, 1], gy))
        aq = dz[:, None]  # lam*z, (np, 1)
        bet = beta[None, :]
        gauss = np.exp(-bet**2 - aq**2)

        def _half(arg, sgn_gz):
            # e^{sgn_gz * g z} erfc(arg); arg = beta + sgn_gz * lam z
            direct = np.exp(np.minimum(sgn_gz * dgi[None, :] * zpp[:, None],
                                       0.0)) * erfc(arg)
            return np.where(arg >= 0.0, gauss * erfcx(np.maximum(arg, 0.0)),
                            direct)

        exf = _half(bet + aq, 1.0) + _half(bet - aq, -1.0)
        sum0g = np.sum(phase * exf / bet, axis=1)
        bmdl = facbet * sum0g

        # real-space off-diagonal: all NUMVR vectors, keep |r+rho| < RMAX
        rx = self.rvec[:, 0][None, :] + qpp[:, 0][:, None]
        ry = self.rvec[:, 1][None, :] + qpp[:, 1][:, None]
        dri = np.sqrt(rx**2 + ry**2 + zpp[:, None] ** 2)
        keep = dri < self.rmax
        safe = np.where(keep, dri, 1.0)
        bmdl += np.sum(np.where(keep, erfc(lam * safe) / safe, 0.0), axis=1)

        bm[iu, ju] = bmdl
        bm[ju, iu] = bmdl
        return twos * (am + bm)


def surfpot(smad: SurfaceMadelung, dq: np.ndarray,
            natoms_layer: np.ndarray, nlay: int, atoms, iz_rec,
            nbulk: int, vmix: float = 1.0, logger=None):
    """Layer-resolved surface Madelung shifts (``surfpot`` :491-572).

    dq: charge transfer per recursion atom (type order nbulk+1..ntype);
    the first ``init=6`` window sites are skipped and the layer charge
    in excess is dumped on layer nlay+1.
    """
    nbas = smad.nbas
    init = 6
    nrlx = nbas - init
    wsms = smad.sws * smad.alat * ANG2AU_CHG
    tdq = np.zeros(nrlx)
    atomrec = 0
    for ic in range(nlay):
        for _ in range(int(natoms_layer[ic])):
            tdq[ic] += dq[atomrec]
            atomrec += 1
    tdq[nlay] = -tdq[:nlay].sum()  # excess to the next layer (iex)
    if logger is not None and abs(tdq[nlay]) > 0.5:
        logger.warning("Too much charge in the external layer!")

    dss = smad.dss
    rows = init + np.arange(nlay)  # 0-based window rows init..init+nlay-1
    vm = (dss[np.ix_(rows, init + np.arange(nrlx))] @ tdq) / wsms
    vmn = float(dss[nbas - 1, init:] @ tdq) / wsms  # deep "bulk" row
    vbulk = vmn

    atomrec = 0
    for ib in range(nlay):
        for _ in range(int(natoms_layer[ib])):
            pot = atoms[nbulk + atomrec].potential
            vmard = vm[ib] - vbulk
            pot.vmad = vmard * vmix + pot.vmad * (1.0 - vmix)
            atomrec += 1
    return vm - vbulk
