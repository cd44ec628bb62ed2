"""Atomic-sphere self-consistency driver (reference ``self.f90`` atomsc).

Composes the radial machinery of :mod:`.radial` into:

* :func:`rhocor` — core-state charge density (``RHOCOR`` :1646-1868),
* :func:`newrho` — valence + core density from boundary conditions (PL) and
  moments (QL) (``NEWRHO`` :1454-1645),
* :func:`atomsc` — the radial SCF loop producing total energies and the
  final potential (``atomsc`` :1187-1430),
* :func:`potpar` — potential parameters ENU/C/SRDEL/QPAR/PPAR/VL from
  log-derivative boundary conditions (``POTPAR`` :2966-3087),
* :func:`racsi` — SOC strengths xi_p/xi_d and Racah parameters
  (``RACSI`` :2846-2964),
* :func:`lmtst` — the per-atom entry combining them (``lmtst`` :1135-1186).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .radial import (
    C_LIGHT,
    gintsr,
    mesh_b,
    mesh_grid_size,
    phdfsr,
    poiss0,
    radial_mesh,
    rho0_guess,
    rseqsr,
    simpson_weights,
    vxc0sp,
)
from .xc_lda import XCFunctional


@dataclass
class AtomSCFResult:
    etot: float = 0.0
    utot: float = 0.0
    ekin: float = 0.0
    rhoeps: float = 0.0
    sumev: float = 0.0
    sumec: float = 0.0
    vrmax: np.ndarray = None
    v: np.ndarray = None  # (nr, 2) final potential
    rofi: np.ndarray = None
    fun2: np.ndarray = None  # (nr, 3, 2) valence probability densities
    vzt: np.ndarray = None  # (nr, 2) v - 2Z/r
    qc: float = 0.0
    nr: int = 0
    hyper_field: np.ndarray = None  # (2,): [H_core, H_val] in Tesla


def _core_correction(e1, e2, ecor0, tol, z, l, nodes, v, a, b, rofi, nr, g):
    """Core solve with the decaying-tail slope correction (RHOCOR
    :1703-1725)."""
    rmax = rofi[nr - 1]
    val = 1.0e-30
    slo = -val
    ecore, _, nre = rseqsr(e1, e2, ecor0, tol, z, l, nodes, val, slo, v, a, b,
                           rofi, nr, g)
    yyy = ecore - v[nr - 1] + 2.0 * z / rmax
    if nre == nr and yyy < 0.0:
        dlml = -1.0 - np.sqrt(-yyy) * rmax
        for ll in range(1, l + 1):
            dlml = -yyy * rmax * rmax / dlml - (2 * ll + 1)
        slo = val * (dlml + l + 1) / rmax
        ecore, _, nre = rseqsr(e1, e2, ecore, tol, z, l, nodes, val, slo, v,
                               a, b, rofi, nr, g)
    return ecore, nre


def _core_deg(ifcore: int, isp: int, nsp: int) -> float:
    """Spin degeneracy of the fractional f core (NEWRHO/RHOCOR blocks)."""
    dfcore = float(ifcore)
    if nsp == 1:
        return dfcore
    if ifcore <= 7:
        return dfcore if isp == 0 else 0.0
    return 7.0 if isp == 0 else dfcore - 7.0



def _hyper_weights(nre):
    """Fortran Simpson pattern: wgta(ij)=4/3 (even 1-based ij) / 2/3
    (odd), 1/3 at the last point; point 1 excluded (loop from IJ=2)."""
    ij = np.arange(2, nre + 1)  # 1-based
    w = np.where(ij % 2 == 0, 4.0 / 3.0, 2.0 / 3.0)
    w[-1] = 1.0 / 3.0
    return w


def _hyper_contact(z, a, b, rofi, lo, hi, dens):
    """Relativistically smeared contact integral (self.f90 :1600-1634,
    :1742-1768): sum w drdi (RT/2)/(r+RT/2)^2 dens/(4 pi r^2), RT =
    Z (2/c)^2, over 1-based points lo..hi."""
    c = C_LIGHT
    rt = z * (2.0 / c) ** 2
    r = rofi[lo - 1:hi]
    w = _hyper_weights(hi)[lo - 2:]
    drdi = a * (r + b)
    deth = (rt / 2.0) / (r + rt / 2.0) ** 2
    return float(np.sum(w * drdi * deth * dens / (4.0 * np.pi * r**2)))


def rhocor(z, lmax, konfig, a, b, nr, rofi, v, rho, tol, nsp,
           ifcore, ec, hyper=None):
    """Add core-state density to rho (in place); returns (sumec (2,), ec)."""
    rmax = rofi[nr - 1]
    e1 = -2.5 * z * z - 5.0
    e2 = 20.0
    c = C_LIGHT
    sumec = np.zeros(2)
    g = np.zeros((nr, 2))
    icore = 0
    for isp in range(nsp):
        for lp1 in range(1, lmax + 2):
            l = lp1 - 1
            deg = (2 * (2 * l + 1)) / nsp
            for konf in range(lp1, konfig[lp1 - 1]):
                nodes = konf - lp1
                ecor0 = ec[icore]
                ecore, nre = _core_correction(
                    e1, e2, ecor0, tol, z, l, nodes, v[:, isp], a, b, rofi, nr, g
                )
                ec[icore] = ecore
                icore += 1
                fllp1 = l * (l + 1)
                r = rofi[1:nre]
                tmc = c - (v[1:nre, isp] - 2.0 * z / r - ecore) / c
                gfac = 1.0 + fllp1 / (tmc * r) ** 2
                rho[1:nre, isp] += deg * (gfac * g[1:nre, 0] ** 2 + g[1:nre, 1] ** 2)
                sumec[isp] += deg * ecore
                if hyper is not None and l == 0:
                    # core s-shell contact term (rhocor :1742-1768;
                    # gfac = 1 for l = 0)
                    hyper["sh_core"][konf, isp] = _hyper_contact(
                        z, a, b, rofi, 2, nre, g[1:nre, 0] ** 2
                    )
        if ifcore != 0:
            lp1 = lmax + 2
            l = lp1 - 1
            deg = _core_deg(ifcore, isp, nsp)
            for konf in range(lp1, 5):  # KONFIG(LMAX+2)=5
                nodes = konf - lp1
                ecor0 = ec[icore]
                ecore, nre = _core_correction(
                    e1, e2, ecor0, tol, z, l, nodes, v[:, isp], a, b, rofi, nr, g
                )
                ec[icore] = ecore
                icore += 1
                fllp1 = l * (l + 1)
                r = rofi[1:nre]
                tmc = c - (v[1:nre, isp] - 2.0 * z / r - ecore) / c
                gfac = 1.0 + fllp1 / (tmc * r) ** 2
                rho[1:nre, isp] += deg * (gfac * g[1:nre, 0] ** 2 + g[1:nre, 1] ** 2)
                sumec[isp] += deg * ecore
    if hyper is not None:
        sh = hyper["sh_core"]
        # HCORE = 52.42 sum_konf (SH_up - SH_dw) (rhocor :1780-1791)
        hyper["core"] = 52.42 * float((sh[:, 0] - sh[:, 1]).sum())
    return sumec


def newrho(z, lmax, a, b, nr, rofi, v, pl, ql, ec, ev, tol, nsp,
           ifcore, hyper=None):
    """Build the full (core + valence) density from PL boundary conditions
    and QL moments.  Returns (rho, sumec, sumev, fun2, vzt)."""
    rocrit = 0.002
    c = C_LIGHT
    rmax = rofi[nr - 1]
    free = rmax > 9.99
    konf = np.zeros(lmax + 2, dtype=np.int64)
    for l in range(lmax + 1):
        konf[l] = int(pl[l, 0])
    if ifcore != 0:
        konf[lmax + 1] = 5

    vzt = np.zeros((nr, 2))
    for isp in range(nsp):
        vzt[1:, isp] = v[1:, isp] - 2.0 * z / rofi[1:]

    rho = np.zeros((nr, nsp))
    sumec = rhocor(z, lmax, konf, a, b, nr, rofi, v, rho, tol, nsp,
                   ifcore, ec, hyper=hyper)

    fun2 = np.zeros((nr, lmax + 1, 2))
    sumev = np.zeros(2)
    g = np.zeros((nr, 2))
    ival = 0
    for isp in range(nsp):
        for lp1 in range(1, lmax + 2):
            l = lp1 - 1
            q0 = ql[0, l, isp]
            q1 = ql[1, l, isp]
            q2 = ql[2, l, isp]
            if q0 < 1.0e-5:
                continue
            konfig = int(pl[l, isp])
            dl = np.tan(np.pi * (0.5 - pl[l, isp]))
            nn = konfig - lp1
            eval_ = ev[ival]
            val = rmax
            slo = dl + 1.0
            if free:
                val = 1.0e-30
                slo = -val
            g[:] = 0.0
            eval_, summ, nre = rseqsr(-50.0, 50.0, eval_, tol, z, l, nn, val,
                                      slo, v[:, isp], a, b, rofi, nr, g)
            ev[ival] = eval_
            ival += 1
            sumev[isp] += eval_ * q0 + q1
            ro = g[nr - 1, 0] ** 2
            if free or ro < rocrit:
                gp = np.zeros((nr, 2))
                gpp = np.zeros((nr, 2))
            else:
                val = val / np.sqrt(summ)
                slo = slo / np.sqrt(summ)
                gp, gpp, *_ = phdfsr(z, l, v[:, isp], eval_, a, b, rofi, nr,
                                     g, val, slo, tol, nn)
            fllp1 = l * (l + 1)
            r = rofi[1:nre]
            tmc = c - (v[1:nre, isp] - 2.0 * z / r - eval_) / c
            gfac = 1.0 + fllp1 / (tmc * r) ** 2
            rho[1:nre, isp] += (
                q0 * (gfac * g[1:nre, 0] ** 2 + g[1:nre, 1] ** 2)
                + 2.0 * q1 * (gfac * g[1:nre, 0] * gp[1:nre, 0]
                              + g[1:nre, 1] * gp[1:nre, 1])
                + q2 * (gfac * (gp[1:nre, 0] ** 2 + g[1:nre, 0] * gpp[1:nre, 0])
                        + gp[1:nre, 1] ** 2 + g[1:nre, 1] * gpp[1:nre, 1])
            )
            fun2[1:nre, l, isp] = gfac * g[1:nre, 0] ** 2 + g[1:nre, 1] ** 2
            if hyper is not None and l == 0:
                # valence s contact term (newrho :1600-1634).  The
                # reference multiplies the WHOLE moment sum by Q0
                # (its parenthesisation), reproduced faithfully here;
                # gfac = 1 for l = 0; integral over the full mesh.
                dens = q0 * (g[1:nr, 0] ** 2
                             + 2.0 * q1 * (g[1:nr, 0] * gp[1:nr, 0])
                             + q2 * (gp[1:nr, 0] ** 2
                                     + g[1:nr, 0] * gpp[1:nr, 0]))
                hyper["sh_val"][isp] = _hyper_contact(
                    z, a, b, rofi, 2, nr, dens
                )
    if hyper is not None:
        sv = hyper["sh_val"]
        hyper["val"] = 52.42 * float(sv[0] - sv[1])
    return rho, sumec, sumev, fun2, vzt


def atomsc(z, lmax, a, ws_r, pl, ql, ifcore=0, txc=1, nsp=2,
           niter=80, rho_init: Optional[np.ndarray] = None,
           hyperfine: bool = False) -> AtomSCFResult:
    """Run the radial SCF loop to self-consistency (``atomsc``)."""
    nr = mesh_grid_size(z, ws_r, a)
    b = mesh_b(ws_r, a, nr)
    rofi = radial_mesh(a, b, nr)
    xcf = XCFunctional(txc, nsp)

    ncore = 0
    for l in range(lmax + 1):
        for isp in range(nsp):
            konfig = int(pl[l, isp])
            ncore += max(0, konfig - 1 - l)
    if ifcore != 0:
        ncore += 2 * max(0, 5 - (lmax + 2))  # KONF = LMAX+2 .. 4
    ec = np.full(max(ncore, 1), -5.0)
    nval = sum(1 for l in range(lmax + 1) for isp in range(nsp))
    ev = np.full(nval, -0.5)

    rho_in = rho0_guess(z, a, b, nr) if rho_init is None else rho_init.copy()

    tol = 1.0e-6
    tolrsq = 1.0e-8
    beta = 0.3
    drho = 100.0
    last = False
    res = AtomSCFResult()
    v = np.zeros((nr, 2))
    fun2 = vzt = None
    sec = np.zeros(2)
    sev = np.zeros(2)
    reps = np.zeros(2)
    rmu = np.zeros(2)
    rvh = np.zeros(2)
    vnucl = 0.0
    for it in range(1, niter + 1):
        # The reference loosens the eigensolver tolerance to 1e-3 while
        # drho > 2 (atomsc :1390).  The loose solves are numerically fragile
        # (spurious small Newton steps far from the eigenvalue destabilise
        # the SCF trajectory); we keep the tight tolerance throughout — the
        # converged fixed point is identical since the final iterations use
        # the tight tolerance either way.
        tl = tolrsq
        beta1 = beta
        if it % 3 == 2 and drho < 1.0:
            beta1 = 0.5
        v, rvh, vsum = poiss0(z, a, b, rofi, rho_in)
        vnucl = v[0, 0]
        rho0_, reps, rmu = vxc0sp(xcf, a, b, rofi, rho_in, v, nsp)
        hyp = ({"sh_core": np.zeros((10, 2)), "sh_val": np.zeros(2)}
               if (hyperfine and last) else None)
        rho, sec, sev, fun2, vzt = newrho(
            z, lmax, a, b, nr, rofi, v, pl, ql, ec, ev, tl, nsp, ifcore,
            hyper=hyp
        )
        if hyp is not None:
            res.hyper_field = np.array([hyp["core"], hyp["val"]])
        wgt = simpson_weights(nr)
        drho = float(np.sum(np.abs(rho - rho_in) * wgt[:, None]))
        rho_in = beta1 * rho + (1.0 - beta1) * rho_in
        if last:
            break
        if drho < tol or it == niter - 1:
            last = True

    res.rhoeps = float(reps.sum())
    rhomu = float(rmu.sum())
    res.sumev = float(sev.sum())
    res.sumec = float(sec.sum())
    rhovh = float(rvh.sum())
    zvnucl = -z * vnucl
    res.utot = 0.5 * (rhovh + zvnucl)
    res.ekin = res.sumev + res.sumec - rhovh - rhomu
    res.etot = res.ekin + res.utot + res.rhoeps
    vrmax = np.zeros(2)
    vrmax[0] = -2.0 * z / ws_r + (v[nr - 1, 0] + v[nr - 1, 1]) / nsp
    if nsp == 2:
        vrmax[1] = v[nr - 1, 0] - v[nr - 1, 1]
    res.vrmax = vrmax
    res.v = v
    res.rofi = rofi
    res.fun2 = fun2
    # VZT with first point copied from second (lmtst :1153)
    vzt[0, :] = vzt[1, :]
    res.vzt = vzt
    res.nr = nr
    return res


def potpar(z, lmax, a, ws_r, pnu, v, rofi):
    """Potential parameters from the final potential (``POTPAR``).

    Returns dict with enu, c, srdel, qpar (the reference's Q before the
    1/Q inversion in lmtst), ppar, vl, p of shape (lmax+1, 2).
    """
    tol = 1.0e-12
    eb1, eb2 = -10.0, 10.0
    nr = rofi.shape[0]
    b = mesh_b(ws_r, a, nr)
    rmax = ws_r
    nsp = 2
    out = {k: np.zeros((lmax + 1, 2)) for k in
           ("enu", "c", "srdel", "qpar", "ppar", "vl")}
    g = np.zeros((nr, 2))
    for i in range(nsp):
        for l in range(lmax + 1):
            konfig = int(pnu[l, i])
            dnu = np.tan(np.pi * (0.5 - pnu[l, i]))
            nn = konfig - l - 1
            e = -0.5
            val = rmax
            slo = dnu + 1.0
            g[:] = 0.0
            e, summ, _ = rseqsr(eb1, eb2, e, tol, z, l, nn, val, slo,
                                v[:, i], a, b, rofi, nr, g)
            val_n = val / np.sqrt(summ)
            slo_n = slo / np.sqrt(summ)
            gp, gpp, phi, dphi, phip, dphip, p = phdfsr(
                z, l, v[:, i], e, a, b, rofi, nr, g, val_n, slo_n, tol, nn
            )
            out["enu"][l, i] = e
            dlphi = rmax * dphi / phi
            dlphip = rmax * dphip / phip
            omegam = -(phi / phip) * (-l - 1 - dlphi) / (-l - 1 - dlphip)
            omegap = -(phi / phip) * (l - dlphi) / (l - dlphip)
            phplus = phi + omegap * phip
            phmins = phi + omegam * phip
            out["c"][l, i] = e + omegam
            out["vl"][l, i] = e + omegap
            out["srdel"][l, i] = phmins * np.sqrt(0.5 * rmax)
            q = phmins / (2 * (2 * l + 1) * phplus)
            out["qpar"][l, i] = 1.0 / q
            out["ppar"][l, i] = 1.0 / np.sqrt(p)
    return out


def racsi(a, b, rofi, fun2, vzt):
    """SOC strengths (xi_p, xi_d per spin) and d-band Racah parameter
    (``RACSI``).  Returns qsl(6): [xi_p_up, xi_d_up, rac_up,
    xi_p_dw, xi_d_dw, rac_dw]."""
    nr = rofi.shape[0]
    c2 = C_LIGHT**2
    qsl = np.zeros(6)
    dvdr = np.zeros((nr, 2))
    for isp in range(2):
        for ii in range(2, nr - 1):
            dvp = (vzt[ii + 1, isp] - vzt[ii, isp]) / (rofi[ii + 1] - rofi[ii])
            dvm = (vzt[ii - 1, isp] - vzt[ii, isp]) / (rofi[ii - 1] - rofi[ii])
            dvdr[ii, isp] = 0.5 * (dvp + dvm)
        dvdr[1, isp] = dvdr[2, isp]
        dvdr[nr - 1, isp] = dvdr[nr - 2, isp]

    wgt = simpson_weights(nr)
    drdi = a * (rofi + b)
    for inum in (2, 3):  # p (l=1), d (l=2); fun2 index l = inum-1
        for isp in range(2):
            s = np.sum(
                wgt[1:] * drdi[1:] * fun2[1:, inum - 1, isp]
                * 2.0 * dvdr[1:, isp] / (rofi[1:] * c2)
            )
            if isp == 0:
                qsl[inum - 2] = s
            else:
                qsl[inum + 1] = s
    # Racah F2/F4 Slater integrals over the d density
    for isp in range(2):
        fak2 = fak4 = 0.0
        for inum in (2, 4):
            s = 0.0
            f_d = fun2[:, 2, isp]
            for ir in range(1, nr):
                # inner: Fortran IR1 = 2..IR with 1/3 weight at IR1==IR
                w1 = 2.0 * (np.mod(np.arange(2, ir + 2) + 1, 2) + 1) / 3.0
                w1[-1] = 1.0 / 3.0
                sum1 = np.sum(
                    w1 * drdi[1 : ir + 1] * f_d[1 : ir + 1]
                    * rofi[1 : ir + 1] ** inum / rofi[ir] ** (inum + 1)
                )
                w2 = 2.0 * (np.mod(np.arange(ir + 1, nr + 1) + 1, 2) + 1) / 3.0
                w2[0] = 1.0 / 3.0
                w2[-1] = 1.0 / 3.0
                sum2 = np.sum(
                    w2 * drdi[ir:] * f_d[ir:]
                    * rofi[ir] ** inum / rofi[ir:] ** (inum + 1)
                )
                s += wgt[ir] * drdi[ir] * (sum1 + sum2) * f_d[ir]
            if inum == 2:
                fak2 = s / 49.0
                fak4 = 0.0
            else:
                fak4 = s / 441.0
        qsl[2 + 3 * isp] = 2.0 * (fak2 - 5.0 * fak4)
    return qsl
