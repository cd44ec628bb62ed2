"""Scalar-relativistic atomic-sphere solver (radial SCF).

Re-implements the reference self-consistency kernel of ``source/self.f90``:
the exponential radial mesh and starting density (``symbolic_atom.f90``
``rho0``/``B``/``mesh_grid_size``), the Hartree solve (``POISS0``), the XC
application (``VXC0SP``), the scalar-relativistic shooting solver
(``RSEQSR`` + ``RSQSR1``/``RSQSR2`` + ``FCTP``), energy-derivative orbitals
(``PHDFSR``), the core/valence density builder (``RHOCOR``/``NEWRHO``), the
atomic SCF loop (``atomsc``), potential-parameter extraction (``POTPAR``)
and the SOC strengths (``RACSI``).

This module is the readable NumPy/Python reference; the hot shooting loops
have a compiled C++ twin (``native/``, built from ``csrc/radial.cpp``)
used in production.
Rydberg atomic units; light speed c = 274.074 (2/alpha).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .xc_lda import XCFunctional

C_LIGHT = 274.074
MIN_MESH = 25


def mesh_grid_size(z: float, ws_r: float, a: float = 0.02) -> int:
    b = 1.0 / (z + z + 1.0)
    return max(MIN_MESH,
               int(((0.5 + np.log(1.0 + ws_r / b) / a) * 2.0 - 1) / 2) * 2 + 1)


def mesh_b(ws_r: float, a: float, nr: int) -> float:
    return ws_r / (np.exp(a * nr - a) - 1.0)


def radial_mesh(a: float, b: float, nr: int) -> np.ndarray:
    """rofi(i) = b (e^{a i} - 1), i = 0..nr-1 (reference rpb recurrence)."""
    rpb = b * np.exp(a * np.arange(nr))
    return rpb - b


def simpson_weights(nr: int) -> np.ndarray:
    """The reference's in-place weights: wgt = 2*(mod(ir+1,2)+1)/3 with 1/3
    at the first and last point (1-based ir)."""
    ir = np.arange(1, nr + 1)
    w = 2.0 * (np.mod(ir + 1, 2) + 1) / 3.0
    w[0] = 1.0 / 3.0
    w[-1] = 1.0 / 3.0
    return w


def rho0_guess(z: float, a: float, b: float, nr: int) -> np.ndarray:
    """Starting density exp(-5r) r^2, normalised to Z/2 per spin
    (symbolic_atom%rho0 :592-625)."""
    ea = np.exp(a)
    rho = np.zeros((nr, 2))
    rpb = b
    s = 0.0
    for ir in range(nr):
        r = rpb - b
        ro = np.exp(-5.0 * r) * r * r
        rho[ir, 0] = ro
        s += a * rpb * ro
        rpb *= ea
    fac = z / (s * 2.0)
    rho[:, 0] *= fac
    rho[:, 1] = rho[:, 0]
    return rho


# ------------------------------------------------------------------ POISS0
def poiss0(z: float, a: float, b: float, rofi: np.ndarray,
           rho: np.ndarray, vhrmax: float = 0.0):
    """Hartree potential for spherical rho (= 4 pi r^2 rho_true).

    Returns (v (nr,2), rhovh (2,), vsum).  Numerov integration of the
    inhomogeneous radial Poisson equation, exactly as POISS0 :2475-2586.
    """
    nr = rofi.shape[0]
    nsp = rho.shape[1]
    rmax = rofi[nr - 1]
    v = np.zeros((nr, 2))
    r2, r3, r4 = rofi[1], rofi[2], rofi[3]
    f2 = rho[1, :nsp].sum() / r2**2
    f3 = rho[2, :nsp].sum() / r3**2
    f4 = rho[3, :nsp].sum() / r4**2
    x23 = (r3 * r3 * f2 - r2 * r2 * f3) / (r3 - r2)
    x34 = (r4 * r4 * f3 - r3 * r3 * f4) / (r4 - r3)
    cc = (r2 * x34 - r4 * x23) / (r3 * (r2 - r4))
    bb = ((r2 + r3) * x34 - (r3 + r4) * x23) / (r3 * r3 * (r4 - r2))
    dd = (f2 - bb * r2 - cc) / r2**2

    a2b4 = a * a / 4.0
    v[0, 0] = 1.0
    df = 0.0
    g = f = 0.0
    y2 = y3 = 0.0
    for ir in (1, 2):  # 0-based ir = 2,3 in Fortran
        r = rofi[ir]
        drdi = a * (r + b)
        srdrdi = np.sqrt(drdi)
        v[ir, 0] = v[0, 0] - r * r * (cc / 3.0 + r * bb / 6.0 + r * r * dd / 10.0)
        g = v[ir, 0] * r / srdrdi
        f = g * (1.0 - a2b4 / 12.0)
        if ir == 1:
            y2 = -2.0 * f2 * r2 * drdi * srdrdi
        else:
            y3 = -2.0 * f3 * r3 * drdi * srdrdi
        df = f - df
    ir = 2
    while ir < nr - 1:
        ir += 1
        r = rofi[ir]
        drdi = a * (r + b)
        srdrdi = np.sqrt(drdi)
        ro = rho[ir, :nsp].sum()
        y4 = -2.0 * drdi * srdrdi * ro / r
        df = df + g * a2b4 + (y4 + 10.0 * y3 + y2) / 12.0
        f = f + df
        g = f / (1.0 - a2b4 / 12.0)
        v[ir, 0] = g * srdrdi / r
        y2 = y3
        y3 = y4
    vnow = v[nr - 1, 0] - 2.0 * z / rmax
    v[:, 0] += vhrmax - vnow

    rhovh = np.zeros(2)
    vsum = 0.0
    vhat0 = 0.0
    wgt_all = simpson_weights(nr)
    # reference uses wgt pattern with 1/3 only at ir==nr inside this loop
    for ir in range(1, nr):
        r = rofi[ir]
        drdi = a * (r + b)
        wgt = 2.0 * (np.mod(ir + 2, 2) + 1) / 3.0
        if ir == nr - 1:
            wgt = 1.0 / 3.0
        ro = 0.0
        for isp in range(nsp):
            rhovh[isp] += wgt * drdi * rho[ir, isp] * (v[ir, 0] - 2.0 * z / r)
            ro += rho[ir, isp]
        vhat0 += wgt * drdi * ro * (1.0 / r - 1.0 / rmax)
        vsum += wgt * drdi * r * r * (v[ir, 0] - vhrmax)
    vsum = 4.0 * np.pi * (vsum - z * rmax * rmax)
    vhat0 = 2.0 * vhat0 + 2.0 * z / rmax + vhrmax
    v[0, 0] = vhat0
    if nsp != 1:
        v[:, 1] = v[:, 0]
    return v, rhovh, vsum


# ------------------------------------------------------------------ VXC0SP
def vxc0sp(xcf: XCFunctional, a: float, b: float, rofi: np.ndarray,
           rho: np.ndarray, v: np.ndarray, nsp: int = 2, b_fsm: float = 0.0):
    """Add XC potential; return (rho0 (2,), rhoeps (2,), rhomu (2,)).

    VXC0SP :2588-2795.  v is updated in place.  For the gradient
    functionals (txc 5/8/9) the radial derivatives are computed with
    ``radgra`` and transformed exactly as the reference does: at the
    first point the radius argument is the mesh spacing r3 - r2, deeper
    points use rofi (nsp = 2) or the fixed spacing (nsp = 1), with
    rhod = rho'/R and rhodd = (rho'' - rho')/R^2 and the spin slots
    swapped to match the XCPOT argument order.
    """
    from .xc_lda import radgra

    nr = rofi.shape[0]
    ob4pi = 1.0 / (4.0 * np.pi)
    rho0 = np.zeros(2)
    rhoeps = np.zeros(2)
    rhomu = np.zeros(2)
    trho = np.zeros((nr, nsp))
    for isp in range(nsp):
        rho2 = rho[1, isp] / rofi[1] ** 2
        rho3 = rho[2, isp] / rofi[2] ** 2
        rho0[isp] = ob4pi * (rho2 * rofi[2] - rho3 * rofi[1]) / (rofi[2] - rofi[1])
        trho[0, isp] = rho0[isp]
        trho[1:, isp] = rho[1:, isp] * ob4pi / rofi[1:] ** 2

    gga = xcf.txc in (5, 8, 9)
    if gga:
        rhop = np.stack([radgra(a, b, rofi, trho[:, s])
                         for s in range(nsp)], axis=1)
        rhopp = np.stack([radgra(a, b, rofi, rhop[:, s])
                          for s in range(nsp)], axis=1)

    if nsp == 1:
        rho1 = 0.5 * trho[:, 0]
        if gga:
            rr = np.full(nr, rofi[2] - rofi[1])
            rhod = 0.5 * rhop[:, 0] / rr
            rhodd = 0.5 * (rhopp[:, 0] - rhop[:, 0]) / rr**2
            v1, _, exc = xcf.xcpot(rho1, rho1, trho[:, 0],
                                   rhop=(rhod, rhod),
                                   rhopp=(rhodd, rhodd), rr=rr)
        else:
            v1, _, exc = xcf.xcpot(rho1, rho1, trho[:, 0])
        v[:, 0] += v1
        wgt = simpson_weights(nr)
        drdi = a * (rofi + b)
        rhoeps[0] = np.sum(wgt[1:] * drdi[1:] * rho[1:, 0] * exc[1:])
        rhomu[0] = np.sum(wgt[1:] * drdi[1:] * rho[1:, 0] * v1[1:])
    else:
        # xcpot(rho_down, rho_up, total) -> (v_down, v_up)
        tot = trho[:, 0] + trho[:, 1]
        tot[0] = trho[0, 0] + trho[0, 1]
        if gga:
            # radius argument: mesh spacing at the first point, rofi
            # deeper in (reference :2683-2752); slot 1 of the derivative
            # pair carries spin 1's data to pair with the first XCPOT
            # argument trho[:, 1]
            rr = rofi.copy()
            rr[0] = rofi[2] - rofi[1]
            rhod1 = rhop[:, 1] / rr
            rhod2 = rhop[:, 0] / rr
            rhodd1 = (rhopp[:, 1] - rhop[:, 1]) / rr**2
            rhodd2 = (rhopp[:, 0] - rhop[:, 0]) / rr**2
            vxc2, vxc1, exc = xcf.xcpot(
                trho[:, 1], trho[:, 0], tot,
                rhop=(rhod1, rhod2), rhopp=(rhodd1, rhodd2), rr=rr
            )
        else:
            vxc2, vxc1, exc = xcf.xcpot(trho[:, 1], trho[:, 0], tot)
        v[:, 0] += vxc1 + b_fsm
        v[:, 1] += vxc2 - b_fsm
        wgt = simpson_weights(nr)
        drdi = a * (rofi + b)
        # note: reference weights use 1/3 only at ir==1 and ir==nr; the
        # ir==1 point is excluded from the sums (loop from 2)
        rhoeps[0] = np.sum(wgt[1:] * drdi[1:] * rho[1:, 0] * exc[1:])
        rhomu[0] = np.sum(wgt[1:] * drdi[1:] * rho[1:, 0] * (vxc1[1:] + b_fsm))
        rhoeps[1] = np.sum(wgt[1:] * drdi[1:] * rho[1:, 1] * exc[1:])
        rhomu[1] = np.sum(wgt[1:] * drdi[1:] * rho[1:, 1] * (vxc2[1:] - b_fsm))
    return rho0, rhoeps, rhomu


# ------------------------------------------------------- shooting machinery
def fctp0(l: int, rofi: np.ndarray, v: np.ndarray, z: float):
    """Initialise classical-turning-point search (FCTP0 :2134-2180)."""
    nr = rofi.shape[0]
    fllp1 = l * (l + 1)
    ir = 9  # Fortran IR=10
    r = rofi[ir]
    x = fllp1 / r / r - 2.0 * z / r + v[ir]
    while True:
        ir += 1
        xlast = x
        r = rofi[ir]
        x = fllp1 / r / r - 2.0 * z / r + v[ir]
        if x > xlast or ir >= nr - 1:
            break
    nctp0 = ir - 1  # 0-based index of Fortran IR-1
    xmin = xlast
    r = rofi[nr - 1]
    xrim = fllp1 / r / r - 2.0 * z / r + v[nr - 1]
    if xmin >= xrim - 3.0:
        nctp0 = nr - 1
        xmin = xrim
    nsave = (nctp0 + nr - 1) // 2
    return nctp0, xrim, xmin, nsave


def fctp(e, nctp0, xrim, xmin, nsave, l, rofi, v, z, a, b):
    """Find classical turning point for energy e (FCTP :2182-2257)."""
    nr = rofi.shape[0]
    fllp1 = l * (l + 1)
    if nctp0 == nr - 1 or e > xrim:
        return nr - 1, nsave
    if e < xmin:
        return 1, nsave
    n1 = nctp0
    n2 = nr - 1
    nctp = nsave
    nlast = -10
    for _ in range(20):
        if nctp > n2 or nctp < n1:
            nctp = (n1 + n2 + 3) // 2 - 1  # Fortran (N1+N2+1)/2 on 1-based
        r = rofi[nctp]
        vme = v[nctp] - e
        # the reference reads V(NCTP+1) even at NCTP==NR (out of bounds,
        # benign UB); clamp instead — only the Newton step guess is affected
        dvdr = (v[min(nctp + 1, nr - 1)] - v[nctp - 1]) / (2.0 * a * (r + b))
        fofr = fllp1 / r / r - 2.0 * z / r + vme
        dfdr = -2.0 * fllp1 / r**3 + 2.0 * z / r**2 + dvdr
        rtry = max(r - fofr / dfdr, rofi[1])
        fntry = np.log(rtry / b + 1.0) / a + 1.0
        ntry = int(fntry + 0.5) - 1  # to 0-based
        if nlast == nctp:
            break
        if fofr > 0.0:
            n2 = nctp
        if fofr < 0.0:
            n1 = nctp
        nlast = nctp
        nctp = ntry
    if nctp == nctp0 + 1:
        nctp = 1
    return nctp, nctp


def rsqsr1(e, l, z, v, kr, a, b, rofi, g):
    """Outward integration to point kr (0-based), filling g[:kr+1, :2].

    Returns (val, slo, nn).  Exact port of RSQSR1 :2259-2338.
    """
    nn = 0
    zz = z + z
    c = C_LIGHT
    fllp1 = l * (l + 1.0)
    r83sq = 64.0 / 9.0
    r1 = 1.0 / 9.0
    r2 = -5.0 * r1
    r3 = 19.0 * r1
    h83 = 8.0 / 3.0
    if z < 0.9:
        s = l + 1.0
        sf = float(l)
        g0 = 1.0
        f0 = l / c
    else:
        aa = zz / c
        s = np.sqrt(fllp1 + 1.0 - aa * aa)
        sf = s
        g0 = 1.0
        f0 = g0 * (s - 1.0) / aa
    g[0, 0] = 0.0
    g[0, 1] = 0.0
    d = np.zeros((2, 3))
    for k in (1, 2, 3):
        r = rofi[k]
        drdi = a * (r + b)
        g[k, 0] = (r**s) * g0
        g[k, 1] = (r**sf) * f0
        d[0, k - 1] = drdi * g[k, 0] * s / r
        d[1, k - 1] = drdi * g[k, 1] * sf / r
    dg1, dg2, dg3 = d[0]
    df1, df2, df3 = d[1]
    for k in range(4, kr + 1):
        r = rofi[k]
        drdi = a * (r + b)
        phi = (e + zz / r - v[k]) * drdi / c
        u = drdi * c + phi
        x = -drdi / r
        y = -fllp1 * x * x / u + phi
        det = r83sq - x * x + u * y
        b1 = g[k - 1, 0] * h83 + r1 * dg1 + r2 * dg2 + r3 * dg3
        b2 = g[k - 1, 1] * h83 + r1 * df1 + r2 * df2 + r3 * df3
        g[k, 0] = (b1 * (h83 - x) + b2 * u) / det
        g[k, 1] = (b2 * (h83 + x) - b1 * y) / det
        if g[k, 0] * g[k - 1, 0] < 0.0:
            nn += 1
        dg1, dg2 = dg2, dg3
        dg3 = u * g[k, 1] - x * g[k, 0]
        df1, df2 = df2, df3
        df3 = x * g[k, 1] - y * g[k, 0]
    val = g[kr, 0]
    slo = dg3 / (a * (rofi[kr] + b))
    return val, slo, nn


def rsqsr2(e, l, z, v, k1, k2, val1, slo1, a, b, rofi, g):
    """Inward integration from k1 (0-based); cutoff kc at first maximum
    (but kc >= k2).  Fills g[kc:k1+1].  Port of RSQSR2 :2340-2473."""
    nn = 0
    zz = z + z
    c = C_LIGHT
    fllp1 = l * (l + 1.0)
    r83sq = 64.0 / 9.0
    r1 = 1.0 / 9.0
    r2 = -5.0 * r1
    r3 = 19.0 * r1
    h83 = -8.0 / 3.0
    ea = np.exp(a)
    rpb = b * np.exp(a * (k1 + 1) - a)  # Fortran K1 is 1-based
    r = rpb - b
    dr = a * rpb
    phi = (e + zz / r - v[k1]) * dr / c
    u = dr * c + phi
    x = -dr / r
    y = -fllp1 * x * x / u + phi
    g[k1, 0] = val1
    g[k1, 1] = (slo1 * dr + x * val1) / u
    q = 1.0 / np.sqrt(ea)
    ag1 = slo1 * dr
    af1 = x * g[k1, 1] - y * g[k1, 0]
    k = k1
    dg3 = ag1
    if k2 != k1:
        d = np.zeros((2, 3))
        hit_k2 = False
        for i in range(3):
            kp1 = k
            k -= 1
            rpb *= q
            dr = rpb * a
            r = rpb - b
            gg = g[kp1, 0] - 0.5 * ag1
            ff = g[kp1, 1] - 0.5 * af1
            vb = (3.0 * v[kp1] + 6.0 * v[k] - v[k - 1]) * 0.125
            phi = (e + zz / r - vb) * dr / c
            u = dr * c + phi
            x = -dr / r
            y = -fllp1 * x * x / u + phi
            ag2 = u * ff - x * gg
            af2 = x * ff - y * gg
            gg = g[kp1, 0] - 0.5 * ag2
            ff = g[kp1, 1] - 0.5 * af2
            ag3 = u * ff - x * gg
            af3 = x * ff - y * gg
            rpb *= q
            dr = a * rpb
            r = rpb - b
            phi = (e + zz / r - v[k]) * dr / c
            u = dr * c + phi
            x = -dr / r
            y = -fllp1 * x * x / u + phi
            gg = g[kp1, 0] - ag3
            ff = g[kp1, 1] - af3
            g[k, 0] = g[kp1, 0] - (ag1 + 2.0 * (ag2 + ag3) + u * ff - x * gg) / 6.0
            g[k, 1] = g[kp1, 1] - (af1 + 2.0 * (af2 + af3) + x * ff - y * gg) / 6.0
            if g[k, 0] * g[kp1, 0] < 0.0:
                nn += 1
            ag1 = u * g[k, 1] - x * g[k, 0]
            af1 = x * g[k, 1] - y * g[k, 0]
            if k == k2:
                hit_k2 = True
                dg3 = ag1
                break
            d[0, i] = ag1
            d[1, i] = af1
        if not hit_k2:
            qq = 1.0 / ea
            dg1, dg2, dg3 = d[0]
            df1, df2, df3 = d[1]
            while True:
                kp1 = k
                k -= 1
                rpb *= qq
                dr = a * rpb
                r = rpb - b
                phi = (e + zz / r - v[k]) * dr / c
                u = dr * c + phi
                x = -dr / r
                y = -fllp1 * x * x / u + phi
                det = r83sq - x * x + u * y
                b1 = g[kp1, 0] * h83 + r1 * dg1 + r2 * dg2 + r3 * dg3
                b2 = g[kp1, 1] * h83 + r1 * df1 + r2 * df2 + r3 * df3
                g[k, 0] = (b1 * (h83 - x) + b2 * u) / det
                g[k, 1] = (b2 * (h83 + x) - b1 * y) / det
                if g[k, 0] * g[kp1, 0] < 0.0:
                    nn += 1
                dg1, df1 = dg2, df2
                dg2, df2 = dg3, df3
                dg3 = u * g[k, 1] - x * g[k, 0]
                df3 = x * g[k, 1] - y * g[k, 0]
                if (k + 1) % 2 != 0:  # Fortran mod(K,2)/=0 with 1-based K
                    if k <= k2 or g[k, 0] * dg3 >= 0.0:
                        break
    kc = k
    val = g[kc, 0]
    slo = dg3 / (a * (rofi[kc] + b))
    return val, slo, nn, kc


def rseqsr(eb1, eb2, e, tol, z, l, nod, val, slo, v, a, b, rofi, nr, g):
    """Solve the radial scalar-relativistic equation to given BCs and node
    count; normalise g to 1.  Port of RSEQSR :1870-2020.

    Returns (e, q, nre).  ``g`` is an (nr, 2) array filled in place.
    """
    nitmax = 400
    c = C_LIGHT
    e1, e2 = eb1, eb2
    nctp0, xrim, xmin, nsave = fctp0(l, rofi, v, z)
    nit = 0
    de = 0.0
    ratio = 1.0
    kc = 0
    nre = nr - 1
    while True:
        nit += 1
        if nit > nitmax:
            return e, 0.0, nre + 1
        if e <= e1 or e >= e2:
            e = 0.5 * (e1 + e2)
        nctp, nsave = fctp(e, nctp0, xrim, xmin, nsave, l, rofi, v, z, a, b)
        re = 15.0 * rofi[nctp]
        nre_f = int(np.log(re / b + 1.0) / a + 1.0)  # 1-based estimate
        nre_f = (nre_f // 2) * 2 + 1
        nre_f = max(35, min(nre_f, nr))
        nre = nre_f - 1  # 0-based last point
        valu = val
        slop = slo
        if nre < nr - 1:
            valu = 1.0e-5
            slop = -1.0e-5
        k2 = 29  # Fortran K2=30 (1-based)
        if nod == 0:
            k2 = nre_f // 3 - 1
        if valu * slop > 0.0 and nod == 0:
            k2 = nre - 10
        val2, slo2, nod2, kc = rsqsr2(e, l, z, v, nre, k2, valu, slop, a, b, rofi, g)
        val1, slo1, nod1 = rsqsr1(e, l, z, v, kc, a, b, rofi, g)
        node = nod1 + nod2
        if node != nod:
            if node > nod:
                e2 = e
            if node < nod:
                e1 = e
            e = 0.5 * (e1 + e2)
        else:
            ratio = val2 / val1
            q = 0.0
            for k in range(1, kc + 1):
                q += (rofi[k] + b) * g[k, 0] ** 2
            q *= ratio * ratio
            for k in range(kc + 1, nre + 1):
                q += (rofi[k] + b) * g[k, 0] ** 2
            q = a * (q - 0.5 * (rofi[nre] + b) * g[nre, 0] ** 2)
            de = -val2 * (slo2 - ratio * slo1) / q
            if de > 0.0:
                e1 = e
            if de < 0.0:
                e2 = e
            e = e + de
            if abs(de) <= tol or nit >= nitmax:
                break
    # normalise
    fllp1 = l * (l + 1)
    e = e - de
    g[: kc + 1] *= ratio
    q = 0.0
    wgt = 1.0
    rhok = 0.0
    for k in range(1, nre + 1):
        r = rofi[k]
        wgt = ((k + 2) % 2 + 1) * (r + b)  # Fortran mod(K+1,2) with 1-based K
        tmcr = (c - (v[k] - 2.0 * z / r - e) / c) * r
        rhok = g[k, 0] ** 2 * (1.0 + fllp1 / tmcr**2) + g[k, 1] ** 2
        q += wgt * rhok
    q = (q - 0.5 * wgt * rhok) * a * 2.0 / 3.0
    fac = 1.0 / np.sqrt(q)
    g[: nre + 1] *= fac
    g[nre + 1 :] = 0.0
    return e, q, nre + 1  # nre returned 1-based (count of points)


def gintsr(g1, g2, a, b, nr, z, e, l, v, rofi):
    """Scalar-relativistic scalar product (GINTSR :2085-2131)."""
    fllp1 = l * (l + 1)
    c = C_LIGHT
    s = 0.0
    for k in range(1, nr - 1, 2):
        r = rofi[k]
        tmc = c - (v[k] - 2.0 * z / r - e) / c
        gfac = 1.0 + fllp1 / (tmc * r) ** 2
        s += (r + b) * (g1[k, 0] * g2[k, 0] * gfac + g1[k, 1] * g2[k, 1])
    s += s
    for k in range(2, nr - 2, 2):
        r = rofi[k]
        tmc = c - (v[k] - 2.0 * z / r - e) / c
        gfac = 1.0 + fllp1 / (tmc * r) ** 2
        s += (r + b) * (g1[k, 0] * g2[k, 0] * gfac + g1[k, 1] * g2[k, 1])
    s += s
    r = rofi[nr - 1]
    tmc = c - (v[nr - 1] - 2.0 * z / r - e) / c
    gfac = 1.0 + fllp1 / (tmc * r) ** 2
    s += (r + b) * (g1[nr - 1, 0] * g2[nr - 1, 0] * gfac + g1[nr - 1, 1] * g2[nr - 1, 1])
    return s * a / 3.0


def phdfsr(z, l, v, e, a, b, rofi, nr, g, val, slo, tol, nn):
    """Energy derivatives phidot/phidotdot by numerical differentiation
    (PHDFSR :2022-2084).  Returns (gp, gpp, phi, dphi, phip, dphip, p)."""
    rmax = rofi[nr - 1]
    eb1, eb2 = -50.0, 15.0
    dele = 0.003
    ddde = -rmax / g[nr - 1, 0] ** 2
    ddl = dele * ddde
    slo1 = slo - ddl * val / rmax
    slo2 = slo + ddl * val / rmax
    gp = np.zeros((nr, 2))
    gpp = np.zeros((nr, 2))
    e1, sum1, _ = rseqsr(eb1, eb2, e, tol, z, l, nn, val, slo1, v, a, b, rofi, nr, gp)
    val1 = val / np.sqrt(sum1)
    slo1 = slo1 / np.sqrt(sum1)
    e2, sum2, _ = rseqsr(eb1, eb2, e, tol, z, l, nn, val, slo2, v, a, b, rofi, nr, gpp)
    val2 = val / np.sqrt(sum2)
    slo2 = slo2 / np.sqrt(sum2)
    x1 = e1 - e
    x2 = e2 - e
    den = x1 * x2 * (x1 - x2)
    wp0 = (x2**2 - x1**2) / den
    wp1 = -(x2**2) / den
    wp2 = x1**2 / den
    wpp0 = 2.0 * (x1 - x2) / den
    wpp1 = 2.0 * x2 / den
    wpp2 = -2.0 * x1 / den
    gp_new = wp0 * g + wp1 * gp + wp2 * gpp
    gpp_new = wpp0 * g + wpp1 * gp + wpp2 * gpp
    gp[:] = gp_new
    gpp[:] = gpp_new
    vlp = wp0 * val + wp1 * val1 + wp2 * val2
    slp = wp0 * slo + wp1 * slo1 + wp2 * slo2
    p = gintsr(gp, gp, a, b, nr, z, e, l, v, rofi)
    phi = val / rmax
    dphi = slo / rmax - val / rmax / rmax
    phip = vlp / rmax
    dphip = (slp - vlp / rmax) / rmax
    return gp, gpp, phi, dphi, phip, dphip, p
