"""Exchange-correlation potentials on the radial mesh.

Re-implements the reference ``source/xc.f90`` XCPOT dispatch: the LDA
functionals (txc 1 von Barth-Hedin [default], 2 Slater X-alpha, 3 BHJ,
4 Vosko-Wilk-Nusair, 6 Wigner, 7 Perdew-Zunger CA, 11 ASW-BH) and the
gradient family (txc 5 PBE/LDA limit, 8 PBE-GGA, 9 Local Airy Gas +
PBE correlation) via ``PBEGGA``/``EXCHPBE``/``CORPBE``/``exchlag``/
``GCOR2`` (xc.f90 :424-1054).  Argument convention matches the reference
call from VXC0SP: rho1 = minority(down) density, rho2 = majority(up)
density, rho = total; returns (v_down, v_up, exc).  Rydberg units.
"""

from __future__ import annotations

import numpy as np

TOLD = 1.0e-20
OTH = 1.0 / 3.0
FTH = 4.0 / 3.0


class XCFunctional:
    def __init__(self, txc: int = 1, nsp: int = 2):
        self.txc = txc
        if txc in (1, 3, 11):
            if txc == 1:  # von Barth-Hedin J. Phys. C5, 1629 (1972)
                self.xccp, self.xccf = 0.0504, 0.0254
                self.xcrp, self.xcrf = 30.0, 75.0
            elif txc == 3:  # Barth-Hedin-Janak PRB 12, 1257 (1975)
                self.xccp, self.xccf = 0.045, 0.0225
                self.xcrp, self.xcrf = 21.0, 53.0
            else:  # ASW variant
                self.xccp, self.xccf = 0.0450, 0.0225
                self.xcrp, self.xcrf = 21.0, 52.9167
            self.aa = 0.5**OTH
            self.bb = 1.0 - self.aa
        elif txc == 2:
            self.xalpha = 6.0 * 1.0 * (3.0 / (4.0 * np.pi)) ** OTH
        elif txc == 6:
            self.aw = 0.916 * 4.0 / 3.0
            self.bw = 0.88 * 4.0 / 3.0
            self.cw = 0.88 * 7.8 / 3.0
        elif txc == 7:
            self.aca, self.bca = 1.0529, 0.3334
            self.cca = 7.0 * self.aca / 6.0
            self.dca = 4.0 * self.bca / 3.0
            self.fca = 4.0 / 3.0
            self.oca, self.pca, self.qca, self.rca = 0.096, 0.0622, 0.0232, 0.004
            self.sca = self.oca + self.pca / 3.0
            self.tca = (2.0 * self.qca + self.rca) / 3.0

    def xcpot(self, rho1, rho2, rho, rhop=None, rhopp=None, rr=None):
        """Vectorised over radial points.  rho1/rho2/rho are arrays (or
        scalars); returns (v1, v2, exc) with v1 paired to rho1.  For the
        gradient functionals (txc 5/8/9) rhop/rhopp are the per-slot
        density derivatives and rr the radius argument, exactly as the
        reference VXC0SP prepares them."""
        rho1 = np.asarray(rho1, dtype=np.float64)
        rho2 = np.asarray(rho2, dtype=np.float64)
        rho = np.asarray(rho, dtype=np.float64)
        bad = (rho1 < TOLD) | (rho2 < TOLD)
        rho1s = np.where(bad, 1.0, rho1)
        rho2s = np.where(bad, 1.0, rho2)
        rhos = np.where(bad, 1.0, rho)
        rs1 = ((4.0 * np.pi) * rhos / 3.0) ** OTH
        rs = 1.0 / rs1
        txc = self.txc
        if txc in (5, 8, 9):
            if rhop is None:
                rhop = (np.zeros_like(rho1s), np.zeros_like(rho2s))
                rhopp = rhop
                rr = np.ones_like(rho1s)
            lgga = 1 if txc == 8 else 0
            fx = exchlag if txc == 9 else exchpbe
            v1, v2, exc = pbegga(
                (rho1s, rho2s), rhop, rhopp, rr, lgga, fx
            )
        elif txc == 2:
            exc = -0.75 * self.xalpha * (0.5 * rhos) ** OTH
            v1 = -self.xalpha * rho1s**OTH
            v2 = -self.xalpha * rho2s**OTH
        elif txc == 4:
            v1, v2, exc = self._vwn(rho1s, rho2s, rhos, rs)
        elif txc == 6:
            rs78 = 1.0 / (rs + 7.8)
            exc = -0.916 * rs1 - 0.88 * rs78
            v1 = self.cw * rs78 * rs78 - self.aw * rs1 - self.bw * rs78
            v2 = v1
        elif txc == 7:
            v1, v2, exc = self._pz(rs, rs1)
        else:  # von Barth-Hedin family (1, 3, 11, default)
            rsf = rs / self.xcrf
            rsp = rs / self.xcrp
            fcf = (1.0 + rsf**3) * np.log(1.0 + 1.0 / rsf) + 0.5 * rsf - rsf**2 - OTH
            fcp = (1.0 + rsp**3) * np.log(1.0 + 1.0 / rsp) + 0.5 * rsp - rsp**2 - OTH
            epscp = -self.xccp * fcp
            epscf = -self.xccf * fcf
            epsxp = -0.91633059 / rs
            cny = 5.1297628 * (epscf - epscp)
            x = rho1s / rhos
            fx = (x**FTH + (1.0 - x) ** FTH - self.aa) / self.bb
            exc = epsxp + epscp + fx * (cny + FTH * epsxp) / 5.1297628
            ars = -1.22177412 / rs + cny
            brs = -self.xccp * np.log(1.0 + self.xcrp / rs) - cny
            v1 = ars * (2.0 * x) ** OTH + brs
            v2 = ars * (2.0 * rho2s / rhos) ** OTH + brs
        z = np.zeros_like(rhos)
        return (np.where(bad, z, v1), np.where(bad, z, v2), np.where(bad, z, exc))

    def _vwn(self, rho1, rho2, rho, rs):
        ap, af = 0.0621814, 0.0310907
        bp, bf = 3.72744, 7.060428
        cp, cf = 12.9352, 18.0578
        cp1, cp2, cp3 = 1.2117833, 1.1435257, -0.031167608
        cf1, cf2, cf3 = 2.9847935, 2.7100059, -0.1446006
        qp, qf = 6.1519908, 4.7309269
        xp0, xf0 = -0.10498, -0.32500
        aa = 2.0**FTH - 2.0
        x = np.sqrt(rs)
        xpx = x * x + bp * x + cp
        xfx = x * x + bf * x + cf
        s = (rho2 - rho1) / rho
        sp = 1.0 + s
        sm = 1.0 - s
        s4 = s**4 - 1.0
        fs = (sp**FTH + sm**FTH - 2.0) / aa
        beta = 1.0 / (2.74208 + 3.182 * x + 0.09873 * x * x + 0.18268 * x**3)
        dfs = FTH * (sp**OTH - sm**OTH) / aa
        dbeta = -(0.27402 * x + 0.09873 + 1.591 / x) * beta**2
        atnp = np.arctan(qp / (2.0 * x + bp))
        atnf = np.arctan(qf / (2.0 * x + bf))
        ecp = ap * (np.log(x * x / xpx) + cp1 * atnp
                    - cp3 * (np.log((x - xp0) ** 2 / xpx) + cp2 * atnp))
        ecf = af * (np.log(x * x / xfx) + cf1 * atnf
                    - cf3 * (np.log((x - xf0) ** 2 / xfx) + cf2 * atnf))
        ec = ecp + fs * (ecf - ecp) * (1.0 + s4 * beta)
        tp1 = (x * x + bp * x) / xpx
        tf1 = (x * x + bf * x) / xfx
        ucp = ecp - ap / 3.0 * (1.0 - tp1 - cp3 * (x / (x - xp0) - tp1 - xp0 * x / xpx))
        ucf = ecf - af / 3.0 * (1.0 - tf1 - cf3 * (x / (x - xf0) - tf1 - xf0 * x / xfx))
        uc0 = ucp + (ucf - ucp) * fs
        uc20 = uc0 + (ecf - ecp) * sm * dfs
        uc10 = uc0 - (ecf - ecp) * sp * dfs
        duc = (ucf - ucp) * beta * s4 * fs + (ecf - ecp) * (-rs / 3.0) * dbeta * s4 * fs
        duc2 = duc + (ecf - ecp) * beta * sm * (4.0 * s**3 * fs + s4 * dfs)
        duc1 = duc - (ecf - ecp) * beta * sp * (4.0 * s**3 * fs + s4 * dfs)
        uc1 = uc10 + duc1
        uc2 = uc20 + duc2
        epx = -0.91633059 / rs * (1.0 + FTH * fs / 5.1297628)
        amyx2 = -1.22177412 / rs * sp**OTH
        amyx1 = -1.22177412 / rs * sm**OTH
        return uc1 + amyx1, uc2 + amyx2, ec + epx

    def _pz(self, rs, rs1):
        ex = -0.9164 * rs1
        big = rs >= 1.0
        sqrtrs = np.sqrt(np.where(big, rs, 1.0))
        denom1 = 1.0 / (1.0 + self.aca * sqrtrs + self.bca * rs)
        ec_b = -0.2846 * denom1
        v_b = self.fca * ex + ec_b * (1.0 + self.cca * sqrtrs + self.dca * rs) * denom1
        rslog = np.log(np.where(big, 1.0, rs))
        rsln = rs * rslog
        ec_s = -self.oca + self.pca * rslog - self.qca * rs + self.rca * rsln
        v_s = self.fca * ex - self.sca + self.pca * rslog - self.tca * rs + self.uca * rsln
        exc = ex + np.where(big, ec_b, ec_s)
        v = np.where(big, v_b, v_s)
        return v, v, exc


# ----------------------------------------------------------------------
# Gradient family (xc.f90 :424-1054), vectorised over mesh points.
# ----------------------------------------------------------------------

def radgra(a: float, b: float, rofi: np.ndarray, f: np.ndarray
           ) -> np.ndarray:
    """Radial gradient on the exponential mesh r_i = b(e^{a(i-1)} - 1)
    (``self.f90 radgra`` :2789-2839): 7-point forward differences at the
    first two points, 5-point central in the bulk, one-sided at the end.
    """
    nr = f.shape[0]
    g = np.zeros_like(f)
    g[0] = ((6.0 * f[1] + 20.0 / 3.0 * f[3] + 1.2 * f[5])
            - (2.45 * f[0] + 7.5 * f[2] + 3.75 * f[4] + f[6] / 6.0)) / a
    g[1] = ((6.0 * f[2] + 20.0 / 3.0 * f[4] + 1.2 * f[6])
            - (2.45 * f[1] + 7.5 * f[3] + 3.75 * f[5] + f[7] / 6.0)) / a
    g[2:nr - 2] = ((f[:nr - 4] + 8.0 * f[3:nr - 1])
                   - (8.0 * f[1:nr - 3] + f[4:])) / 12.0 / a
    g[nr - 2] = (-f[nr - 5] / 12.0 + 0.5 * f[nr - 4] - 1.5 * f[nr - 3]
                 + 5.0 / 6.0 * f[nr - 2] + 0.25 * f[nr - 1]) / a
    g[nr - 1] = (0.25 * f[nr - 5] - 4.0 / 3.0 * f[nr - 4]
                 + 3.0 * f[nr - 3] - 4.0 * f[nr - 2]
                 + 25.0 / 12.0 * f[nr - 1]) / a
    return g / (rofi + b)


def gcor2(a, a1, b1, b2, b3, b4, rtrs):
    """PW92 correlation interpolation (``GCOR2``)."""
    q0 = -2.0 * a * (1.0 + a1 * rtrs * rtrs)
    q1 = 2.0 * a * rtrs * (b1 + rtrs * (b2 + rtrs * (b3 + b4 * rtrs)))
    q2 = np.log(1.0 + 1.0 / q1)
    gg = q0 * q2
    q3 = a * (b1 / rtrs + 2.0 * b2 + rtrs * (3.0 * b3 + 4.0 * b4 * rtrs))
    ggrs = -2.0 * a * a1 * q2 - q0 * q3 / (q1 * (1.0 + q1))
    return gg, ggrs


def exchpbe(rho, s, u, v, lgga):
    """PBE exchange per spin channel (``EXCHPBE``), Hartree units."""
    ax = -0.738558766382022405884230032680836
    um, uk = 0.2195149727645171, 0.8040
    ul = um / uk
    exunif = ax * rho ** (1.0 / 3.0)
    if lgga == 0:
        return exunif, exunif * (4.0 / 3.0)
    s2 = s * s
    p0 = 1.0 + ul * s2
    fxpbe = 1.0 + uk - uk / p0
    ex = exunif * fxpbe
    fs = 2.0 * uk * ul / (p0 * p0)
    fss = -4.0 * ul * s * fs / p0
    vx = exunif * ((4.0 / 3.0) * fxpbe
                   - (u - (4.0 / 3.0) * s2 * s) * fss - v * fs)
    return ex, vx


def exchlag(rho, s, u, v, lgga):
    """Local Airy Gas exchange (``exchlag``); always gradient-corrected
    (the reference's LDA branch is commented out)."""
    ax = -0.738558766382
    a1, a2, a3, a4 = 0.041106, 0.092070, 0.657946, 2.626712
    exunif = ax * rho ** (1.0 / 3.0)
    s = np.where(np.abs(s) < 1e-30, 1e-30, s)
    s4 = s ** a4
    xs = a1 * s4
    zs = 1.0 + a2 * s4
    ys = zs ** a3
    fxlag = 1.0 + xs / ys
    ex = exunif * fxlag
    xsd = a4 * xs / s
    xsdd = (a4 - 1.0) * xsd / s
    zsd = a2 * xsd / a1
    zsdd = a2 * xsdd / a1
    ysd = a3 * ys * zsd / zs
    ysdd = (a3 - 1.0) * ysd * zsd / zs + ysd * zsdd / zsd
    fs = (xsd / ys - xs * ysd / ys / ys) / s
    fss = (xsdd / ys - 2.0 * xsd * ysd / ys / ys
           + 2.0 * xs * ysd * ysd / ys**3 - xs * ysdd / ys / ys)
    fss = (fss - fs) / s
    vx = exunif * ((4.0 / 3.0) * fxlag
                   - (u - (4.0 / 3.0) * s * s * s) * fss - v * fs)
    return ex, vx


def corpbe(rs, zet, t, uu, vv, ww, lgga):
    """PBE correlation + PW92 LSD part (``CORPBE``), Hartree units.

    Returns (ec, vcup, vcdn, h, dvcup, dvcdn)."""
    thrd = 1.0 / 3.0
    gam = 0.5198420997897463295344212145565
    fzz = 8.0 / (9.0 * gam)
    gamma = 0.03109069086965489503494086371273
    bet = 0.06672455060314922
    delt = bet / gamma
    eta = 1.0e-12
    rtrs = np.sqrt(rs)
    eu, eurs = gcor2(0.0310907, 0.21370, 7.5957, 3.5876, 1.6382,
                     0.49294, rtrs)
    ep, eprs = gcor2(0.01554535, 0.20548, 14.1189, 6.1977, 3.3662,
                     0.62517, rtrs)
    alfm, alfrsm = gcor2(0.0168869, 0.11125, 10.357, 3.6231, 0.88026,
                         0.49671, rtrs)
    z4 = zet**4
    f = ((1.0 + zet) ** (4 * thrd) + (1.0 - zet) ** (4 * thrd) - 2.0) / gam
    ec = eu * (1.0 - f * z4) + ep * f * z4 - alfm * f * (1.0 - z4) / fzz
    ecrs = (eurs * (1.0 - f * z4) + eprs * f * z4
            - alfrsm * f * (1.0 - z4) / fzz)
    fz = (4 * thrd) * ((1.0 + zet) ** thrd - (1.0 - zet) ** thrd) / gam
    eczet = (4.0 * zet**3 * f * (ep - eu + alfm / fzz)
             + fz * (z4 * ep - z4 * eu - (1.0 - z4) * alfm / fzz))
    comm = ec - rs * ecrs / 3.0 - zet * eczet
    vcup = comm + eczet
    vcdn = comm - eczet
    if lgga == 0:
        z = np.zeros_like(ec)
        return ec, vcup, vcdn, z, z, z
    g = ((1.0 + zet) ** (2 * thrd) + (1.0 - zet) ** (2 * thrd)) / 2.0
    g3 = g**3
    pon = -ec / (g3 * gamma)
    b = delt / (np.exp(pon) - 1.0)
    b2 = b * b
    t2 = t * t
    t4 = t2 * t2
    q4 = 1.0 + b * t2
    q5 = 1.0 + b * t2 + b2 * t4
    h = g3 * (bet / delt) * np.log(1.0 + delt * q4 * t2 / q5)
    g4 = g3 * g
    t6 = t4 * t2
    rsthrd = rs / 3.0
    gz = (((1.0 + zet) ** 2 + eta) ** (-thrd / 2.0)
          - ((1.0 - zet) ** 2 + eta) ** (-thrd / 2.0)) / 3.0
    fac = delt / b + 1.0
    bg = -3.0 * b2 * ec * fac / (bet * g4)
    bec = b2 * fac / (bet * g3)
    q8 = q5 * q5 + delt * q4 * q5 * t2
    q9 = 1.0 + 2.0 * b * t2
    h_b = -bet * g3 * b * t6 * (2.0 + b * t2) / q8
    h_rs = -rsthrd * h_b * bec * ecrs
    fact0 = 2.0 * delt - 6.0 * b
    fact1 = q5 * q9 + q4 * q9 * q9
    h_bt = 2.0 * bet * g3 * t4 * ((q4 * q5 * fact0 - delt * fact1) / q8) / q8
    h_rst = rsthrd * t2 * h_bt * bec * ecrs
    h_z = 3.0 * gz * h / g + h_b * (bg * gz + bec * eczet)
    h_t = 2.0 * bet * g3 * q9 / q8
    h_zt = 3.0 * gz * h_t / g + h_bt * (bg * gz + bec * eczet)
    fact2 = q4 * q5 + b * t2 * (q4 * q9 + q5)
    fact3 = 2.0 * b * q5 * q9 + delt * fact2
    h_tt = 4.0 * bet * g3 * t * (2.0 * b / q8 - (q9 * fact3 / q8) / q8)
    comm = h + h_rs + h_rst + t2 * h_t / 6.0 + 7.0 * t2 * t * h_tt / 6.0
    pref = h_z - gz * t2 * h_t / g
    fact5 = gz * (2.0 * h_t + t * h_tt) / g
    comm = comm - pref * zet - uu * h_tt - vv * h_t - ww * (h_zt - fact5)
    return ec, vcup, vcdn, h, comm + pref, comm - pref


def pbegga(n2, nd2, ndd2, r, lgga, fx=exchpbe):
    """PBE / LAG driver (``PBEGGA``/``LAGGGA`` :424-884): spin-resolved
    exchange + PW92/PBE correlation on the transformed radial
    derivatives.  n2/nd2/ndd2: per-slot (density, d/dr, d2/dr2) pairs;
    returns (v_slot1, v_slot2, exc) in Rydberg."""
    oth = 1.0 / 3.0
    n = [np.asarray(n2[0], float), np.asarray(n2[1], float)]
    nd = [np.asarray(nd2[0], float), np.asarray(nd2[1], float)]
    ndd = [np.asarray(ndd2[0], float), np.asarray(ndd2[1], float)]
    r = np.asarray(r, float)
    ex = np.zeros_like(n[0])
    vx = [None, None]
    for i in range(2):
        ni = 2.0 * n[i]
        ndi = 2.0 * nd[i]
        nddi = 2.0 * ndd[i]
        if fx is exchlag:
            ndi = np.where(np.abs(ndi) < 1e-15, 1e-15, ndi)
        kf = (3.0 * np.pi**2 * ni) ** oth
        nabla = np.abs(ndi)
        s = 0.5 * nabla / kf / ni
        nabla2 = 2.0 / r * ndi + nddi
        t = nabla2 / 4.0 / kf / kf / ni
        u = nabla * nddi / 8.0 / kf**3 / ni / ni
        exi, muxi = fx(ni, s, u, t, lgga)
        vx[i] = muxi
        ex = ex + n[i] * exi
    ni = n[0] + n[1]
    ndi = nd[0] + nd[1]
    nddi = ndd[0] + ndd[1]
    zet = (n[0] - n[1]) / ni
    g = ((1.0 + zet) ** (2.0 / 3.0) + (1.0 - zet) ** (2.0 / 3.0)) / 2.0
    nabla = np.abs(ndi)
    nabla2 = 2.0 / r * ndi + nddi
    fk = (3.0 * np.pi**2 * ni) ** oth
    sk = np.sqrt(4.0 * fk / np.pi)
    t = nabla / 2.0 / sk / ni / g
    uu = nabla * nddi / (2.0 * sk * g) ** 3 / ni / ni
    vv = nabla2 / (2.0 * sk * g) ** 2 / ni
    ww = ((ndi * nd[0] - ndi * nd[1] - zet * ndi * ndi)
          / (2.0 * sk * g) ** 2 / ni / ni)
    rs = (3.0 / (4.0 * np.pi) / ni) ** oth
    ec, vcup, vcdn, h, dvcup, dvcdn = corpbe(rs, zet, t, uu, vv, ww, lgga)
    v1 = 2.0 * (vx[0] + vcup + dvcup)
    v2 = 2.0 * (vx[1] + vcdn + dvcdn)
    exc = 2.0 * ex / ni + 2.0 * (ec + h)
    return v1, v2, exc
