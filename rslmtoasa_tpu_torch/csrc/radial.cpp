// Native scalar-relativistic atomic-sphere solver.
//
// C++ twin of rslmtoasa_tpu/physics/{radial,atomsphere,xc_lda}.py (which is
// the validated readable reference implementation): exponential mesh,
// Numerov Hartree solve, LDA XC, shooting eigensolver, phidot/phidotdot,
// core+valence density, radial SCF loop, potential parameters and SOC
// strengths.  Mirrors the algorithms of the Fortran reference
// source/self.f90 + source/xc.f90 (see the Python docstrings for the
// file:line provenance).  Exposed through a plain C ABI for ctypes.
//
// Build: g++ -O2 -march=native -shared -fPIC radial.cpp -o libradial.so

#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr double C_LIGHT = 274.074;
constexpr double PI = 3.14159265358979323846;
constexpr int MIN_MESH = 25;

inline double sq(double x) { return x * x; }

// ----------------------------------------------------------------- mesh
int mesh_grid_size(double z, double ws_r, double a) {
    double b = 1.0 / (z + z + 1.0);
    int n = (int)(((0.5 + std::log(1.0 + ws_r / b) / a) * 2.0 - 1) / 2) * 2 + 1;
    return std::max(MIN_MESH, n);
}

double mesh_b(double ws_r, double a, int nr) {
    return ws_r / (std::exp(a * nr - a) - 1.0);
}

void radial_mesh(double a, double b, int nr, double* rofi) {
    double ea = std::exp(a), rpb = b;
    for (int i = 0; i < nr; ++i) { rofi[i] = rpb - b; rpb *= ea; }
}

// weights: 1/3 at ends, interior alternating 4/3, 2/3 (1-based Simpson)
inline double swgt(int i0, int nr) {  // i0 is 0-based
    if (i0 == 0 || i0 == nr - 1) return 1.0 / 3.0;
    return 2.0 * (((i0 + 2) % 2) + 1) / 3.0;
}

// ----------------------------------------------------------------- rho0
void rho0_guess(double z, double a, double b, int nr, double* rho /*nr x 2*/) {
    double ea = std::exp(a), rpb = b, s = 0.0;
    std::vector<double> ro(nr);
    for (int ir = 0; ir < nr; ++ir) {
        double r = rpb - b;
        ro[ir] = std::exp(-5.0 * r) * r * r;
        s += a * rpb * ro[ir];
        rpb *= ea;
    }
    double fac = z / (s * 2.0);
    for (int ir = 0; ir < nr; ++ir) {
        rho[ir * 2 + 0] = ro[ir] * fac;
        rho[ir * 2 + 1] = ro[ir] * fac;
    }
}

// --------------------------------------------------------------- poiss0
// rho: nr x 2 (row-major [ir*2+isp]); v out nr x 2; rhovh[2]; returns vsum
double poiss0(double z, double a, double b, const double* rofi,
              const double* rho, int nr, int nsp, double vhrmax,
              double* v, double* rhovh) {
    double rmax = rofi[nr - 1];
    double r2 = rofi[1], r3 = rofi[2], r4 = rofi[3];
    double f2 = 0, f3 = 0, f4 = 0;
    for (int s = 0; s < nsp; ++s) {
        f2 += rho[1 * 2 + s] / (r2 * r2);
        f3 += rho[2 * 2 + s] / (r3 * r3);
        f4 += rho[3 * 2 + s] / (r4 * r4);
    }
    double x23 = (r3 * r3 * f2 - r2 * r2 * f3) / (r3 - r2);
    double x34 = (r4 * r4 * f3 - r3 * r3 * f4) / (r4 - r3);
    double cc = (r2 * x34 - r4 * x23) / (r3 * (r2 - r4));
    double bb = ((r2 + r3) * x34 - (r3 + r4) * x23) / (r3 * r3 * (r4 - r2));
    double dd = (f2 - bb * r2 - cc) / (r2 * r2);

    double a2b4 = a * a / 4.0;
    v[0] = 1.0;
    double df = 0, g = 0, f = 0, y2 = 0, y3 = 0;
    for (int ir = 1; ir <= 2; ++ir) {
        double r = rofi[ir];
        double drdi = a * (r + b);
        double srdrdi = std::sqrt(drdi);
        v[ir * 2] = v[0] - r * r * (cc / 3.0 + r * bb / 6.0 + r * r * dd / 10.0);
        g = v[ir * 2] * r / srdrdi;
        f = g * (1.0 - a2b4 / 12.0);
        if (ir == 1) y2 = -2.0 * f2 * r2 * drdi * srdrdi;
        else y3 = -2.0 * f3 * r3 * drdi * srdrdi;
        df = f - df;
    }
    for (int ir = 3; ir < nr; ++ir) {
        double r = rofi[ir];
        double drdi = a * (r + b);
        double srdrdi = std::sqrt(drdi);
        double ro = 0;
        for (int s = 0; s < nsp; ++s) ro += rho[ir * 2 + s];
        double y4 = -2.0 * drdi * srdrdi * ro / r;
        df = df + g * a2b4 + (y4 + 10.0 * y3 + y2) / 12.0;
        f = f + df;
        g = f / (1.0 - a2b4 / 12.0);
        v[ir * 2] = g * srdrdi / r;
        y2 = y3; y3 = y4;
    }
    double vnow = v[(nr - 1) * 2] - 2.0 * z / rmax;
    for (int ir = 0; ir < nr; ++ir) v[ir * 2] += vhrmax - vnow;

    rhovh[0] = rhovh[1] = 0.0;
    double vsum = 0, vhat0 = 0;
    for (int ir = 1; ir < nr; ++ir) {
        double r = rofi[ir];
        double drdi = a * (r + b);
        double wgt = 2.0 * (((ir + 2) % 2) + 1) / 3.0;
        if (ir == nr - 1) wgt = 1.0 / 3.0;
        double ro = 0;
        for (int s = 0; s < nsp; ++s) {
            rhovh[s] += wgt * drdi * rho[ir * 2 + s] * (v[ir * 2] - 2.0 * z / r);
            ro += rho[ir * 2 + s];
        }
        vhat0 += wgt * drdi * ro * (1.0 / r - 1.0 / rmax);
        vsum += wgt * drdi * r * r * (v[ir * 2] - vhrmax);
    }
    vsum = 4.0 * PI * (vsum - z * rmax * rmax);
    vhat0 = 2.0 * vhat0 + 2.0 * z / rmax + vhrmax;
    v[0] = vhat0;
    if (nsp != 1)
        for (int ir = 0; ir < nr; ++ir) v[ir * 2 + 1] = v[ir * 2];
    return vsum;
}

// ------------------------------------------------------------------- XC
// Barth-Hedin family + X-alpha + VWN + Wigner + PZ.  Mirrors xc_lda.py;
// args: rho1 = down, rho2 = up, rho = total. outputs v1(down) v2(up) exc.
struct XC {
    int txc;
    double xccp, xccf, xcrp, xcrf, aa, bb, xalpha;
    double aw, bw, cw;
    double aca, bca, cca, dca, fca, oca, pca, qca, rca, sca, tca;
    explicit XC(int t) : txc(t) {
        const double OTH = 1.0 / 3.0;
        if (t == 1) { xccp = 0.0504; xccf = 0.0254; xcrp = 30.0; xcrf = 75.0; }
        else if (t == 3) { xccp = 0.045; xccf = 0.0225; xcrp = 21.0; xcrf = 53.0; }
        else { xccp = 0.0450; xccf = 0.0225; xcrp = 21.0; xcrf = 52.9167; }
        aa = std::pow(0.5, OTH);
        bb = 1.0 - aa;
        xalpha = 6.0 * std::pow(3.0 / (4.0 * PI), OTH);
        aw = 0.916 * 4.0 / 3.0; bw = 0.88 * 4.0 / 3.0; cw = 0.88 * 7.8 / 3.0;
        aca = 1.0529; bca = 0.3334; cca = 7.0 * aca / 6.0; dca = 4.0 * bca / 3.0;
        fca = 4.0 / 3.0; oca = 0.096; pca = 0.0622; qca = 0.0232; rca = 0.004;
        sca = oca + pca / 3.0; tca = (2.0 * qca + rca) / 3.0;
    }
    void pot(double rho1, double rho2, double rho,
             double* v1, double* v2, double* exc) const {
        const double TOLD = 1e-20, OTH = 1.0 / 3.0, FTH = 4.0 / 3.0;
        if (rho1 < TOLD || rho2 < TOLD) { *v1 = *v2 = *exc = 0.0; return; }
        double rs1 = std::pow(4.0 * PI * rho / 3.0, OTH);
        double rs = 1.0 / rs1;
        if (txc == 2) {
            *exc = -0.75 * xalpha * std::pow(0.5 * rho, OTH);
            *v1 = -xalpha * std::pow(rho1, OTH);
            *v2 = -xalpha * std::pow(rho2, OTH);
        } else if (txc == 4) {
            vwn(rho1, rho2, rho, rs, v1, v2, exc);
        } else if (txc == 6) {
            double rs78 = 1.0 / (rs + 7.8);
            *exc = -0.916 * rs1 - 0.88 * rs78;
            *v1 = cw * rs78 * rs78 - aw * rs1 - bw * rs78;
            *v2 = *v1;
        } else if (txc == 7) {
            double ex = -0.9164 * rs1, ec, v;
            if (rs >= 1.0) {
                double srs = std::sqrt(rs);
                double den = 1.0 / (1.0 + aca * srs + bca * rs);
                ec = -0.2846 * den;
                v = fca * ex + ec * (1.0 + cca * srs + dca * rs) * den;
            } else {
                double rl = std::log(rs), rln = rs * rl;
                ec = -oca + pca * rl - qca * rs + rca * rln;
                v = fca * ex - sca + pca * rl - tca * rs + (2.0 * rca / 3.0) * rln;
            }
            *exc = ex + ec; *v1 = *v2 = v;
        } else {  // Barth-Hedin family
            double rsf = rs / xcrf, rsp = rs / xcrp;
            double fcf = (1.0 + rsf * rsf * rsf) * std::log(1.0 + 1.0 / rsf)
                         + 0.5 * rsf - rsf * rsf - OTH;
            double fcp = (1.0 + rsp * rsp * rsp) * std::log(1.0 + 1.0 / rsp)
                         + 0.5 * rsp - rsp * rsp - OTH;
            double epscp = -xccp * fcp, epscf = -xccf * fcf;
            double epsxp = -0.91633059 / rs;
            double cny = 5.1297628 * (epscf - epscp);
            double x = rho1 / rho;
            double fx = (std::pow(x, FTH) + std::pow(1.0 - x, FTH) - aa) / bb;
            *exc = epsxp + epscp + fx * (cny + FTH * epsxp) / 5.1297628;
            double ars = -1.22177412 / rs + cny;
            double brs = -xccp * std::log(1.0 + xcrp / rs) - cny;
            *v1 = ars * std::pow(2.0 * x, OTH) + brs;
            *v2 = ars * std::pow(2.0 * rho2 / rho, OTH) + brs;
        }
    }
    void vwn(double rho1, double rho2, double rho, double rs,
             double* v1, double* v2, double* exc) const {
        const double OTH = 1.0 / 3.0, FTH = 4.0 / 3.0;
        const double ap = 0.0621814, af = 0.0310907, bp = 3.72744,
                     bf = 7.060428, cp = 12.9352, cf = 18.0578,
                     cp1 = 1.2117833, cp2 = 1.1435257, cp3 = -0.031167608,
                     cf1 = 2.9847935, cf2 = 2.7100059, cf3 = -0.1446006,
                     qp = 6.1519908, qf = 4.7309269, xp0 = -0.10498,
                     xf0 = -0.32500;
        double aav = std::pow(2.0, FTH) - 2.0;
        double x = std::sqrt(rs);
        double xpx = x * x + bp * x + cp, xfx = x * x + bf * x + cf;
        double s = (rho2 - rho1) / rho;
        double sp = 1.0 + s, sm = 1.0 - s, s4 = s * s * s * s - 1.0;
        double fs = (std::pow(sp, FTH) + std::pow(sm, FTH) - 2.0) / aav;
        double beta = 1.0 / (2.74208 + 3.182 * x + 0.09873 * x * x + 0.18268 * x * x * x);
        double dfs = FTH * (std::pow(sp, OTH) - std::pow(sm, OTH)) / aav;
        double dbeta = -(0.27402 * x + 0.09873 + 1.591 / x) * beta * beta;
        double atnp = std::atan(qp / (2.0 * x + bp));
        double atnf = std::atan(qf / (2.0 * x + bf));
        double ecp = ap * (std::log(x * x / xpx) + cp1 * atnp
                     - cp3 * (std::log(sq(x - xp0) / xpx) + cp2 * atnp));
        double ecf = af * (std::log(x * x / xfx) + cf1 * atnf
                     - cf3 * (std::log(sq(x - xf0) / xfx) + cf2 * atnf));
        double ec = ecp + fs * (ecf - ecp) * (1.0 + s4 * beta);
        double tp1 = (x * x + bp * x) / xpx, tf1 = (x * x + bf * x) / xfx;
        double ucp = ecp - ap / 3.0 * (1.0 - tp1 - cp3 * (x / (x - xp0) - tp1 - xp0 * x / xpx));
        double ucf = ecf - af / 3.0 * (1.0 - tf1 - cf3 * (x / (x - xf0) - tf1 - xf0 * x / xfx));
        double uc0 = ucp + (ucf - ucp) * fs;
        double uc20 = uc0 + (ecf - ecp) * sm * dfs;
        double uc10 = uc0 - (ecf - ecp) * sp * dfs;
        double duc = (ucf - ucp) * beta * s4 * fs
                   + (ecf - ecp) * (-rs / 3.0) * dbeta * s4 * fs;
        double s3 = s * s * s;
        double duc2 = duc + (ecf - ecp) * beta * sm * (4.0 * s3 * fs + s4 * dfs);
        double duc1 = duc - (ecf - ecp) * beta * sp * (4.0 * s3 * fs + s4 * dfs);
        double epx = -0.91633059 / rs * (1.0 + FTH * fs / 5.1297628);
        *v1 = uc10 + duc1 - 1.22177412 / rs * std::pow(sm, OTH);
        *v2 = uc20 + duc2 - 1.22177412 / rs * std::pow(sp, OTH);
        *exc = ec + epx;
    }
};

// v (nr x 2) updated in place; rho0/rhoeps/rhomu size 2
void vxc0sp(const XC& xc, double a, double b, const double* rofi,
            const double* rho, int nr, int nsp, double* v,
            double* rho0, double* rhoeps, double* rhomu) {
    double ob4pi = 1.0 / (4.0 * PI);
    std::vector<double> trho(nr * 2, 0.0);
    for (int s = 0; s < nsp; ++s) {
        rhoeps[s] = rhomu[s] = 0.0;
        double r2 = rho[1 * 2 + s] / sq(rofi[1]);
        double r3 = rho[2 * 2 + s] / sq(rofi[2]);
        rho0[s] = ob4pi * (r2 * rofi[2] - r3 * rofi[1]) / (rofi[2] - rofi[1]);
        trho[0 * 2 + s] = rho0[s];
        for (int ir = 1; ir < nr; ++ir)
            trho[ir * 2 + s] = rho[ir * 2 + s] * ob4pi / sq(rofi[ir]);
    }
    if (nsp == 1) {
        for (int ir = 0; ir < nr; ++ir) {
            double rh = 0.5 * trho[ir * 2];
            double v1, v2, exc;
            xc.pot(rh, rh, trho[ir * 2], &v1, &v2, &exc);
            v[ir * 2] += v1;
            if (ir >= 1) {
                double wgt = swgt(ir, nr);
                double drdi = a * (rofi[ir] + b);
                rhoeps[0] += wgt * drdi * rho[ir * 2] * exc;
                rhomu[0] += wgt * drdi * rho[ir * 2] * v1;
            }
        }
    } else {
        for (int ir = 0; ir < nr; ++ir) {
            double up = trho[ir * 2 + 0], dn = trho[ir * 2 + 1];
            double vxc2, vxc1, exc;
            xc.pot(dn, up, up + dn, &vxc2, &vxc1, &exc);
            v[ir * 2 + 0] += vxc1;
            v[ir * 2 + 1] += vxc2;
            if (ir >= 1) {
                double wgt = swgt(ir, nr);
                double drdi = a * (rofi[ir] + b);
                rhoeps[0] += wgt * drdi * rho[ir * 2 + 0] * exc;
                rhomu[0] += wgt * drdi * rho[ir * 2 + 0] * vxc1;
                rhoeps[1] += wgt * drdi * rho[ir * 2 + 1] * exc;
                rhomu[1] += wgt * drdi * rho[ir * 2 + 1] * vxc2;
            }
        }
    }
}

// ------------------------------------------------- shooting machinery
struct Fctp0 {
    int nctp0, nsave;
    double xrim, xmin;
};

Fctp0 fctp0(int l, const double* rofi, const double* v, double z, int nr) {
    Fctp0 out;
    double fllp1 = l * (l + 1);
    int ir = 9;
    double r = rofi[ir];
    double x = fllp1 / (r * r) - 2.0 * z / r + v[ir];
    double xlast;
    while (true) {
        ++ir;
        xlast = x;
        r = rofi[ir];
        x = fllp1 / (r * r) - 2.0 * z / r + v[ir];
        if (x > xlast || ir >= nr - 1) break;
    }
    out.nctp0 = ir - 1;
    out.xmin = xlast;
    r = rofi[nr - 1];
    out.xrim = fllp1 / (r * r) - 2.0 * z / r + v[nr - 1];
    if (out.xmin >= out.xrim - 3.0) { out.nctp0 = nr - 1; out.xmin = out.xrim; }
    out.nsave = (out.nctp0 + nr - 1) / 2;
    return out;
}

int fctp(double e, const Fctp0& f0, int& nsave, int l, const double* rofi,
         const double* v, double z, int nr, double a, double b) {
    double fllp1 = l * (l + 1);
    if (f0.nctp0 == nr - 1 || e > f0.xrim) return nr - 1;
    if (e < f0.xmin) return 1;
    int n1 = f0.nctp0, n2 = nr - 1, nctp = nsave, nlast = -10;
    for (int irep = 0; irep < 20; ++irep) {
        if (nctp > n2 || nctp < n1) nctp = (n1 + n2 + 3) / 2 - 1;
        double r = rofi[nctp];
        double vme = v[nctp] - e;
        int ip1 = std::min(nctp + 1, nr - 1);
        double dvdr = (v[ip1] - v[nctp - 1]) / (2.0 * a * (r + b));
        double fofr = fllp1 / (r * r) - 2.0 * z / r + vme;
        double dfdr = -2.0 * fllp1 / (r * r * r) + 2.0 * z / (r * r) + dvdr;
        double rtry = std::max(r - fofr / dfdr, rofi[1]);
        double fntry = std::log(rtry / b + 1.0) / a + 1.0;
        int ntry = (int)(fntry + 0.5) - 1;
        if (nlast == nctp) break;
        if (fofr > 0.0) n2 = nctp;
        if (fofr < 0.0) n1 = nctp;
        nlast = nctp;
        nctp = ntry;
    }
    if (nctp == f0.nctp0 + 1) nctp = 1;
    nsave = nctp;
    return nctp;
}

// g layout: (nr, 2) row-major [k*2 + comp]
void rsqsr1(double e, int l, double z, const double* v, int kr,
            double a, double b, const double* rofi, double* g,
            double* val, double* slo, int* nn) {
    *nn = 0;
    double zz = z + z, c = C_LIGHT;
    double fllp1 = l * (l + 1.0);
    double r83sq = 64.0 / 9.0, r1 = 1.0 / 9.0, r2 = -5.0 * r1, r3 = 19.0 * r1;
    double h83 = 8.0 / 3.0;
    double s, sf, g0, f0;
    if (z < 0.9) { s = l + 1.0; sf = l; g0 = 1.0; f0 = l / c; }
    else {
        double aa = zz / c;
        s = std::sqrt(fllp1 + 1.0 - aa * aa); sf = s; g0 = 1.0;
        f0 = g0 * (s - 1.0) / aa;
    }
    g[0] = 0.0; g[1] = 0.0;
    double d[2][3];
    for (int k = 1; k <= 3; ++k) {
        double r = rofi[k];
        double drdi = a * (r + b);
        g[k * 2 + 0] = std::pow(r, s) * g0;
        g[k * 2 + 1] = std::pow(r, sf) * f0;
        d[0][k - 1] = drdi * g[k * 2 + 0] * s / r;
        d[1][k - 1] = drdi * g[k * 2 + 1] * sf / r;
    }
    double dg1 = d[0][0], dg2 = d[0][1], dg3 = d[0][2];
    double df1 = d[1][0], df2 = d[1][1], df3 = d[1][2];
    for (int k = 4; k <= kr; ++k) {
        double r = rofi[k];
        double drdi = a * (r + b);
        double phi = (e + zz / r - v[k]) * drdi / c;
        double u = drdi * c + phi;
        double x = -drdi / r;
        double y = -fllp1 * x * x / u + phi;
        double det = r83sq - x * x + u * y;
        double b1 = g[(k - 1) * 2 + 0] * h83 + r1 * dg1 + r2 * dg2 + r3 * dg3;
        double b2 = g[(k - 1) * 2 + 1] * h83 + r1 * df1 + r2 * df2 + r3 * df3;
        g[k * 2 + 0] = (b1 * (h83 - x) + b2 * u) / det;
        g[k * 2 + 1] = (b2 * (h83 + x) - b1 * y) / det;
        if (g[k * 2] * g[(k - 1) * 2] < 0.0) ++(*nn);
        dg1 = dg2; dg2 = dg3; dg3 = u * g[k * 2 + 1] - x * g[k * 2 + 0];
        df1 = df2; df2 = df3; df3 = x * g[k * 2 + 1] - y * g[k * 2 + 0];
    }
    *val = g[kr * 2];
    *slo = dg3 / (a * (rofi[kr] + b));
}

void rsqsr2(double e, int l, double z, const double* v, int k1, int k2,
            double val1, double slo1, double a, double b, const double* rofi,
            double* g, double* val, double* slo, int* nn, int* kc) {
    *nn = 0;
    double zz = z + z, c = C_LIGHT;
    double fllp1 = l * (l + 1.0);
    double r83sq = 64.0 / 9.0, r1 = 1.0 / 9.0, r2 = -5.0 * r1, r3 = 19.0 * r1;
    double h83 = -8.0 / 3.0;
    double ea = std::exp(a);
    double rpb = b * std::exp(a * (k1 + 1) - a);
    double r = rpb - b;
    double dr = a * rpb;
    double phi = (e + zz / r - v[k1]) * dr / c;
    double u = dr * c + phi;
    double x = -dr / r;
    double y = -fllp1 * x * x / u + phi;
    g[k1 * 2 + 0] = val1;
    g[k1 * 2 + 1] = (slo1 * dr + x * val1) / u;
    double q = 1.0 / std::sqrt(ea);
    double ag1 = slo1 * dr;
    double af1 = x * g[k1 * 2 + 1] - y * g[k1 * 2 + 0];
    int k = k1;
    double dg3 = ag1;
    if (k2 != k1) {
        double d[2][3];
        bool hit_k2 = false;
        for (int i = 0; i < 3; ++i) {
            int kp1 = k;
            k -= 1;
            rpb *= q; dr = rpb * a; r = rpb - b;
            double gg = g[kp1 * 2 + 0] - 0.5 * ag1;
            double ff = g[kp1 * 2 + 1] - 0.5 * af1;
            double vb = (3.0 * v[kp1] + 6.0 * v[k] - v[k - 1]) * 0.125;
            phi = (e + zz / r - vb) * dr / c;
            u = dr * c + phi; x = -dr / r; y = -fllp1 * x * x / u + phi;
            double ag2 = u * ff - x * gg;
            double af2 = x * ff - y * gg;
            gg = g[kp1 * 2 + 0] - 0.5 * ag2;
            ff = g[kp1 * 2 + 1] - 0.5 * af2;
            double ag3 = u * ff - x * gg;
            double af3 = x * ff - y * gg;
            rpb *= q; dr = a * rpb; r = rpb - b;
            phi = (e + zz / r - v[k]) * dr / c;
            u = dr * c + phi; x = -dr / r; y = -fllp1 * x * x / u + phi;
            gg = g[kp1 * 2 + 0] - ag3;
            ff = g[kp1 * 2 + 1] - af3;
            g[k * 2 + 0] = g[kp1 * 2 + 0] - (ag1 + 2.0 * (ag2 + ag3) + u * ff - x * gg) / 6.0;
            g[k * 2 + 1] = g[kp1 * 2 + 1] - (af1 + 2.0 * (af2 + af3) + x * ff - y * gg) / 6.0;
            if (g[k * 2] * g[kp1 * 2] < 0.0) ++(*nn);
            ag1 = u * g[k * 2 + 1] - x * g[k * 2 + 0];
            af1 = x * g[k * 2 + 1] - y * g[k * 2 + 0];
            if (k == k2) { hit_k2 = true; break; }  // dg3 keeps initial value
            d[0][i] = ag1;
            d[1][i] = af1;
        }
        if (!hit_k2) {
            double qq = 1.0 / ea;
            double dg1 = d[0][0], dg2 = d[0][1];
            dg3 = d[0][2];
            double df1 = d[1][0], df2 = d[1][1], df3 = d[1][2];
            while (true) {
                int kp1 = k;
                k -= 1;
                rpb *= qq; dr = a * rpb; r = rpb - b;
                phi = (e + zz / r - v[k]) * dr / c;
                u = dr * c + phi; x = -dr / r; y = -fllp1 * x * x / u + phi;
                double det = r83sq - x * x + u * y;
                double b1 = g[kp1 * 2 + 0] * h83 + r1 * dg1 + r2 * dg2 + r3 * dg3;
                double b2 = g[kp1 * 2 + 1] * h83 + r1 * df1 + r2 * df2 + r3 * df3;
                g[k * 2 + 0] = (b1 * (h83 - x) + b2 * u) / det;
                g[k * 2 + 1] = (b2 * (h83 + x) - b1 * y) / det;
                if (g[k * 2] * g[kp1 * 2] < 0.0) ++(*nn);
                dg1 = dg2; df1 = df2;
                dg2 = dg3; df2 = df3;
                dg3 = u * g[k * 2 + 1] - x * g[k * 2 + 0];
                df3 = x * g[k * 2 + 1] - y * g[k * 2 + 0];
                if ((k + 1) % 2 != 0) {
                    if (k <= k2 || g[k * 2] * dg3 >= 0.0) break;
                }
            }
        }
    }
    *kc = k;
    *val = g[k * 2];
    *slo = dg3 / (a * (rofi[k] + b));
}

// returns 1-based NRE count; g (nr x 2) filled normalized
int rseqsr(double eb1, double eb2, double* e_io, double tol, double z,
           int l, int nod, double val, double slo, const double* v,
           double a, double b, const double* rofi, int nr, double* g,
           double* q_out) {
    int nitmax = 400;
    double c = C_LIGHT;
    double e = *e_io;
    double e1 = eb1, e2 = eb2;
    Fctp0 f0 = fctp0(l, rofi, v, z, nr);
    int nsave = f0.nsave;
    int nit = 0;
    double de = 0.0, ratio = 1.0;
    int kc = 0, nre = nr - 1;
    while (true) {
        ++nit;
        if (nit > nitmax) { *e_io = e; *q_out = 0.0; return nre + 1; }
        if (e <= e1 || e >= e2) e = 0.5 * (e1 + e2);
        int nctp = fctp(e, f0, nsave, l, rofi, v, z, nr, a, b);
        double re = 15.0 * rofi[nctp];
        int nre_f = (int)(std::log(re / b + 1.0) / a + 1.0);
        nre_f = (nre_f / 2) * 2 + 1;
        nre_f = std::max(35, std::min(nre_f, nr));
        nre = nre_f - 1;
        double valu = val, slop = slo;
        if (nre < nr - 1) { valu = 1.0e-5; slop = -1.0e-5; }
        int k2 = 29;
        if (nod == 0) k2 = nre_f / 3 - 1;
        if (valu * slop > 0.0 && nod == 0) k2 = nre - 10;
        double val2, slo2, val1l, slo1l;
        int nod2, nod1;
        rsqsr2(e, l, z, v, nre, k2, valu, slop, a, b, rofi, g,
               &val2, &slo2, &nod2, &kc);
        rsqsr1(e, l, z, v, kc, a, b, rofi, g, &val1l, &slo1l, &nod1);
        int node = nod1 + nod2;
        if (node != nod) {
            if (node > nod) e2 = e;
            if (node < nod) e1 = e;
            e = 0.5 * (e1 + e2);
        } else {
            ratio = val2 / val1l;
            double q = 0.0;
            for (int k = 1; k <= kc; ++k) q += (rofi[k] + b) * sq(g[k * 2]);
            q *= ratio * ratio;
            for (int k = kc + 1; k <= nre; ++k) q += (rofi[k] + b) * sq(g[k * 2]);
            q = a * (q - 0.5 * (rofi[nre] + b) * sq(g[nre * 2]));
            de = -val2 * (slo2 - ratio * slo1l) / q;
            if (de > 0.0) e1 = e;
            if (de < 0.0) e2 = e;
            e = e + de;
            if (std::fabs(de) <= tol || nit >= nitmax) break;
        }
    }
    double fllp1 = l * (l + 1);
    e = e - de;
    for (int k = 0; k <= kc; ++k) { g[k * 2] *= ratio; g[k * 2 + 1] *= ratio; }
    double q = 0.0, wgt = 1.0, rhok = 0.0;
    for (int k = 1; k <= nre; ++k) {
        double r = rofi[k];
        wgt = (((k + 2) % 2) + 1) * (r + b);
        double tmcr = (c - (v[k] - 2.0 * z / r - e) / c) * r;
        rhok = sq(g[k * 2]) * (1.0 + fllp1 / sq(tmcr)) + sq(g[k * 2 + 1]);
        q += wgt * rhok;
    }
    q = (q - 0.5 * wgt * rhok) * a * 2.0 / 3.0;
    double fac = 1.0 / std::sqrt(q);
    for (int k = 0; k <= nre; ++k) { g[k * 2] *= fac; g[k * 2 + 1] *= fac; }
    for (int k = nre + 1; k < nr; ++k) { g[k * 2] = 0.0; g[k * 2 + 1] = 0.0; }
    *e_io = e;
    *q_out = q;
    return nre + 1;
}

double gintsr(const double* g1, const double* g2, double a, double b, int nr,
              double z, double e, int l, const double* v, const double* rofi) {
    double fllp1 = l * (l + 1), c = C_LIGHT, s = 0.0;
    for (int k = 1; k < nr - 1; k += 2) {
        double r = rofi[k];
        double tmc = c - (v[k] - 2.0 * z / r - e) / c;
        double gfac = 1.0 + fllp1 / sq(tmc * r);
        s += (r + b) * (g1[k * 2] * g2[k * 2] * gfac + g1[k * 2 + 1] * g2[k * 2 + 1]);
    }
    s += s;
    for (int k = 2; k < nr - 2; k += 2) {
        double r = rofi[k];
        double tmc = c - (v[k] - 2.0 * z / r - e) / c;
        double gfac = 1.0 + fllp1 / sq(tmc * r);
        s += (r + b) * (g1[k * 2] * g2[k * 2] * gfac + g1[k * 2 + 1] * g2[k * 2 + 1]);
    }
    s += s;
    int k = nr - 1;
    double r = rofi[k];
    double tmc = c - (v[k] - 2.0 * z / r - e) / c;
    double gfac = 1.0 + fllp1 / sq(tmc * r);
    s += (r + b) * (g1[k * 2] * g2[k * 2] * gfac + g1[k * 2 + 1] * g2[k * 2 + 1]);
    return s * a / 3.0;
}

// gp/gpp (nr x 2) out; returns phi,dphi,phip,dphip,p via pointers
void phdfsr(double z, int l, const double* v, double e, double a, double b,
            const double* rofi, int nr, const double* g, double val,
            double slo, double tol, int nn, double* gp, double* gpp,
            double* phi, double* dphi, double* phip, double* dphip,
            double* p) {
    double rmax = rofi[nr - 1];
    double eb1 = -50.0, eb2 = 15.0;
    double dele = 0.003;
    double ddde = -rmax / sq(g[(nr - 1) * 2]);
    double ddl = dele * ddde;
    double slo1 = slo - ddl * val / rmax;
    double slo2 = slo + ddl * val / rmax;
    double e1 = e, e2 = e, sum1, sum2;
    rseqsr(eb1, eb2, &e1, tol, z, l, nn, val, slo1, v, a, b, rofi, nr, gp, &sum1);
    double val1 = val / std::sqrt(sum1);
    slo1 = slo1 / std::sqrt(sum1);
    rseqsr(eb1, eb2, &e2, tol, z, l, nn, val, slo2, v, a, b, rofi, nr, gpp, &sum2);
    double val2 = val / std::sqrt(sum2);
    slo2 = slo2 / std::sqrt(sum2);
    double x1 = e1 - e, x2 = e2 - e;
    double den = x1 * x2 * (x1 - x2);
    double wp0 = (x2 * x2 - x1 * x1) / den;
    double wp1 = -x2 * x2 / den;
    double wp2 = x1 * x1 / den;
    double wpp0 = 2.0 * (x1 - x2) / den;
    double wpp1 = 2.0 * x2 / den;
    double wpp2 = -2.0 * x1 / den;
    for (int i = 0; i < nr * 2; ++i) {
        double gpi = wp0 * g[i] + wp1 * gp[i] + wp2 * gpp[i];
        gpp[i] = wpp0 * g[i] + wpp1 * gp[i] + wpp2 * gpp[i];
        gp[i] = gpi;
    }
    double vlp = wp0 * val + wp1 * val1 + wp2 * val2;
    double slp = wp0 * slo + wp1 * slo1 + wp2 * slo2;
    *p = gintsr(gp, gp, a, b, nr, z, e, l, v, rofi);
    *phi = val / rmax;
    *dphi = slo / rmax - val / (rmax * rmax);
    *phip = vlp / rmax;
    *dphip = (slp - vlp / rmax) / rmax;
}

double core_deg(int ifcore, int isp, int nsp) {
    double dfcore = (double)ifcore;
    if (nsp == 1) return dfcore;
    if (ifcore <= 7) return isp == 0 ? dfcore : 0.0;
    return isp == 0 ? 7.0 : dfcore - 7.0;
}

void core_correction(double e1, double e2, double* ecore, double tol,
                     double z, int l, int nodes, const double* v, double a,
                     double b, const double* rofi, int nr, double* g,
                     int* nre_out) {
    double rmax = rofi[nr - 1];
    double val = 1.0e-30, slo = -val, q;
    int nre = rseqsr(e1, e2, ecore, tol, z, l, nodes, val, slo, v, a, b,
                     rofi, nr, g, &q);
    double yyy = *ecore - v[nr - 1] + 2.0 * z / rmax;
    if (nre == nr && yyy < 0.0) {
        double dlml = -1.0 - std::sqrt(-yyy) * rmax;
        for (int ll = 1; ll <= l; ++ll)
            dlml = -yyy * rmax * rmax / dlml - (2 * ll + 1);
        slo = val * (dlml + l + 1) / rmax;
        nre = rseqsr(e1, e2, ecore, tol, z, l, nodes, val, slo, v, a, b,
                     rofi, nr, g, &q);
    }
    *nre_out = nre;
}

struct NewrhoOut {
    double sumec[2];
    double sumev[2];
};

// rho (nr x 2) out; fun2 (nr x (lmax+1) x 2) out; vzt (nr x 2) out;
// v column for spin s is v[ir*2+s] — we pass per-spin strided views below
NewrhoOut newrho(double z, int lmax, double a, double b, int nr,
                 const double* rofi, const double* v /*nr x 2*/,
                 const double* pl /*(lmax+1) x 2*/,
                 const double* ql /*3 x (lmax+1) x 2*/,
                 double* ec, double* ev, double tol, int nsp, int ifcore,
                 double* rho, double* fun2, double* vzt) {
    NewrhoOut out{};
    double rocrit = 0.002, c = C_LIGHT;
    double rmax = rofi[nr - 1];
    bool free = rmax > 9.99;
    int nl = lmax + 1;
    std::vector<int> konf(lmax + 2, 0);
    for (int l = 0; l <= lmax; ++l) konf[l] = (int)pl[l * 2 + 0];
    if (ifcore != 0) konf[lmax + 1] = 5;

    for (int s = 0; s < 2; ++s) {
        vzt[0 * 2 + s] = 0.0;
        for (int ir = 1; ir < nr; ++ir)
            vzt[ir * 2 + s] = v[ir * 2 + s] - 2.0 * z / rofi[ir];
    }
    std::fill(rho, rho + nr * 2, 0.0);
    std::fill(fun2, fun2 + nr * nl * 2, 0.0);

    // per-spin contiguous potential copies
    std::vector<double> vs(nr), g(nr * 2), gp(nr * 2), gpp(nr * 2);

    // ---------------- core ----------------
    int icore = 0;
    double e1 = -2.5 * z * z - 5.0, e2c = 20.0;
    for (int isp = 0; isp < nsp; ++isp) {
        out.sumec[isp] = 0.0;
        for (int ir = 0; ir < nr; ++ir) vs[ir] = v[ir * 2 + isp];
        for (int lp1 = 1; lp1 <= lmax + 1; ++lp1) {
            int l = lp1 - 1;
            double deg = (2 * (2 * l + 1)) / nsp;
            for (int kf = lp1; kf < konf[lp1 - 1]; ++kf) {
                int nodes = kf - lp1;
                double ecore = ec[icore];
                int nre;
                core_correction(e1, e2c, &ecore, tol, z, l, nodes, vs.data(),
                                a, b, rofi, nr, g.data(), &nre);
                ec[icore] = ecore;
                ++icore;
                double fllp1 = l * (l + 1);
                for (int ir = 1; ir < nre; ++ir) {
                    double r = rofi[ir];
                    double tmc = c - (vs[ir] - 2.0 * z / r - ecore) / c;
                    double gfac = 1.0 + fllp1 / sq(tmc * r);
                    rho[ir * 2 + isp] += deg * (gfac * sq(g[ir * 2]) + sq(g[ir * 2 + 1]));
                }
                out.sumec[isp] += deg * ecore;
            }
        }
        if (ifcore != 0) {
            int lp1 = lmax + 2, l = lp1 - 1;
            double deg = core_deg(ifcore, isp, nsp);
            for (int kf = lp1; kf < 5; ++kf) {
                int nodes = kf - lp1;
                double ecore = ec[icore];
                int nre;
                core_correction(e1, e2c, &ecore, tol, z, l, nodes, vs.data(),
                                a, b, rofi, nr, g.data(), &nre);
                ec[icore] = ecore;
                ++icore;
                double fllp1 = l * (l + 1);
                for (int ir = 1; ir < nre; ++ir) {
                    double r = rofi[ir];
                    double tmc = c - (vs[ir] - 2.0 * z / r - ecore) / c;
                    double gfac = 1.0 + fllp1 / sq(tmc * r);
                    rho[ir * 2 + isp] += deg * (gfac * sq(g[ir * 2]) + sq(g[ir * 2 + 1]));
                }
                out.sumec[isp] += deg * ecore;
            }
        }
    }

    // ---------------- valence ----------------
    int ival = 0;
    for (int isp = 0; isp < nsp; ++isp) {
        out.sumev[isp] = 0.0;
        for (int ir = 0; ir < nr; ++ir) vs[ir] = v[ir * 2 + isp];
        for (int lp1 = 1; lp1 <= lmax + 1; ++lp1) {
            int l = lp1 - 1;
            double q0 = ql[(0 * nl + l) * 2 + isp];
            double q1 = ql[(1 * nl + l) * 2 + isp];
            double q2 = ql[(2 * nl + l) * 2 + isp];
            if (q0 < 1.0e-5) continue;
            int konfig = (int)pl[l * 2 + isp];
            double dl = std::tan(PI * (0.5 - pl[l * 2 + isp]));
            int nn = konfig - lp1;
            double eval = ev[ival];
            double val = rmax, slo = dl + 1.0;
            if (free) { val = 1.0e-30; slo = -val; }
            std::fill(g.begin(), g.end(), 0.0);
            double summ;
            int nre = rseqsr(-50.0, 50.0, &eval, tol, z, l, nn, val, slo,
                             vs.data(), a, b, rofi, nr, g.data(), &summ);
            ev[ival] = eval;
            ++ival;
            out.sumev[isp] += eval * q0 + q1;
            double ro = sq(g[(nr - 1) * 2]);
            if (free || ro < rocrit) {
                std::fill(gp.begin(), gp.end(), 0.0);
                std::fill(gpp.begin(), gpp.end(), 0.0);
            } else {
                double valn = val / std::sqrt(summ);
                double slon = slo / std::sqrt(summ);
                double phi, dphi, phip, dphip, pp;
                phdfsr(z, l, vs.data(), eval, a, b, rofi, nr, g.data(), valn,
                       slon, tol, nn, gp.data(), gpp.data(), &phi, &dphi,
                       &phip, &dphip, &pp);
            }
            double fllp1 = l * (l + 1);
            for (int ir = 1; ir < nre; ++ir) {
                double r = rofi[ir];
                double tmc = c - (vs[ir] - 2.0 * z / r - eval) / c;
                double gfac = 1.0 + fllp1 / sq(tmc * r);
                double gg = g[ir * 2], gf = g[ir * 2 + 1];
                double pg = gp[ir * 2], pf = gp[ir * 2 + 1];
                double ppg = gpp[ir * 2], ppf = gpp[ir * 2 + 1];
                rho[ir * 2 + isp] +=
                    q0 * (gfac * gg * gg + gf * gf)
                    + 2.0 * q1 * (gfac * gg * pg + gf * pf)
                    + q2 * (gfac * (pg * pg + gg * ppg) + pf * pf + gf * ppf);
                fun2[(ir * nl + l) * 2 + isp] = gfac * gg * gg + gf * gf;
            }
        }
    }
    return out;
}

}  // namespace

// =================================================================== C ABI
extern "C" {

int rsl_mesh_size(double z, double ws_r, double a) {
    return mesh_grid_size(z, ws_r, a);
}

double rsl_mesh_b(double ws_r, double a, int nr) { return mesh_b(ws_r, a, nr); }

// energies_out: [etot, utot, ekin, rhoeps, sumev, sumec, vrmax0, vrmax1]
int rsl_atomsc(double z, int lmax, double a, double ws_r,
               const double* pl, const double* ql,
               int ifcore, int txc, int nsp, int niter,
               double* energies_out, double* v_out, double* rofi_out,
               double* fun2_out, double* vzt_out, int* nr_out) {
    int nr = mesh_grid_size(z, ws_r, a);
    double b = mesh_b(ws_r, a, nr);
    *nr_out = nr;
    std::vector<double> rofi(nr);
    radial_mesh(a, b, nr, rofi.data());
    XC xc(txc);
    int nl = lmax + 1;

    int ncore = 0;
    for (int l = 0; l <= lmax; ++l)
        for (int isp = 0; isp < nsp; ++isp)
            ncore += std::max(0, (int)pl[l * 2 + isp] - 1 - l);
    if (ifcore != 0) ncore += 2 * std::max(0, 5 - (lmax + 2));
    std::vector<double> ec(std::max(ncore, 1), -5.0);
    std::vector<double> ev(nl * nsp, -0.5);

    std::vector<double> rho_in(nr * 2);
    rho0_guess(z, a, b, nr, rho_in.data());

    double tol = 1.0e-6, tolrsq = 1.0e-8, beta = 0.3;
    double drho = 100.0;
    bool last = false;
    std::vector<double> v(nr * 2, 0.0), rho(nr * 2, 0.0);
    std::vector<double> fun2(nr * nl * 2, 0.0), vzt(nr * 2, 0.0);
    double rvh[2] = {0, 0}, rho0a[2], reps[2] = {0, 0}, rmu[2] = {0, 0};
    double vnucl = 0.0;
    NewrhoOut nro{};
    for (int it = 1; it <= niter; ++it) {
        double beta1 = beta;
        if (it % 3 == 2 && drho < 1.0) beta1 = 0.5;
        std::fill(v.begin(), v.end(), 0.0);
        poiss0(z, a, b, rofi.data(), rho_in.data(), nr, nsp, 0.0, v.data(), rvh);
        vnucl = v[0];
        vxc0sp(xc, a, b, rofi.data(), rho_in.data(), nr, nsp, v.data(),
               rho0a, reps, rmu);
        nro = newrho(z, lmax, a, b, nr, rofi.data(), v.data(), pl, ql,
                     ec.data(), ev.data(), tolrsq, nsp, ifcore,
                     rho.data(), fun2.data(), vzt.data());
        drho = 0.0;
        for (int isp = 0; isp < nsp; ++isp)
            for (int ir = 0; ir < nr; ++ir) {
                double w = swgt(ir, nr);
                drho += w * std::fabs(rho[ir * 2 + isp] - rho_in[ir * 2 + isp]);
                rho_in[ir * 2 + isp] = beta1 * rho[ir * 2 + isp]
                                       + (1.0 - beta1) * rho_in[ir * 2 + isp];
            }
        if (last) break;
        if (drho < tol || it == niter - 1) last = true;
    }
    double rhoeps = reps[0] + reps[1];
    double rhomu = rmu[0] + rmu[1];
    double sumev = nro.sumev[0] + nro.sumev[1];
    double sumec = nro.sumec[0] + nro.sumec[1];
    double rhovh = rvh[0] + rvh[1];
    double zvnucl = -z * vnucl;
    double utot = 0.5 * (rhovh + zvnucl);
    double ekin = sumev + sumec - rhovh - rhomu;
    energies_out[0] = ekin + utot + rhoeps;
    energies_out[1] = utot;
    energies_out[2] = ekin;
    energies_out[3] = rhoeps;
    energies_out[4] = sumev;
    energies_out[5] = sumec;
    energies_out[6] = -2.0 * z / ws_r + (v[(nr - 1) * 2] + v[(nr - 1) * 2 + 1]) / nsp;
    energies_out[7] = nsp == 2 ? v[(nr - 1) * 2] - v[(nr - 1) * 2 + 1] : 0.0;
    std::memcpy(v_out, v.data(), nr * 2 * sizeof(double));
    std::memcpy(rofi_out, rofi.data(), nr * sizeof(double));
    std::memcpy(fun2_out, fun2.data(), nr * nl * 2 * sizeof(double));
    vzt[0 * 2 + 0] = vzt[1 * 2 + 0];
    vzt[0 * 2 + 1] = vzt[1 * 2 + 1];
    std::memcpy(vzt_out, vzt.data(), nr * 2 * sizeof(double));
    return 0;
}

// outputs (lmax+1) x 2 row-major [l*2+s]
int rsl_potpar(double z, int lmax, double a, double ws_r, const double* pnu,
               const double* v /*nr x 2*/, const double* rofi, int nr,
               double* enu, double* cpar, double* srdel, double* qpar,
               double* ppar, double* vlpar) {
    double tol = 1.0e-12, eb1 = -10.0, eb2 = 10.0;
    double b = mesh_b(ws_r, a, nr);
    double rmax = ws_r;
    std::vector<double> vs(nr), g(nr * 2), gp(nr * 2), gpp(nr * 2);
    for (int i = 0; i < 2; ++i) {
        for (int ir = 0; ir < nr; ++ir) vs[ir] = v[ir * 2 + i];
        for (int l = 0; l <= lmax; ++l) {
            int konfig = (int)pnu[l * 2 + i];
            double dnu = std::tan(PI * (0.5 - pnu[l * 2 + i]));
            int nn = konfig - l - 1;
            double e = -0.5, val = rmax, slo = dnu + 1.0, summ;
            std::fill(g.begin(), g.end(), 0.0);
            rseqsr(eb1, eb2, &e, tol, z, l, nn, val, slo, vs.data(), a, b,
                   rofi, nr, g.data(), &summ);
            double valn = val / std::sqrt(summ);
            double slon = slo / std::sqrt(summ);
            double phi, dphi, phip, dphip, p;
            phdfsr(z, l, vs.data(), e, a, b, rofi, nr, g.data(), valn, slon,
                   tol, nn, gp.data(), gpp.data(), &phi, &dphi, &phip, &dphip,
                   &p);
            enu[l * 2 + i] = e;
            double dlphi = rmax * dphi / phi;
            double dlphip = rmax * dphip / phip;
            double omegam = -(phi / phip) * (-l - 1 - dlphi) / (-l - 1 - dlphip);
            double omegap = -(phi / phip) * (l - dlphi) / (l - dlphip);
            double phplus = phi + omegap * phip;
            double phmins = phi + omegam * phip;
            cpar[l * 2 + i] = e + omegam;
            vlpar[l * 2 + i] = e + omegap;
            srdel[l * 2 + i] = phmins * std::sqrt(0.5 * rmax);
            double q = phmins / (2 * (2 * l + 1) * phplus);
            qpar[l * 2 + i] = 1.0 / q;
            ppar[l * 2 + i] = 1.0 / std::sqrt(p);
        }
    }
    return 0;
}

// qsl out size 6: [xi_p_up, xi_d_up, rac_up, xi_p_dw, xi_d_dw, rac_dw]
int rsl_racsi(double a, double b, const double* rofi, int nr,
              const double* fun2 /*nr x 3 x 2*/, const double* vzt /*nr x 2*/,
              double* qsl) {
    double c2 = C_LIGHT * C_LIGHT;
    std::vector<double> dvdr(nr * 2, 0.0);
    for (int isp = 0; isp < 2; ++isp) {
        for (int ii = 2; ii < nr - 1; ++ii) {
            double dvp = (vzt[(ii + 1) * 2 + isp] - vzt[ii * 2 + isp])
                         / (rofi[ii + 1] - rofi[ii]);
            double dvm = (vzt[(ii - 1) * 2 + isp] - vzt[ii * 2 + isp])
                         / (rofi[ii - 1] - rofi[ii]);
            dvdr[ii * 2 + isp] = 0.5 * (dvp + dvm);
        }
        dvdr[1 * 2 + isp] = dvdr[2 * 2 + isp];
        dvdr[(nr - 1) * 2 + isp] = dvdr[(nr - 2) * 2 + isp];
    }
    for (int inum = 2; inum <= 3; ++inum) {
        for (int isp = 0; isp < 2; ++isp) {
            double s = 0.0;
            for (int ir = 1; ir < nr; ++ir) {
                double wgt = swgt(ir, nr);
                double drdi = a * (rofi[ir] + b);
                s += wgt * drdi * fun2[(ir * 3 + (inum - 1)) * 2 + isp]
                     * 2.0 * dvdr[ir * 2 + isp] / (rofi[ir] * c2);
            }
            if (isp == 0) qsl[inum - 2] = s;
            else qsl[inum + 1] = s;
        }
    }
    // Racah F2/F4 over the d density (O(nr^2) double radial integral)
    for (int isp = 0; isp < 2; ++isp) {
        double fak2 = 0.0, fak4 = 0.0;
        for (int inum = 2; inum <= 4; inum += 2) {
            double s = 0.0;
            for (int ir = 1; ir < nr; ++ir) {
                double sum1 = 0.0;
                for (int j = 1; j <= ir; ++j) {
                    double w = 2.0 * (((j + 2) % 2) + 1) / 3.0;
                    if (j == ir) w = 1.0 / 3.0;
                    double drdi = a * (rofi[j] + b);
                    sum1 += w * drdi * fun2[(j * 3 + 2) * 2 + isp]
                            * std::pow(rofi[j], inum)
                            / std::pow(rofi[ir], inum + 1);
                }
                double sum2 = 0.0;
                for (int j = ir; j < nr; ++j) {
                    double w = 2.0 * (((j + 2) % 2) + 1) / 3.0;
                    if (j == ir || j == nr - 1) w = 1.0 / 3.0;
                    double drdi = a * (rofi[j] + b);
                    sum2 += w * drdi * fun2[(j * 3 + 2) * 2 + isp]
                            * std::pow(rofi[ir], inum)
                            / std::pow(rofi[j], inum + 1);
                }
                double wgt = swgt(ir, nr);
                double drdi = a * (rofi[ir] + b);
                s += wgt * drdi * (sum1 + sum2) * fun2[(ir * 3 + 2) * 2 + isp];
            }
            if (inum == 2) { fak2 = s / 49.0; fak4 = 0.0; }
            else fak4 = s / 441.0;
        }
        qsl[2 + 3 * isp] = 2.0 * (fak2 - 5.0 * fak4);
    }
    return 0;
}

}  // extern "C"
