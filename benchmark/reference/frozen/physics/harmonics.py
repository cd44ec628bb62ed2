"""Cubic <-> spherical harmonic basis transforms and angular-momentum ops.

The 9-orbital spd blocks are assembled in cubic (real) harmonics
(s, x, y, z, xy, yz, zx, x^2-y^2, 3z^2-r^2) and transformed to the complex
spherical-harmonic basis Y(lm) ordered (00)(1-1)(10)(11)(2-2)(2-1)(20)(21)(22)
— reference ``source/math.f90 hcpx`` :1508-1576 and the L_x/L_y/L_z operator
constants :133-200.
"""

from __future__ import annotations

import numpy as np

_C = 1.0 / np.sqrt(2.0)
_I = 1.0j

# V: cubic -> spherical transform, VC = V^H (reference 'v' and 'vc')
V = np.zeros((9, 9), dtype=np.complex128)
V[0, 0] = 1.0
# p block
V[1, 3] = -_C
V[1, 1] = _C
V[2, 3] = _I * _C
V[2, 1] = _I * _C
V[3, 2] = 1.0
# d block
V[4, 4] = _I * _C
V[4, 8] = -_I * _C
V[5, 5] = _I * _C
V[5, 7] = _I * _C
V[6, 5] = _C
V[6, 7] = -_C
V[7, 4] = _C
V[7, 8] = _C
V[8, 6] = 1.0

VC = V.conj().T.copy()


def cart2sph(h: np.ndarray) -> np.ndarray:
    """Transform 9x9 block(s) from cubic to spherical harmonics.

    Accepts (..., 9, 9); returns ``VC @ h @ V`` (reference ``hcpx``
    'cart2sph' branch).
    """
    return VC @ np.asarray(h, dtype=np.complex128) @ V


def sph2cart(h: np.ndarray) -> np.ndarray:
    return V @ np.asarray(h, dtype=np.complex128) @ VC


def _lops() -> tuple:
    """Angular momentum operators in the cubic basis (math.f90 L_x/L_y/L_z).

    The Fortran reshape fills column-major: element k of the literal list is
    L(mod(k,9)+1, k//9+1), i.e. the rows below are *columns* of L.
    """
    s3 = np.sqrt(3.0)
    lx_cols = np.zeros((9, 9))
    lx_cols[2, 3] = -1.0  # column 3 (x): row z
    lx_cols[3, 2] = 1.0
    lx_cols[4, 6] = -1.0
    lx_cols[5, 7] = -1.0
    lx_cols[5, 8] = -s3
    lx_cols[6, 4] = 1.0
    lx_cols[7, 5] = 1.0
    lx_cols[8, 5] = s3
    ly_cols = np.zeros((9, 9))
    ly_cols[1, 3] = 1.0
    ly_cols[3, 1] = -1.0
    ly_cols[4, 5] = 1.0
    ly_cols[5, 4] = -1.0
    ly_cols[6, 7] = -1.0
    ly_cols[6, 8] = s3
    ly_cols[7, 6] = 1.0
    ly_cols[8, 6] = -s3
    lz_cols = np.zeros((9, 9))
    lz_cols[1, 2] = -1.0
    lz_cols[2, 1] = 1.0
    lz_cols[4, 7] = 2.0
    lz_cols[5, 6] = 1.0
    lz_cols[6, 5] = -1.0
    lz_cols[7, 4] = -2.0
    return tuple((-1j) * m.T for m in (lx_cols, ly_cols, lz_cols))


#: L operators in the cubic basis, complex (factor -i included)
L_X, L_Y, L_Z = _lops()


# ---------------------------------------------------------------- rotations
def wigner_small_d(j: float, m: float, mp: float, beta: float) -> float:
    """Wigner small-d matrix element d^j_{m,mp}(beta) (math.f90 ``DSs``
    :1929-1960, binomial-sum form)."""
    from math import comb, factorial

    smin = max(0, int(round(-mp - m)))
    smax = min(int(round(j - mp)), int(round(j - m)))
    jm = int(round(j + m))
    jmm = int(round(j - m))
    jp = int(round(j + mp))
    jmp = int(round(j - mp))
    tot = 0.0
    for s in range(smin, smax + 1):
        tot += (comb(jm, jmp - s) * comb(jmm, s)
                * (-1.0) ** (jmp - s)
                * np.cos(0.5 * beta) ** (2 * s + mp + m)
                * np.sin(0.5 * beta) ** (2 * j - 2 * s - mp - m))
    return tot * np.sqrt(factorial(jp) * factorial(jmp)
                         / (factorial(jmm) * factorial(jm)))


def rotmat18(alfa: float, beta: float, gama: float = 0.0) -> np.ndarray:
    """18x18 spinor rotation matrix in the spherical-harmonic basis
    (math.f90 ``ROTMAT`` :2024-2070): orbital Wigner-D per l shell times
    the spin-1/2 rotation."""
    im = 1j
    sm = np.zeros((2, 2), dtype=np.complex128)
    for a, mu in enumerate((0.5, -0.5)):
        for b, nu in enumerate((0.5, -0.5)):
            sm[a, b] = (wigner_small_d(0.5, mu, nu, beta)
                        * np.exp(-im * (mu * alfa + nu * gama)))
    mat9 = np.zeros((9, 9), dtype=np.complex128)
    for j in range(3):
        s = j * j + j  # 0-based m=0 position
        for m in range(-j, j + 1):
            for mp in range(-j, j + 1):
                mat9[s + m, s + mp] = (
                    wigner_small_d(float(j), float(m), float(mp), beta)
                    * np.exp(-im * (m * alfa + mp * gama))
                )
    out = np.zeros((18, 18), dtype=np.complex128)
    out[:9, :9] = mat9 * sm[0, 0]
    out[:9, 9:] = mat9 * sm[0, 1]
    out[9:, :9] = mat9 * sm[1, 0]
    out[9:, 9:] = mat9 * sm[1, 1]
    return out


def rotmag_loc(blocks: np.ndarray, mom: np.ndarray) -> np.ndarray:
    """Rotate 18x18 blocks to the local frame of moment direction
    ``mom``: R^H B R per block (math.f90 ``rotmag_loc`` :1990-2022;
    alfa = atan2(y, x), beta = acos(z/|m|^2) with the reference's
    squared-norm quirk, exact for unit moments)."""
    x, y, z = mom
    d2 = x * x + y * y
    r2 = x * x + y * y + z * z
    alfa = 0.0 if d2 == 0.0 else np.arctan2(y, x)
    beta = np.arccos(np.clip(z / r2, -1.0, 1.0))
    r = rotmat18(alfa, beta)
    return np.einsum("ba,...bc,cd->...ad", r.conj(), blocks, r)
