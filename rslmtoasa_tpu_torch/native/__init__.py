"""ctypes bindings for the native (C++) atomic-sphere solver.

The source is this package's own ``csrc/radial.cpp`` (a byte-for-byte
copy of the JAX package's ``native/radial.cpp``; a test holds the two
equal).  It is built with g++ on first use, on the machine that runs it,
into this package's ``_build/libradial.so``; nothing is written beside
the source.  A failed build raises: the Python solver
(``physics/atomsphere.py``) runs only what this one lacks, the gradient
functionals and the hyperfine fields.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from dataclasses import dataclass

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "radial.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libradial.so")


@dataclass
class AtomSCFResult:
    """What :func:`atomsc_native` returns (the fields of
    ``rslmtoasa_tpu.physics.atomsphere.AtomSCFResult`` the SCF reads)."""

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
    nr: int = 0


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O2", "-march=native", "-shared", "-fPIC", SOURCE,
               "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{res.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def get_lib() -> ctypes.CDLL:
    if (not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
        _build()
    lib = ctypes.CDLL(LIBRARY)
    d = ctypes.c_double
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rsl_mesh_size.restype = ctypes.c_int
    lib.rsl_mesh_size.argtypes = [d, d, d]
    lib.rsl_atomsc.restype = ctypes.c_int
    lib.rsl_atomsc.argtypes = [
        d, ctypes.c_int, d, d, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, dp, ip,
    ]
    lib.rsl_potpar.restype = ctypes.c_int
    lib.rsl_potpar.argtypes = [d, ctypes.c_int, d, d, dp, dp, dp,
                               ctypes.c_int, dp, dp, dp, dp, dp, dp]
    lib.rsl_racsi.restype = ctypes.c_int
    lib.rsl_racsi.argtypes = [d, d, dp, ctypes.c_int, dp, dp, dp]
    return lib


def atomsc_native(z, lmax, a, ws_r, pl, ql, ifcore=0, txc=1, nsp=2,
                  niter=80) -> AtomSCFResult:
    lib = get_lib()
    nl = lmax + 1
    nr = lib.rsl_mesh_size(float(z), float(ws_r), float(a))
    pl_c = np.ascontiguousarray(pl, dtype=np.float64)
    ql_c = np.ascontiguousarray(ql, dtype=np.float64)
    energies = np.zeros(8)
    v = np.zeros((nr, 2))
    rofi = np.zeros(nr)
    fun2 = np.zeros((nr, nl, 2))
    vzt = np.zeros((nr, 2))
    nr_out = ctypes.c_int(0)
    lib.rsl_atomsc(
        float(z), lmax, float(a), float(ws_r), pl_c, ql_c,
        int(ifcore), int(txc), int(nsp), int(niter),
        energies, v.reshape(-1), rofi, fun2.reshape(-1), vzt.reshape(-1),
        ctypes.byref(nr_out),
    )
    res = AtomSCFResult()
    (res.etot, res.utot, res.ekin, res.rhoeps, res.sumev, res.sumec,
     vr0, vr1) = energies
    res.vrmax = np.array([vr0, vr1])
    res.v = v
    res.rofi = rofi
    res.fun2 = fun2
    res.vzt = vzt
    res.nr = nr
    return res


def potpar_native(z, lmax, a, ws_r, pnu, v, rofi):
    lib = get_lib()
    nr = rofi.shape[0]
    nl = lmax + 1
    out = {k: np.zeros((nl, 2)) for k in
           ("enu", "c", "srdel", "qpar", "ppar", "vl")}
    lib.rsl_potpar(
        float(z), lmax, float(a), float(ws_r),
        np.ascontiguousarray(pnu, dtype=np.float64),
        np.ascontiguousarray(v, dtype=np.float64).reshape(-1),
        np.ascontiguousarray(rofi, dtype=np.float64), nr,
        out["enu"].reshape(-1), out["c"].reshape(-1),
        out["srdel"].reshape(-1), out["qpar"].reshape(-1),
        out["ppar"].reshape(-1), out["vl"].reshape(-1),
    )
    return out


def racsi_native(a, b, rofi, fun2, vzt):
    lib = get_lib()
    qsl = np.zeros(6)
    lib.rsl_racsi(
        float(a), float(b),
        np.ascontiguousarray(rofi, dtype=np.float64), rofi.shape[0],
        np.ascontiguousarray(fun2, dtype=np.float64).reshape(-1),
        np.ascontiguousarray(vzt, dtype=np.float64).reshape(-1),
        qsl,
    )
    return qsl
