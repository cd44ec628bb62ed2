"""Modern-theory orbital magnetization via Chebyshev moments.

Port of ``rslmtoasa_tpu/models/orbital.py`` (``post_processing=
'orbital_modern'``; reference ``calculation.f90`` :1158-1290 and
``recursion.f90 chebyshev_orbital_mod`` :2834-3049): the z orbital-moment
operator A = i alat^2 (X H~ Y - Y H~ X) and its KPM trace

    mu_n = sum_s <A e_s | T_n(H~) e_s>

over the sites s, Jackson-damped and reconstructed to the energy-resolved
orbital moment Lz(E); the cumulative Fermi integral is written to
``fort.50`` (the reference's unit-50 output).

The sites recur side by side as start blocks of the block recursion's
layout ``(kk+1, 18, 18 R)``, R per group (:func:`plan` sizes the groups
from the memory the device has free).  Every application of
H~ = (H - b)/a is K4 (:func:`~..ops.block_kernels.block_step`) through
:class:`~..ops.block_lanczos.BlockOperator`, with the three-term step of
``ops/kubo.py _next``: per group two launches for the left vector
``A e_s`` (``Y H~ (X e_s)`` and ``X H~ (Y e_s)``) and one per moment
n >= 1, ``n_mom + 1`` in all (:func:`launches`).  The JAX package forms
the (W, W) cross-site product of a chunk and keeps its diagonal 18 x 18
blocks; here each start block's own block ``left^H T_n`` is the only one
computed (:func:`~..ops.block_lanczos.gram_sum`).

Kept from the JAX package (ROADMAP queue 3): H~ is the non-HoH operator
even when ``hoh`` is set, and it recurs on ``ee``/``iz``, so an impurity's
local zone would be dropped; an impurity cluster raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.block_lanczos import BlockOperator, block_start_vectors, gram_sum
from ..ops.chebyshev import jackson_kernel
from ..ops.haydock_kernels import GATHER_BYTES
from ..ops.kubo import CPU_BUDGET, MARGIN, _next
from ..physics.energy_mesh import EnergyMesh
from ..physics.quadrature import simpson_f_cumulative
from ..utils.logger import g_logger
from ..utils.timer import g_timer
from .bulk import BulkSystem

IMPURITY_ORBITAL = ("ROADMAP queue 3, 'the orbital moment on an impurity "
                    "cluster drops the local zone's rows'")
# vectors of one start block alive at once: psi0, left, the chain's two
# and the step's temporaries
WORK_VECS = 10


def plan(kk: int, n_sites: int, device: torch.device,
         plain: bool = False) -> int:
    """Start blocks per group: as many of ``n_sites`` as the device's free
    memory (with what torch's allocator holds unused) less a margin, or
    :data:`~..ops.kubo.CPU_BUDGET` on the CPU, holds at
    :data:`WORK_VECS` vectors each."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        budget = int(free * (1.0 - MARGIN))
    else:
        budget = CPU_BUDGET
    unit = (kk + 1) * 18 * 18 * 16  # bytes of one start block's vector
    budget -= GATHER_BYTES if plain else 0  # the plain K4's gather
    r = budget // (WORK_VECS * unit)
    if r < 1:
        raise MemoryError(f"orbital moment: one start block's chain at "
                          f"kk={kk} does not fit {budget} bytes")
    return int(min(r, n_sites))


def launches(n_mom: int, n_sites: int, group: int) -> int:
    """K4 launches of :func:`orbital_moments`: ``n_mom + 1`` per group."""
    return -(-n_sites // group) * (n_mom + 1)


def orbital_moments(op: BlockOperator, xs: torch.Tensor, ys: torch.Tensor,
                    sites: Sequence[int], n_mom: int, a: float, b: float,
                    group: int, plain: bool = False) -> torch.Tensor:
    """sum over ``sites`` of mu_n = <A e_s | T_n(H~) e_s>, (n_mom, 18, 18)
    on ``op``'s device, ``group`` sites at a time.  ``xs``/``ys``: (kk+1,)
    scaled coordinates with a zero at kk; ``plain=True`` runs the plain
    versions of K4."""
    dev, kk = xs.device, op.kk
    x, y = xs[:, None, None], ys[:, None, None]
    mu = torch.zeros((n_mom, 18, 18), dtype=torch.complex128, device=dev)

    def scaled(v):  # H~ v, with a zero row kk
        return _next(op, v, None, a, b, plain)

    for g0 in range(0, len(sites), group):
        psi0 = block_start_vectors(kk, [int(s) for s in
                                        sites[g0:g0 + group]], dev)
        # A e_s with the reference's ordering: lv1 = Y H~ (X psi0),
        # lv2 = X H~ (Y psi0); kept conjugated for the Gram
        left = (1j * (y * scaled(x * psi0) - x * scaled(y * psi0))
                ).conj_physical()
        w0, w1 = None, psi0
        for n in range(n_mom):
            if n > 0:
                w0, w1 = w1, _next(op, w1, w0, a, b, plain)
            mu[n] += gram_sum(left[:kk], w1[:kk]).sum(0)
        del psi0, left, w0, w1
    return mu


class OrbitalMoment:
    def __init__(self, sys: BulkSystem, workdir: str = "."):
        if sys.cfg.control.calctype == "I":
            raise NotImplementedError(
                f"post_processing='orbital_modern' with calctype='I': "
                f"{IMPURITY_ORBITAL}")
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir

    def run(self, n_sites: Optional[int] = None,
            group: Optional[int] = None) -> np.ndarray:
        """The trace over ``n_sites`` sites spread evenly over the cluster
        (all of them by default), ``group`` at a time (:func:`plan` by
        default; kept as ``self.group``), and ``fort.50``; returns Lz(E)
        on the energy mesh."""
        cfg = self.cfg
        sys = self.sys
        cl = sys.cluster
        sys.build_hamiltonian()
        hb = sys.ham
        emesh = EnergyMesh.build(cfg.energy)
        lld = cfg.control.lld
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0
        ntype = hb.ee.shape[0]
        lsh = hb.lsham if hb.lsham is not None else np.zeros(
            (ntype, 18, 18), np.complex128)
        dev = sys.device

        def coord(k):
            return torch.as_tensor(np.append(cl.cr[:, k] * cl.alat, 0.0),
                                   dtype=torch.float64, device=dev)

        sites = (np.arange(cl.kk) if n_sites is None
                 else np.linspace(0, cl.kk - 1, n_sites).astype(int))
        self.group = group or plan(cl.kk, len(sites), dev, sys.plain)
        with g_timer.section("orbital-moments-kpm"):
            op = BlockOperator(hb.ee, hb.iz, hb.cols, lsh).to(dev)
            mu = orbital_moments(op, coord(0), coord(1), sites, lld,
                                 float(a), float(b), self.group,
                                 plain=sys.plain).cpu().numpy()
        g_logger.info(f"orbital_modern: {len(sites)} sites in groups of "
                      f"{self.group}")
        mu /= float(len(sites))
        kern = jackson_kernel(lld)
        mu *= kern[:, None, None]
        mu[1:] *= 2.0

        # KPM reconstruction (chebyshev_orbital_mod :2995-3030)
        w = (emesh.ene - b) / a
        acx = np.arccos(np.clip(w, -1.0, 1.0))
        n_idx = np.arange(lld)
        expf = -1j * np.exp(-1j * n_idx[None, :] * acx[:, None])
        # reference accumulates mu * Im(exp_factor)
        g0 = np.einsum("en,nab->abe", expf.imag, mu)
        g0 /= np.sqrt(np.maximum(a**2 - (emesh.ene - b) ** 2, 1e-300))
        lzi = np.trace(g0, axis1=0, axis2=1).real

        cum = simpson_f_cumulative(lzi, emesh.ene, emesh.nv1)
        path = os.path.join(self.workdir, "fort.50")
        with open(path, "w") as fh:
            for ie in range(emesh.npts):
                fh.write(f"{emesh.ene[ie] - emesh.fermi:16.6e}"
                         f"{-cum[ie] / np.pi:16.6e}"
                         f"{-lzi[ie] / np.pi:16.6e}\n")
        g_logger.info(f"orbital_modern: wrote {path}")
        return lzi
