"""The bcc box and its recursions on a grid, in plain PyTorch.

The cluster of a ``pbc`` bulk run with ``n1 x n2 x n3`` cells and no wrap
(``b1 = b2 = b3 = .false.``) is the box of bcc sites ``m = (m1, m2, m3)``,
``1 - lc <= m_k <= n_k - lc`` with ``lc = (n_k + 1) // 2``, in primitive
coordinates (``r = A m`` in lattice units), the rec atom at ``m = 0``.  A
vector lives here on the grid ``(n1, n2, n3, d, C)``, and ``H psi`` is a sum
over the neighbour shifts ``s`` of ``h_s @ psi[m + s]``, each a slice of the
grid: the program's ELL tables (``cols``, ``iz``) are not read.  The
recursions are the textbook block Lanczos and the block Chebyshev moments of
the reference code (``recursion.f90`` ``recur_b``, ``chebyshev_recur``),
written out here.  ``cone`` counts the sites a start set reaches, for the
bounds of :mod:`roofline`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .frozen.geometry.crystal import primitive_cell


class BccBox:
    """Geometry of the no-wrap bcc box (``bravais`` with ``pbc``)."""

    def __init__(self, dims: Sequence[int], alat: float, ct1: float):
        self.dims = tuple(int(n) for n in dims)
        self.alat = float(alat)
        self.a = primitive_cell("bcc").a  # columns: primitive vectors
        self.lc = np.array([(n + 1) // 2 for n in self.dims])
        rng = np.arange(-3, 4)
        m = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                     -1).reshape(-1, 3)
        dist = np.linalg.norm(m @ self.a.T, axis=1) * self.alat
        keep = (dist < ct1) & (dist > 1e-9)
        order = np.lexsort((m[keep, 2], m[keep, 1], m[keep, 0],
                            dist[keep].round(9)))
        #: neighbour shifts in primitive coordinates, nearest first
        self.shifts = m[keep][order]
        #: their bond vectors r_j - r_i in Angstrom
        self.vectors = (self.shifts @ self.a.T) * self.alat

    @property
    def kk(self) -> int:
        return int(np.prod(self.dims))

    def index(self, m) -> Tuple[int, int, int]:
        """Grid index of the site at primitive coordinates ``m``."""
        g = np.asarray(m) + self.lc - 1
        if not all(0 <= g[k] < self.dims[k] for k in range(3)):
            raise ValueError(f"site {m} lies outside the box {self.dims}")
        return tuple(int(x) for x in g)

    def site_of(self, r_lat) -> np.ndarray:
        """Primitive coordinates of the lattice point ``r_lat`` (lattice
        units)."""
        m = np.linalg.solve(self.a, np.asarray(r_lat, dtype=np.float64))
        mi = np.rint(m)
        if np.abs(m - mi).max() > 1e-6:
            raise ValueError(f"{r_lat} is not a bcc lattice point")
        return mi.astype(np.int64)

    def positions_ang(self, radius: float) -> np.ndarray:
        """Box sites within ``radius`` Angstrom of the rec atom, relative to
        it, the rec atom first (the screening cluster of ``strconst``)."""
        rngs = [np.arange(1 - lc, n - lc + 1)
                for lc, n in zip(self.lc, self.dims)]
        span = int(np.ceil(radius / (0.5 * self.alat))) + 2
        rngs = [r[np.abs(r) <= span] for r in rngs]
        m = np.stack(np.meshgrid(*rngs, indexing="ij"), -1).reshape(-1, 3)
        r = (m @ self.a.T) * self.alat
        d2 = (r ** 2).sum(1)
        sel = (d2 < radius ** 2) & (d2 > 1e-8)
        return np.concatenate([np.zeros((1, 3)), r[sel]])

    def _slices(self, s):
        dst, src = [], []
        for k in range(3):
            n = self.dims[k]
            if s[k] >= 0:
                dst.append(slice(0, n - s[k]))
                src.append(slice(s[k], n))
            else:
                dst.append(slice(-s[k], n))
                src.append(slice(0, n + s[k]))
        return tuple(dst), tuple(src)

    def apply(self, h: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """``y[m] = h[0] @ psi[m] + sum_k h[k + 1] @ psi[m + shifts[k]]``
        over the box (sites outside it are zero).  h: (1 + nshift, d, d);
        psi: (n1, n2, n3, d, C)."""
        y = torch.matmul(h[0], psi)
        for k, s in enumerate(self.shifts):
            dst, src = self._slices(s)
            y[dst] += torch.matmul(h[k + 1], psi[src])
        return y

    def cone(self, starts: Sequence, steps: int) -> List[Tuple[int, int]]:
        """For k = 0 .. steps - 1: (sites within k hops of the ``starts``
        (primitive coordinates), the occupied (row, slot) blocks that read
        them: each site's own slot and one per neighbour inside the box)."""
        mask = np.zeros(self.dims, dtype=bool)
        for m in starts:
            mask[self.index(m)] = True
        deg = np.ones(self.dims, dtype=np.int64)
        for s in self.shifts:
            dst, _ = self._slices(s)
            deg[dst] += 1
        out = []
        for _ in range(steps):
            out.append((int(mask.sum()), int(deg[mask].sum())))
            grown = mask.copy()
            for s in self.shifts:
                dst, src = self._slices(s)
                grown[dst] |= mask[src]
            mask = grown
        return out


def start_blocks(box: BccBox, chains, d: int, dtype, device) -> torch.Tensor:
    """psi0 (n1, n2, n3, d, R d): chain r holds ``coef * I`` at each of its
    ``[(m, coef), ...]``."""
    psi0 = torch.zeros(box.dims + (d, d * len(chains)), dtype=dtype,
                       device=device)
    eye = torch.eye(d, dtype=dtype, device=device)
    for r, chain in enumerate(chains):
        for m, coef in chain:
            psi0[box.index(m) + (slice(None), slice(d * r, d * (r + 1)))] = \
                coef * eye
    return psi0


def _gram(x: torch.Tensor, y: torch.Tensor, d: int) -> torch.Tensor:
    """(R, d, d) blocks ``sum_sites x[:, r]^H y[:, r]``."""
    xr = x.reshape(-1, d, x.shape[-1] // d, d)
    yr = y.reshape(-1, d, y.shape[-1] // d, d)
    return torch.einsum("ibra,ibrc->rac", xr.conj(), yr)


def _times(x: torch.Tensor, m: torch.Tensor, d: int) -> torch.Tensor:
    """``x[..., r] @ m[r]`` for every start block r."""
    shape = x.shape
    xr = x.reshape(-1, d, shape[-1] // d, d)
    return torch.einsum("ibrc,rcx->ibrx", xr, m).reshape(shape)


def _eig_sqrt(b2: torch.Tensor):
    """B = sqrt(B^2) and B^-1 (``crecal_b`` :1977-1999), eigenvalues under
    1e-14 of the largest clamped as the reference does at breakdown."""
    ev, u = torch.linalg.eigh(b2)
    ev = torch.maximum(ev, 1e-300 + 1e-14 * ev[..., -1:])
    lam = torch.sqrt(ev).to(b2.dtype)
    uh = u.conj().transpose(-1, -2)
    return (u * lam[..., None, :]) @ uh, (u / lam[..., None, :]) @ uh


def block_lanczos(box: BccBox, h: torch.Tensor, psi0: torch.Tensor,
                  lld: int):
    """Block Lanczos coefficients (a_b, b2_b), each (lld, R, d, d), with the
    reference's conventions: b2_b[0] = I, a_b[lld - 1] = 0, b2_b[lld - 1]
    the last residual Gram."""
    d = psi0.shape[-2]
    r = psi0.shape[-1] // d
    a_b = psi0.new_zeros((lld, r, d, d))
    b2_b = psi0.new_zeros((lld, r, d, d))
    sum_b = torch.eye(d, dtype=psi0.dtype,
                      device=psi0.device).expand(r, d, d)
    psi, pmn = psi0, torch.zeros_like(psi0)
    for ll in range(lld - 1):
        hpsi = box.apply(h, psi)
        a_ll = _gram(psi, hpsi, d)
        pmn = hpsi - pmn - _times(psi, a_ll, d)
        del hpsi
        b2 = _gram(pmn, pmn, d)
        b, b_inv = _eig_sqrt(b2)
        psi, pmn = _times(pmn, b_inv, d), _times(psi, b, d)
        a_b[ll] = a_ll
        b2_b[ll] = sum_b
        sum_b = b2
    b2_b[lld - 1] = sum_b
    return a_b, b2_b


def chebyshev_moments(box: BccBox, h: torch.Tensor, psi0: torch.Tensor,
                      lld: int, a: float, b: float) -> torch.Tensor:
    """Block Chebyshev moments mu_n, (2 lld + 2, R, d, d), of
    ``H~ = (H - b) / a`` with the double-pass trick
    mu_{2n+1} = 2 <p_n|p_n> - mu_0, mu_{2n+2} = 2 <p_{n+1}|p_n> - mu_1."""
    d = psi0.shape[-2]

    def ht(p):
        return (box.apply(h, p) - b * p) / a

    p0 = psi0
    p1 = ht(p0)
    mu0, mu1 = _gram(p0, p0, d), _gram(p0, p1, d)
    mu = [mu0, mu1]
    for _ in range(lld):
        p2 = 2.0 * ht(p1) - p0
        mu += [2.0 * _gram(p1, p1, d) - mu0, 2.0 * _gram(p2, p1, d) - mu1]
        p0, p1 = p1, p2
    return torch.stack(mu)
