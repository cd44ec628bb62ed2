"""Exchange-coupling post-processing: Jij, DMI vector Dij, anisotropy Aij.

Port of ``rslmtoasa_tpu/models/exchange.py`` (reference ``calculation.f90
post_processing_exchange`` :816-951):

* pair start blocks (``recur_b_ij`` :1655-1745): the superpositions
  (i+j), (i-j), (i+ij), (i-ij) of each pair i != j, and the block of atom
  i alone for i == j, in compact form (``StartBlocks``: the start rows and
  each chain's multiple of I on them), recurred through
  ``parallel/dispatch.py`` into ``BlockOperator`` and K4 (block or
  Chebyshev); each route builds on the system's device only the rows and
  chains it recurs (the wavefront its first stage, a rank its chains);
* the intersite Green functions Gij/Gji from the chains: one
  ``get_terminf`` and one batched ``bgreen``, or one
  ``chebyshev_green``, on the device, then the four-chain combination and
  the n/x/y/z spin components as tensor ops there (``green.f90
  calculate_intersite_gf`` :425-470);
* the LKAG traces (``exchange.f90 calculate_exchange`` :1437-1560),
  batched over pairs and energies on the device, with the Fermi-weighted
  Simpson integral on the host; outputs ``jij.out``, ``dij.out``,
  ``aij.out``, ``jtens.out`` in the reference's layout (mRy: x 1e3 / 4 pi);
* the analyses on the pair Green functions: the two-index split, Jijk,
  the auxiliary-GF Jij, the imaginary-axis Gauss-Legendre Jij, Gilbert
  damping and the moment of inertia, as tensor ops on the device.

The JAX package numbers four chains per pair (chain ``4 p + n``) and
recurs three all-zero ones for each i == j pair.  Here only the live chains
recur; ``a_b``, ``b_b`` and ``mu`` keep the JAX numbering, a dead chain's
slot holding what the JAX recursion gives it (zeros, and ``b_b[0] = I``).
No dead chain reaches ``get_terminf``, ``bgreen`` or ``chebyshev_green``:
a zero chain makes a continued-fraction level singular where E = 0 lies on
the energy mesh (ROADMAP queue 3, 'the zero chains of i == j pairs').
"""

from __future__ import annotations

import functools
import os
from typing import List

import numpy as np
import torch

from ..ops.block_lanczos import StartBlocks, zsqr
from ..ops.chebyshev import chebyshev_green
from ..parallel.dispatch import block_lanczos_auto, chebyshev_moments_auto
from ..physics.energy_mesh import EnergyMesh
from ..physics.greens import bgreen, get_terminf
from ..physics.quadrature import simpson_f_cumulative, simpson_f_fermi
from ..utils.device import synchronize
from ..utils.logger import g_logger
from ..utils.timer import g_timer
from .bulk import BulkSystem
from .scf import ANG2AU

IMPURITY_EXCHANGE = ("ROADMAP queue 3, 'exchange on an impurity cluster "
                     "drops the local zone's rows'")
MRY = 1.0e3 / 4.0 / np.pi  # trace integral -> mRy
_C = 1.0 / np.sqrt(2.0)
# (i, j) coefficients of the four start blocks of a pair i != j
SIGNS = ((_C, _C), (_C, -_C), (_C, 1j * _C), (_C, -1j * _C))
# (theta, theta', phi, phi') of the tensor components xx .. zz
_HP = 0.5 * np.pi
ANGLES = np.array([
    [_HP, _HP, 0, 0], [_HP, _HP, 0, _HP], [_HP, 0, 0, 0],
    [_HP, _HP, _HP, 0], [_HP, _HP, _HP, _HP], [_HP, 0, _HP, 0],
    [0, _HP, 0, 0], [0, _HP, 0, _HP], [0, 0, 0, 0],
])


def trio_pairs(trios) -> np.ndarray:
    """The pairs (i, j), (i, k), (j, k) of each trio row [i, j, k, ...]
    (1-based), in the order :meth:`ExchangeCalculation.calculate_jijk`
    reads them (``calculation.f90`` :949)."""
    pairs = []
    for t in np.atleast_2d(trios):
        i, j, k = int(t[0]), int(t[1]), int(t[2])
        pairs += [(i, j), (i, k), (j, k)]
    return np.asarray(pairs, dtype=np.int64)


def pair_chains(pairs: np.ndarray) -> np.ndarray:
    """The JAX package's numbers ``4 p + n`` of the live chains of 0-based
    ``pairs``: four per pair i != j, chain 0 of a pair i == j."""
    return np.array([4 * p + n for p, (i, j) in enumerate(pairs)
                     for n in range(1 if i == j else 4)], dtype=np.int64)


def pair_start_blocks(kk: int, pairs: np.ndarray, device) -> StartBlocks:
    """Start blocks of the live chains of 0-based ``pairs`` (in
    :func:`pair_chains` order) in compact form: the block of atom i for
    i == j, else ``SIGNS`` times I on atoms i and j.  Made dense on
    ``device``, (kk+1, 18, 18 R) complex128, they are the JAX package's
    ``pair_start_vectors`` without its dead chains, in the port's layout."""
    chains = []
    for ch in pair_chains(pairs):
        i, j = (int(x) for x in pairs[ch // 4])
        # one row where i == j: the reference overwrites it
        chains.append([(i, 1.0)] if i == j else
                      list(zip((i, j), SIGNS[ch % 4])))
    return StartBlocks(kk, chains, device)


def _spread(live: np.ndarray, chains: np.ndarray, nchain: int) -> np.ndarray:
    """(n, R_live, ...) -> (n, nchain, ...) in the JAX numbering, zeros in
    the dead chains' slots."""
    out = np.zeros(live.shape[:1] + (nchain,) + live.shape[2:], live.dtype)
    out[:, chains] = live
    return out


def _fermi_integral(y: np.ndarray, emesh: EnergyMesh) -> np.ndarray:
    """``simpson_f_fermi`` of each row of y (..., NE)."""
    return np.apply_along_axis(simpson_f_fermi, -1, y, emesh.ene,
                               emesh.fermi, emesh.nv1)


def _trace(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tr(a @ b) over the last two axes."""
    return torch.einsum("...ab,...ba->...", a, b)


def _spin_components(g: torch.Tensor) -> dict:
    """n/x/y/z components of (..., 18, 18) intersite blocks (``green.f90``
    :456-467): (..., 9, 9) each."""
    uu, dd = g[..., :9, :9], g[..., 9:, 9:]
    ud, du = g[..., :9, 9:], g[..., 9:, :9]
    return {"n": 0.5 * (uu + dd), "z": 0.5 * (uu - dd),
            "y": 0.5 * (1j * ud - 1j * du), "x": 0.5 * (ud + du)}


def _angle_factors(p: int):
    """(cos th cos th', sin th sin th' e^{i(phi'-phi)}, sin th sin th'
    e^{i(phi-phi')}) of tensor component p, as Python numbers."""
    th, thp, ph, php = ANGLES[p]
    s = np.sin(th) * np.sin(thp)
    return (float(np.cos(th) * np.cos(thp)),
            complex(s * np.exp(1j * (php - ph))),
            complex(s * np.exp(1j * (ph - php))))


def _per_energy(t) -> torch.Tensor:
    """(P, a, b, NE), the JAX package's layout -> (P, NE, a, b)."""
    return t.permute(0, 3, 1, 2)


class ExchangeCalculation:
    def __init__(self, sys: BulkSystem, pairs_1based: np.ndarray,
                 workdir: str = "."):
        if sys.cfg.control.calctype == "I":
            raise NotImplementedError(
                f"post_processing='exchange' with calctype='I': "
                f"{IMPURITY_EXCHANGE}")
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir
        self.pairs = np.asarray(pairs_1based, dtype=np.int64) - 1  # 0-based
        kk = sys.cluster.kk
        if self.pairs.ndim != 2 or self.pairs.shape[1] != 2 or not (
                (self.pairs >= 0) & (self.pairs < kk)).all():
            raise ValueError(f"exchange pairs must be (n, 2) atoms in "
                             f"1..{kk}: {pairs_1based!r}")
        self.chains = pair_chains(self.pairs)

    @property
    def device(self) -> torch.device:
        return self.sys.device

    def _tensor(self, x, dtype=torch.complex128) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    def run(self):
        """The pairs' recursion, Green functions and LKAG integrals: the
        Jij table (``jij.out``, ``dij.out``, ``aij.out``, ``jtens.out``);
        returns one dict per pair."""
        with g_timer.section("jij-table"):
            return self._run()

    def _run(self):
        cfg = self.cfg
        sys = self.sys
        cl = sys.cluster
        lld = cfg.control.lld
        hoh = cfg.hamiltonian.hoh
        emesh = EnergyMesh.build(cfg.energy)

        # build_pot -> Hamiltonian from file parameters; predls afterwards
        # feeds d_matrix (post_processing_exchange ordering)
        sys.build_hamiltonian()
        for at in sys.atoms:
            at.potential.predls(cl.wav * ANG2AU)

        hb = sys.ham
        ntype = hb.ee.shape[0]
        lsham = hb.lsham if hb.lsham is not None else np.zeros(
            (ntype, 18, 18), dtype=np.complex128)
        nchain = 4 * len(self.pairs)
        tables = dict(hoh=hoh, hso=hb.eeo if hoh else None,
                      enim=hb.enim if hoh else None, plain=sys.plain)
        with g_timer.section("pair-recursion"):
            # compact: each route of the dispatch builds what it recurs
            psi0 = pair_start_blocks(cl.kk, self.pairs, self.device)
            if cfg.control.recur == "chebyshev":
                # pair-resolved Chebyshev moments (chebyshev_recur_ij
                # :2376-2494), unguarded as the reference's pair recursion
                mu = chebyshev_moments_auto(
                    hb.ee, lsham, hb.iz, hb.cols, psi0, lld,
                    (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3),
                    (emesh.energy_max + emesh.energy_min) / 2.0,
                    guard=False, **tables)
            else:
                a_b, b2_b = block_lanczos_auto(hb.ee, lsham, hb.iz, hb.cols,
                                               psi0, lld, **tables)
            del psi0
        if cfg.control.recur == "chebyshev":
            self.mu = _spread(mu, self.chains, nchain)
        else:
            self.a_b = _spread(a_b, self.chains, nchain)
            b2_b = _spread(b2_b, self.chains, nchain)
            # a zero chain's recursion keeps its b2_b[0] = I
            dead = np.setdiff1d(np.arange(nchain), self.chains)
            b2_b[0, dead] = np.eye(18)
            with g_timer.section("terminators"):  # host
                self.b_b = zsqr(b2_b)
        with g_timer.section("intersite-gf"):
            self.intersite_gf(emesh)
        with g_timer.section("jij-integrals"):
            results = self._lkag(emesh)
        self._write_outputs(results)
        return results

    # ------------------------------------------------------------------
    def _combine(self, g: torch.Tensor):
        """Gij and Gji of every pair, (P, NE, 18, 18), from the live chains'
        Green functions g (R_live, 18, 18, NE): chain 0 for i == j, else
        (``green.f90`` :445-455) Gij = (G0 - G1 + (G2 - G3)/i) / 2 and
        Gji = (G0 - G1 - (G2 - G3)/i) / 2."""
        slot = {int(ch): r for r, ch in enumerate(self.chains)}
        idx = [[slot[4 * p + (n if i != j else 0)] for n in range(4)]
               for p, (i, j) in enumerate(self.pairs)]
        g4 = _per_energy(g)[torch.as_tensor(idx, device=g.device)]
        diff = (1.0 / 1j) * (g4[:, 2] - g4[:, 3])
        onsite = torch.as_tensor(self.pairs[:, 0] == self.pairs[:, 1],
                                 device=g.device)[:, None, None, None]
        gij = torch.where(onsite, g4[:, 0], 0.5 * (g4[:, 0] - g4[:, 1] + diff))
        gji = torch.where(onsite, g4[:, 0], 0.5 * (g4[:, 0] - g4[:, 1] - diff))
        return gij, gji

    def intersite_gf(self, emesh):
        """Gij/Gji per pair on the device from the live chains of ``a_b`` /
        ``b_b`` (one ``get_terminf``, one ``bgreen``) or of
        ``mu`` (one ``chebyshev_green``): ``gij_full``/``gji_full`` (njij,
        18, 18, NE) and the spin components ``comps_i``/``comps_j``, dicts
        of (njij, 9, 9, NE) keyed 'n', 'x', 'y', 'z' (the JAX package's
        layouts, as views of tensors laid out per energy)."""
        live = self.chains
        if self.cfg.control.recur == "chebyshev":
            g = chebyshev_green(self.mu[:, live], emesh.ene,
                                emesh.energy_min, emesh.energy_max,
                                self.device, host=False)
        else:
            a_b, b_b = self.a_b[:, live], self.b_b[:, live]
            # the fits on the device (the plain engine's on the host)
            on = "cpu" if self.sys.plain else self.device
            with g_timer.section("terminators"):
                self.a_inf, self.b_inf = get_terminf(
                    torch.as_tensor(a_b, device=on),
                    torch.as_tensor(b_b, device=on))
            g = bgreen(a_b, b_b, self.a_inf, self.b_inf, emesh.ene,
                       self.device, sym_term=self.cfg.control.sym_term,
                       host=False)
        gij, gji = self._combine(g)
        self.gij_full = gij.permute(0, 2, 3, 1)
        self.gji_full = gji.permute(0, 2, 3, 1)
        self.comps_i = {k: v.permute(0, 2, 3, 1)
                        for k, v in _spin_components(gij).items()}
        self.comps_j = {k: v.permute(0, 2, 3, 1)
                        for k, v in _spin_components(gji).items()}
        synchronize(self.device)

    # ------------------------------------------------------------------
    def _d_diagonals(self, ene: np.ndarray) -> torch.Tensor:
        """(P, 2, NE, 9): the diagonals of ``Potential.d_matrix`` of atom i
        and of atom j of each pair at every energy, built once per type."""
        cl = self.sys.cluster
        tab = self._tensor(np.stack([
            np.stack([np.diag(at.potential.d_matrix(e)).real for e in ene])
            for at in self.sys.atoms]), torch.float64)  # (ntype, NE, 9)
        types = self._tensor(cl.iz[self.pairs] - 1, torch.long)  # (P, 2)
        return tab[types]

    def _lkag(self, emesh) -> List[dict]:
        cl = self.sys.cluster
        d = self._d_diagonals(emesh.ene)
        gi = {k: d[:, 0, :, :, None] * _per_energy(v)
              for k, v in self.comps_i.items()}
        gj = {k: d[:, 1, :, :, None] * _per_energy(v)
              for k, v in self.comps_j.items()}
        # Jij: tr[d_i G^n_ij d_j G^n_ji - sum_k d_i G^k_ij d_j G^k_ji]
        jtot = _trace(gi["n"], gj["n"])
        for k in "xyz":
            jtot = jtot - _trace(gi[k], gj[k])
        dmi = [_trace(gi["n"], gj[k]) - _trace(gj["n"], gi[k]) for k in "xyz"]
        aij = [0.5 * (_trace(gi[k], gj[l]) + _trace(gj[k], gi[l]))
               for k in "xyz" for l in "xyz"]
        y = torch.stack([jtot.imag] + [t.real for t in dmi]
                        + [t.imag for t in aij], 1).cpu().numpy()
        vals = _fermi_integral(y, emesh)  # (P, 13)
        vals *= MRY
        results = []
        for p, (i, j) in enumerate(self.pairs):
            results.append({
                "i": int(i), "j": int(j),
                "iz_i": int(cl.iz[i]), "iz_j": int(cl.iz[j]),
                "rij": cl.cr[j] - cl.cr[i],
                "dist": float(np.linalg.norm(cl.cr[i] - cl.cr[j])),
                "jij": float(vals[p, 0]), "dmi": vals[p, 1:4].copy(),
                "aij": vals[p, 4:].reshape(3, 3).copy(),
            })
            g_logger.info(f"Jij pair ({i+1},{j+1}): {vals[p, 0]:.6f} mRy")
        return results

    # ------------------------------------------------------------------
    def _write_outputs(self, results: List[dict]):
        # jtens.out: J on the diagonal, DMI skew, Aij full tensor
        # (calculate_exchange :1581-1599; the reference prints the
        # tensor to stdout and leaves the opened jtens.out empty --
        # here the documented tensor goes into the file)
        with open(os.path.join(self.workdir, "jtens.out"), "w") as f60:
            for r in results:
                jt = np.eye(3) * r["jij"]
                d = r["dmi"]
                jt += np.array([[0, d[2], -d[1]],
                                [-d[2], 0, d[0]],
                                [d[1], -d[0], 0]])
                jt += r["aij"]
                f60.write(f"{r['iz_i']:8d}{r['iz_j']:8d}  " + "".join(
                    f"{x:12.6f}" for x in r["rij"]) + "  " + "".join(
                    f"{v:12.6f}" for v in jt.ravel())
                    + f" {r['dist']:12.6f}\n")
        with open(os.path.join(self.workdir, "jij.out"), "w") as f20, \
                open(os.path.join(self.workdir, "dij.out"), "w") as f30, \
                open(os.path.join(self.workdir, "aij.out"), "w") as f40:
            for r in results:
                head = (f"{r['iz_i']:8d}{r['iz_j']:8d}  "
                        + "".join(f"{x:12.6f}" for x in r["rij"]) + "  ")
                f20.write(head + f"{r['jij']:12.6f} {r['dist']:12.6f}\n")
                f30.write(head + "".join(f"{x:12.6f}" for x in r["dmi"])
                          + f" {r['dist']:12.6f}\n")
                # Fortran writes aij in column-major order
                f40.write(head
                          + "".join(f"{x:12.6f}" for x in r["aij"].T.ravel())
                          + f" {r['dist']:12.6f}\n")

    # ------------------------------------------------------------------
    def calculate_jijk(self, trios):
        """Spin-lattice three-site coupling Jijk (``exchange.f90
        calculate_jijk`` :338-612, real-space torque-correlation of
        Sci. Rep. 7, 931 (2017)).

        trios: (njijk, 6) rows [i, j, k, dx, dy, dz] (1-based atoms,
        displacement direction of atom k).  Requires construction with
        :func:`trio_pairs` (3 njijk pairs) and run().  Returns the
        (njijk, 9) tensor in meV/a.u.; writes jijk.out (the reference only
        prints to stdout).
        """
        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ene = emesh.ene
        lmax = 2
        K = (lmax + 1) ** 2
        uu, dd = slice(0, K), slice(K, 2 * K)
        t = self._tensor
        out_rows = []
        results = np.zeros((len(trios), 9))
        for nt, trio in enumerate(trios):
            i, j, k = (int(trio[0]) - 1, int(trio[1]) - 1,
                       int(trio[2]) - 1)
            disp = np.asarray(trio[3:6], float)
            u = disp / np.linalg.norm(disp)
            pots = {a: self.sys.atoms[int(cl.iz[a]) - 1].potential
                    for a in (i, j, k)}
            scr = {a: pots[a].qpar for a in (i, j, k)}
            zero_scr = np.zeros((lmax + 1, 2))
            pm = {a: p_matrix(pots[a], lmax, ene) for a in (i, j, k)}
            pm0 = {a: transform_pmatrix(pm[a], scr[a], zero_scr, lmax)
                   for a in (i, j, k)}
            umat_d = disp_matrix(lmax, cl.wav, u)  # (2K, 2K)
            # U_k(E) = D P0_k + P0_k D^T per energy (udisp_matrix)
            umk = t(umat_d[None] * pm0[k][:, None, :]
                    + pm0[k][:, :, None] * umat_d.T[None])

            def aux(g, a, b):
                """delta_a G_ab delta_b, then orthogonal->canonical
                (auxiliary_gij + transform_auxiliary_gij)."""
                da = t(_dele18(pots[a]), torch.float64)
                db = t(_dele18(pots[b]), torch.float64)
                gax = g.permute(2, 0, 1) * da[None, :, None] \
                    * db[None, None, :]
                r1 = t(pm[a] / pm0[a])  # (NE, 2K) diagonal rescale
                r2 = t(pm[b] / pm0[b])
                out = r1[:, :, None] * gax * r2[:, None, :]
                if a == b:
                    # (beta - alpha) with beta = 0
                    scr_d = np.concatenate([np.repeat(-scr[a][:, s],
                                                      [1, 3, 5])
                                            for s in (0, 1)])
                    out = out + torch.diag_embed(
                        t(scr_d[None, :] * (pm[a] / pm0[a])))
                return out

            base = 3 * nt
            g_ij = aux(self.gij_full[base + 0], i, j)
            g_ji = aux(self.gji_full[base + 0], j, i)
            g_jk = aux(self.gij_full[base + 2], j, k)
            g_ki = aux(self.gji_full[base + 1], k, i)
            g_kj = aux(self.gji_full[base + 2], k, j)
            dp_i = t(pm0[i][:, :K] - pm0[i][:, K:])  # (NE, K) diagonal
            dp_j = t(pm0[j][:, :K] - pm0[j][:, K:])
            t1 = umk[:, dd, dd] @ g_ki[:, dd, dd]
            t2 = umk[:, uu, uu] @ g_ki[:, uu, uu]
            t3 = dp_i[:, :, None] * g_ij[:, uu, uu]
            t4 = dp_j[:, :, None] * g_jk[:, uu, uu]
            t5 = umk[:, uu, uu] @ g_kj[:, uu, uu]
            t6 = umk[:, dd, dd] @ g_kj[:, dd, dd]
            t7 = dp_j[:, :, None] * g_ji[:, uu, uu]
            t8 = dp_i[:, :, None] * g_ij[:, dd, dd]
            t9 = dp_j[:, :, None] * g_jk[:, dd, dd]
            t10 = dp_j[:, :, None] * g_ji[:, dd, dd]
            m342 = t3 @ (t4 @ t2)
            m842 = t8 @ (t4 @ t2)
            m391 = t3 @ (t9 @ t1)
            m891 = t8 @ (t9 @ t1)
            m3510 = t3 @ (t5 @ t10)
            m8610 = t8 @ (t6 @ t10)
            m357 = t3 @ (t5 @ t7)
            m867 = t8 @ (t6 @ t7)
            ys = []
            for p in range(9):
                cc, ssp, ssm = _angle_factors(p)
                tot = (cc * m342 + ssp * m842 + ssm * m391 + cc * m891
                       + ssm * m3510 + cc * m8610 + cc * m357
                       + ssp * m867)
                ys.append(0.5 * torch.diagonal(tot, dim1=1, dim2=2)
                          .sum(-1).imag)
            results[nt] = _fermi_integral(torch.stack(ys).cpu().numpy(),
                                          emesh)
            results[nt] *= (1.0e3 / 8.0 / np.pi) \
                * (13.605693122994 / 1.8897261246)
            out_rows.append(
                f"{i + 1:6d}{j + 1:6d}{k + 1:6d}  "
                + "".join(f"{v:10.6f}" for v in u) + "  "
                + "".join(f"{v:14.9f}" for v in results[nt]) + "\n"
            )
            g_logger.info(
                f"Jijk trio ({i+1},{j+1},{k+1}): "
                + " ".join(f"{v:.6f}" for v in results[nt][:3])
            )
        with open(os.path.join(self.workdir, "jijk.out"), "w") as fh:
            fh.writelines(out_rows)
        return results

    # ------------------------------------------------------------------
    def calculate_jij_auxgreen(self):
        """Jij tensor from auxiliary Green functions (``exchange.f90
        calculate_jij_auxgreen`` :140-336): aux G = delta_i G delta_j,
        DeltaP = P_up - P_dw from the LMTO potential functions; the
        9-component angle tensor for i != j, and the on-site J0 sum rule
        for i == j.  Writes jij_aux.out; returns (njij, 9) in mRy
        (column 0 holds J0 for i == j rows).  Requires run()."""
        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ene = emesh.ene
        K = 9
        uu, dd = slice(0, K), slice(K, 2 * K)
        t = self._tensor
        out = np.zeros((len(self.pairs), 9))
        rows = []
        for p, (i, j) in enumerate(self.pairs):
            it = int(cl.iz[i]) - 1
            jt = int(cl.iz[j]) - 1
            pot_i = self.sys.atoms[it].potential
            pot_j = self.sys.atoms[jt].potential
            pm_i = p_matrix(pot_i, 2, ene)  # (NE, 18) diagonal
            pm_j = p_matrix(pot_j, 2, ene)
            dp_i = t(pm_i[:, :K] - pm_i[:, K:])  # (NE, 9)
            dp_j = t(pm_j[:, :K] - pm_j[:, K:])

            def aux(g, pa, pb):
                da = t(_dele18(pa), torch.float64)
                db = t(_dele18(pb), torch.float64)
                return (g.permute(2, 0, 1) * da[None, :, None]
                        * db[None, None, :])

            gij = aux(self.gij_full[p], pot_i, pot_j)  # (NE, 18, 18)
            gji = aux(self.gji_full[p], pot_j, pot_i)
            t1 = dp_i[:, :, None] * gij[:, uu, uu]
            t2 = dp_j[:, :, None] * gji[:, dd, dd]
            t4 = dp_j[:, :, None] * gji[:, uu, uu]
            if i != j:
                t3 = dp_i[:, :, None] * gij[:, dd, dd]
                m14, m34, m12, m32 = t1 @ t4, t3 @ t4, t1 @ t2, t3 @ t2
                ys = []
                for k in range(9):
                    cc, ssp, ssm = _angle_factors(k)
                    tot = cc * m14 + ssp * m34 + ssm * m12 + cc * m32
                    ys.append(0.5 * torch.diagonal(tot, dim1=1, dim2=2)
                              .sum(-1).imag)
                out[p] = _fermi_integral(torch.stack(ys).cpu().numpy(),
                                         emesh)
            else:
                t3 = dp_i[:, :, None] * (gij[:, uu, uu] - gji[:, dd, dd])
                y = -torch.diagonal(t1 @ t2 + t3, dim1=1, dim2=2) \
                    .sum(-1).imag
                out[p, 0] = _fermi_integral(y.cpu().numpy(), emesh)
            out[p] *= MRY
            rij = cl.cr[j] - cl.cr[i]
            rows.append(f"{it + 1:8d}{jt + 1:8d}  "
                        + "".join(f"{v:12.6f}" for v in rij) + "  "
                        + "".join(f"{v:14.9f}" for v in out[p]) + "\n")
            if i != j:
                g_logger.info(
                    f"Jij_aux pair ({i+1},{j+1}) zz: {out[p, 8]:.6f} mRy,"
                    f" Dij_zz_aux: {0.5 * (out[p, 1] - out[p, 3]):.6f}"
                )
            else:
                g_logger.info(f"J0_aux atom {i+1}: {out[p, 0]:.6f} mRy")
        with open(os.path.join(self.workdir, "jij_aux.out"), "w") as fh:
            fh.writelines(rows)
        return out

    # ------------------------------------------------------------------
    def run_gauss_legendre(self):
        """Fermi-sea exchange via imaginary-axis Gauss-Legendre
        quadrature (``calculate_exchange_gauss_legendre`` :1756-1900 and
        ``green.f90 calculate_intersite_gf_eta`` :471-540).

        The intersite GF is evaluated at z = E_F + i eta for 64 GL nodes
        eta = (1-x)/x on (0, inf), all nodes in one batched ``bgreen``;
        Jij = -sum_n w_n/x_n^2 Re tr[d G d G] with d = Re(ee_onsite_up -
        ee_onsite_dn) (the onsite exchange splitting, not the
        energy-dependent d_matrix).  Writes jij.out / dij.out / aij.out in
        the GL layout.  Requires run() with the block recursion.
        """
        if not hasattr(self, "a_inf"):
            raise ValueError("run_gauss_legendre needs the chains of a run() "
                             "with recur='block'")
        cl = self.sys.cluster
        hb = self.sys.ham
        emesh = EnergyMesh.build(self.cfg.energy)
        # fermi_point: last mesh index with ene <= fermi + 1e-6
        fermi_point = int(np.max(np.nonzero(
            emesh.ene - emesh.fermi <= 1.0e-6
        )[0]))
        tq, wq = np.polynomial.legendre.leggauss(64)
        x = 0.5 * (tq + 1.0)
        w = 0.5 * wq
        g = bgreen(self.a_b[:, self.chains], self.b_b[:, self.chains],
                   self.a_inf, self.b_inf,
                   np.full(64, emesh.ene[fermi_point]), self.device,
                   sym_term=self.cfg.control.sym_term,
                   eta=1j * (1.0 - x) / x, host=False)  # (R, 18, 18, 64)
        gij, gji = self._combine(g)
        gi, gj = _spin_components(gij), _spin_components(gji)
        types = cl.iz[self.pairs] - 1  # (P, 2)
        onsite = np.real(hb.ee[:, 0, :9, :9] - hb.ee[:, 0, 9:, 9:])
        d1 = self._tensor(onsite[types[:, 0]])[:, None]  # (P, 1, 9, 9)
        d2 = self._tensor(onsite[types[:, 1]])[:, None]
        quad = self._tensor(w / x**2, torch.float64)[None, :, None, None]

        def dgdg(da, ga, db, gb):
            return (da @ ga) @ (db @ gb)

        def quad_trace(m):  # (P, 64, 9, 9) -> (P,)
            return torch.diagonal(quad * m, dim1=-2, dim2=-1).sum(-1).sum(-1)

        jmat = dgdg(d1, gi["n"], d2, gj["n"])
        for k in "xyz":
            jmat = jmat - dgdg(d1, gi[k], d2, gj[k])
        jij = (-quad_trace(jmat).real * MRY).cpu().numpy()
        dmi = torch.stack([quad_trace(dgdg(d1, gi["n"], d2, gj[k])
                                      - dgdg(d2, gj["n"], d1, gi[k])).imag
                           for k in "xyz"], 1) * MRY
        aij = torch.stack([torch.stack([-quad_trace(
            0.5 * (dgdg(d1, gi[k], d2, gj[l])
                   + dgdg(d2, gj[k], d1, gi[l]))).real
            for l in "xyz"], 1) for k in "xyz"], 1) * MRY
        dmi, aij = dmi.cpu().numpy(), aij.cpu().numpy()

        rows_j, rows_d, rows_a = [], [], []
        for p, (i, j) in enumerate(self.pairs):
            it, jt = types[p]
            rij = cl.cr[j] - cl.cr[i]
            dist = float(np.linalg.norm(rij))
            head = (f"{it + 1:8d}{jt + 1:8d}  "
                    + "".join(f"{v:12.6f}" for v in rij) + "  ")
            rows_j.append(head + f"{jij[p]:12.6f} {dist:12.6f}\n")
            rows_d.append(head + "".join(f"{v:12.6f}" for v in dmi[p])
                          + f" {dist:12.6f}\n")
            rows_a.append(head + "".join(f"{v:12.6f}"
                                         for v in aij[p].T.ravel())
                          + f" {dist:12.6f}\n")
            g_logger.info(f"GL Jij pair ({i+1},{j+1}): {jij[p]:.6f} mRy")
        for name, rows in (("jij", rows_j), ("dij", rows_d),
                           ("aij", rows_a)):
            with open(os.path.join(self.workdir, name + ".out"),
                      "w") as fh:
                fh.writelines(rows)
        return rows_j

    # ------------------------------------------------------------------
    def calculate_exchange_twoindex(self):
        """Density/current-decomposed exchange (``exchange.f90
        calculate_exchange_twoindex`` :84-337 and ``green.f90
        calculate_intersite_gf_twoindex`` :386-423).

        Each spin channel of the intersite GF is split into a density
        (0) and a current (1) part via the m -> -m reflection
        G^{c,0/1}_ij = (G^c_ij +/- refl(G^c_ji))/2 with
        refl(G)[k, j] = (-1)^{k+j} G[2j0-j, 2k0-k]; second-order (so) and
        first-order (fo) Jij/Dij/Aij combinations are integrated to E_F
        and written to jijso/jijfo/jijparts/dijso/dijfo/dijparts/
        aijso/aijfo/aijparts (+ the reference's empty jtens files and
        its unit-150 cumulative Jij curve, fort.150).  Requires run().
        """
        with g_timer.section("jij-twoindex"):
            self._twoindex()

    def _twoindex(self):
        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ne = emesh.npts

        # m -> -m reflection table (1-based 2*k0-k) and sign matrix
        q = np.arange(1, 10)
        l1 = np.sqrt(q - 0.9).astype(int)
        k0 = l1 * (l1 + 1) + 1
        refl = torch.as_tensor(2 * k0 - q - 1, device=self.device)
        sign = self._tensor((-1.0) ** np.add.outer(np.arange(9),
                                                   np.arange(9)),
                            torch.float64)

        def reflect(g):
            # g: (P, NE, 9, 9); (-1)^{k+j} g[R(j), R(k)]
            return sign * g[..., refl, :][..., refl].transpose(-1, -2)

        def integrate(y):
            return _fermi_integral(y, emesh) * 1.0e3 / 4.0 / np.pi

        d = self._d_diagonals(emesh.ene)
        ch = {}
        for c in "nxyz":
            gi = _per_energy(self.comps_i[c])
            gj = _per_energy(self.comps_j[c])
            rgj, rgi = reflect(gj), reflect(gi)
            ch[c + "0ij"] = d[:, 0, :, :, None] * (0.5 * (gi + rgj))
            ch[c + "1ij"] = d[:, 0, :, :, None] * (0.5 * (gi - rgj))
            ch[c + "0ji"] = d[:, 1, :, :, None] * (0.5 * (gj + rgi))
            ch[c + "1ji"] = d[:, 1, :, :, None] * (0.5 * (gj - rgi))

        def tr(a, b):  # tr[d_i G_ij d_j G_ji] of the channels a, b
            return _trace(ch[a], ch[b])

        jcd = tr("n0ij", "n0ji").imag
        jcc = tr("n1ij", "n1ji").imag
        jsd = sum(tr(c + "0ij", c + "0ji").imag for c in "xyz")
        jsc = sum(tr(c + "1ij", c + "1ji").imag for c in "xyz")
        dsc = torch.stack([tr("n0ij", c + "1ji").real for c in "xyz"], 1)
        dcc = torch.stack([tr("n1ij", c + "0ji").real for c in "xyz"], 1)
        isd = torch.stack([torch.stack([tr(a + "0ij", b + "0ji").imag
                                        for b in "xyz"], 1)
                           for a in "xyz"], 1)  # (P, 3, 3, NE)
        isc = torch.stack([torch.stack([tr(a + "1ij", b + "1ji").imag
                                        for b in "xyz"], 1)
                           for a in "xyz"], 1)
        jcd, jcc, jsd, jsc, dsc, dcc, isd, isc = (
            x.cpu().numpy() for x in (jcd, jcc, jsd, jsc, dsc, dcc, isd,
                                      isc))
        jso = jcd - jsd + jcc - jsc
        jfo = jcd + jsd - jcc - jsc
        dso = 2.0 * (dsc + dcc)
        dfo = 2.0 * (dsc - dcc)

        names = ("jijso", "jijfo", "jijparts", "dijso", "dijfo", "dijparts",
                 "aijso", "aijfo", "aijparts", "jtensso", "jtensfo")
        files = {}
        try:
            for name in names:
                files[name] = open(os.path.join(self.workdir,
                                                name + ".out"), "w")
            files["fort.150"] = open(os.path.join(self.workdir, "fort.150"),
                                     "w")
            for p, (i, j) in enumerate(self.pairs):
                it = int(cl.iz[i]) - 1
                jt = int(cl.iz[j]) - 1
                rij = cl.cr[j] - cl.cr[i]
                dist = float(np.linalg.norm(rij))
                head = (f"{it + 1:8d}{jt + 1:8d}  "
                        + "".join(f"{x:20.11e}" for x in rij) + "  ")

                def row(f, vals):
                    files[f].write(head + "".join(
                        f"{v:16.6e}" for v in np.atleast_1d(vals)
                    ) + f" {dist:12.6f}\n")

                row("jijso", integrate(jso[p]))
                row("jijfo", integrate(jfo[p]))
                row("jijparts", [integrate(jcd[p]), integrate(jsd[p]),
                                 integrate(jcc[p]), integrate(jsc[p])])
                row("dijso", integrate(dso[p]))
                row("dijfo", integrate(dfo[p]))
                row("dijparts", np.concatenate([2.0 * integrate(dcc[p]),
                                                2.0 * integrate(dsc[p])]))
                row("aijso", integrate(isd[p] + isc[p]).T.ravel())
                row("aijfo", integrate(-isd[p] + isc[p]).T.ravel())
                row("aijparts", np.concatenate([integrate(isd[p]).T.ravel(),
                                                integrate(isc[p]).T.ravel()]))
                cum = simpson_f_cumulative(jso[p], emesh.ene, emesh.nv1) \
                    * 1.0e3 / 4.0 / np.pi
                for nv in range(ne):
                    files["fort.150"].write(
                        f" {emesh.ene[nv] - emesh.fermi:18.10e}"
                        f" {cum[nv]:18.10e}\n")
        finally:
            for fh in files.values():
                fh.close()

    # ------------------------------------------------------------------
    def _anti_hermitian(self):
        """(P, NE, 18, 18) per-energy Gij, Gji and A_ij = Gij - Gji^H,
        A_ji = Gji - Gij^H."""
        gij = _per_energy(torch.as_tensor(self.gij_full, device=self.device))
        gji = _per_energy(torch.as_tensor(self.gji_full, device=self.device))
        return (gij, gji, gij - gji.conj().transpose(-1, -2),
                gji - gij.conj().transpose(-1, -2))

    def calculate_gilbert_damping(self):
        """Torque-correlation Gilbert damping per ij pair
        (``exchange.f90 calculate_gilbert_damping`` :613-744).

        alpha^{kl}_ij = -0.5/(pi m_i) Re tr[T^k_i A_ij T^l_j^dag A_ji]
        with A_ij = g_ij - g_ji^dag the anti-Hermitian intersite GF and
        T^k the collinear SOC torque operators.  Writes
        ``damping-energy.out`` (accumulated over pairs vs energy, scaled by
        the last pair's factor as the reference) and ``alldampings.out``
        (per-pair tensor at E_F).  Requires run().
        """
        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ne = emesh.npts
        tmat = self._tensor(torque_operator_collinear(self.sys.atoms))
        ief = int(np.argmin(np.abs(emesh.ene - emesh.fermi)))
        _, _, aij, aji = self._anti_hermitian()
        types = self._tensor(cl.iz[self.pairs] - 1, torch.long)  # (P, 2)
        ti = tmat[types[:, 0]]  # (P, 3, 18, 18)
        tj = tmat[types[:, 1]].conj().transpose(-1, -2)
        # dt[p, 3 k + l, e] = Re tr[T^k_i A_ij T^l_j^dag A_ji]
        dt = torch.stack([
            _trace(ti[:, k, None] @ aij, tj[:, l, None] @ aji).real
            for k in range(3) for l in range(3)], 1).cpu().numpy()
        total = dt.sum(0)
        rows = []
        factor = 1.0
        for p, (i, j) in enumerate(self.pairs):
            pot_i = self.sys.atoms[int(cl.iz[i]) - 1].potential
            spin_i = float((pot_i.ql[0, :, 0] - pot_i.ql[0, :, 1]).sum())
            factor = -0.25 * 2.0 / (np.pi * spin_i)
            rij = cl.cr[i] - cl.cr[j]
            dist = float(np.linalg.norm(rij))
            rows.append(
                f"{i + 1:7d}{j + 1:7d}"
                + "".join(f"{factor * v:14.9f}" for v in dt[p, :, ief])
                + f"{0.5 * factor * (dt[p, 0, ief] + dt[p, 4, ief]):14.9f}"
                + f"{dist:10.6f}"
                + "".join(f"{v:10.6f}" for v in rij) + "\n"
            )
        with open(os.path.join(self.workdir, "alldampings.out"), "w") as fh:
            fh.write("    #i     #j   #xx #xy #xz #yx #yy #yz #zx #zy #zz"
                     " #0.5*(xx+yy) #Dist #rij\n")
            fh.writelines(rows)
        with open(os.path.join(self.workdir, "damping-energy.out"),
                  "w") as fh:
            fh.write("#Energy (E-Ef) #xx #xy #xz #yx #yy #yz #zx #zy #zz\n")
            for nv in range(ne):
                fh.write(f"{emesh.ene[nv] - emesh.fermi:14.9f}" + "".join(
                    f"{factor * total[m, nv]:14.9f}" for m in range(9)
                ) + "\n")
        return factor * total[:, ief]

    # ------------------------------------------------------------------
    def calculate_moment_of_inertia(self):
        """Torque-correlation moment of inertia (``exchange.f90``
        :755-912, Sci. Rep. 7, 931 (2017)).

        I^{kl}_ij ~ Re tr[T^k A_ij T^l^dag B''_ji + T^k B''_ij T^l^dag
        A_ji] with B the Hermitian GF part and B'' its second energy
        derivative.  Deviation: the reference evaluates the tensor with
        an out-of-range energy index after its loop (:873-886, Fortran
        UB) and never writes it; here the tensor is evaluated at E_F.
        Writes ``example-real.out``/``example-imag.out`` (B(1,1) traces)
        as the reference does.  Returns the (9,) tensor at E_F summed
        over pairs.
        """
        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        h = emesh.ene[1] - emesh.ene[0]
        tmat = self._tensor(torque_operator_collinear(self.sys.atoms))
        ief = int(np.argmin(np.abs(emesh.ene - emesh.fermi)))
        gij, gji, aij, aji = self._anti_hermitian()
        bij = gij + gji.conj().transpose(-1, -2)
        bji = gji + gij.conj().transpose(-1, -2)

        def d2(b):
            out = torch.zeros_like(b)
            out[:, 1:-1] = (b[:, 2:] - 2.0 * b[:, 1:-1] + b[:, :-2]) / h**2
            return out

        sbij, sbji = d2(bij), d2(bji)
        b00 = torch.stack([bij[:, :, 0, 0], sbij[:, :, 0, 0]]).cpu().numpy()
        types = self._tensor(cl.iz[self.pairs] - 1, torch.long)
        ti = tmat[types[:, 0]]  # (P, 3, 18, 18)
        tj = tmat[types[:, 1]].conj().transpose(-1, -2)
        a_ij, a_ji = aij[:, ief], aji[:, ief]  # (P, 18, 18) at E_F
        s_ij, s_ji = sbij[:, ief], sbji[:, ief]
        total = torch.stack([
            torch.diagonal((ti[:, k] @ a_ij) @ (tj[:, l] @ s_ji)
                           + (ti[:, k] @ s_ij) @ (tj[:, l] @ a_ji),
                           dim1=-2, dim2=-1).sum(-1).real
            for k in range(3) for l in range(3)], 1).sum(0).cpu().numpy()
        path = os.path.join(self.workdir, "example-{}.out")
        with open(path.format("real"), "w") as fre, \
                open(path.format("imag"), "w") as fim:
            for p in range(len(self.pairs)):
                for nv, e in enumerate(emesh.ene):
                    fre.write(f"{e:18.10e}{b00[0, p, nv].real:18.10e}"
                              f"{b00[1, p, nv].real:18.10e}\n")
                    fim.write(f"{e:18.10e}{b00[0, p, nv].imag:18.10e}"
                              f"{b00[1, p, nv].imag:18.10e}\n")
        return total


def _dele18(pot) -> np.ndarray:
    """``pot.dele`` per (l, m, s) orbital: (18,), 9 up then 9 down."""
    return np.concatenate([np.repeat(pot.dele[:, s], [1, 3, 5])
                           for s in (0, 1)])


def _real_sph(l, m, theta, phi):
    """Real spherical harmonics, standard convention (math.f90
    ``real_spharm`` :516-615): S_{l,m>0} = sqrt2 (-1)^m Re Y_l^m,
    S_{l,0} = Y_l^0, S_{l,m<0} = sqrt2 (-1)^m Im Y_l^|m|."""
    try:
        from scipy.special import sph_harm_y
        y = sph_harm_y(l, abs(m), theta, phi)
    except ImportError:  # older scipy
        from scipy.special import sph_harm
        y = sph_harm(abs(m), l, phi, theta)
    if m > 0:
        return np.sqrt(2.0) * (-1.0) ** m * y.real
    if m < 0:
        return np.sqrt(2.0) * (-1.0) ** m * y.imag
    return y.real


@functools.cache
def real_gaunt(l1, l2, l3, m1, m2, m3):
    """Real Gaunt coefficient int S_{l1 m1} S_{l2 m2} S_{l3 m3} dOmega
    by exact spherical quadrature (replaces the reference's
    ``realgaunt`` case analysis, math.f90 :330-484; both use the same
    standard real-harmonic convention so the coefficients agree)."""
    xs, ws = np.polynomial.legendre.leggauss(24)
    theta = np.arccos(xs)[:, None]
    nphi = 64
    phi = (2.0 * np.pi * np.arange(nphi) / nphi)[None, :]
    f = (_real_sph(l1, m1, theta, phi) * _real_sph(l2, m2, theta, phi)
         * _real_sph(l3, m3, theta, phi))
    return float(np.sum(ws[:, None] * f) * 2.0 * np.pi / nphi)


def _orb_order(l_max):
    """(l, m)-slot -> cubic orbital index table (``disp_matrix``
    :order block: p ordered (3,4,2), d ordered (5,6,9,7,8))."""
    order = np.zeros((l_max + 1, 2 * l_max + 1), dtype=int)
    for l in range(l_max + 1):
        if l == 0:
            order[0, 0] = 1
        elif l == 1:
            order[1, :3] = [3, 4, 2]
        elif l == 2:
            order[2, :5] = [5, 6, 9, 7, 8]
        else:
            for j in range(-l, l + 1):
                order[l, l + j] = l * l + l + j + 1
    return order


def disp_matrix(lmax, ws_radius, disp_vec):
    """Displacement (Laplace-expansion) matrix of the structure-constant
    gradient (``symbolic_atom.f90 disp_matrix``).  Returns (2K, 2K)
    with K = (lmax+1)^2, spin-block-diagonal."""
    from scipy.special import factorial2

    k = (lmax + 1) ** 2
    nrm = np.linalg.norm(disp_vec)
    u = np.zeros(3) if nrm == 0 else np.asarray(disp_vec, float) / nrm
    # direction angles for real_spharm(unit_disp, 1, m)
    theta = np.arccos(np.clip(u[2], -1, 1)) if nrm else 0.0
    phi = np.arctan2(u[1], u[0]) if nrm else 0.0
    order = _orb_order(lmax)
    mat_b = np.zeros((k, k), dtype=np.complex128)
    for li in range(lmax + 1):  # l'
        for lj in range(lmax + 1):  # l
            if li > lj:
                continue
            fac = (factorial2(max(2 * lj - 1, 0))
                   / factorial2(max(2 * li - 1, 0)))
            for mi in range(-li, li + 1):
                for mj in range(-lj, lj + 1):
                    acc = 0.0
                    for mm in (-1, 0, 1):
                        acc += (real_gaunt(lj, li, 1, mj, mi, mm)
                                * float(_real_sph(1, mm, theta, phi)))
                    mat_b[order[li, mi + li] - 1,
                          order[lj, mj + lj] - 1] += fac * acc
    mat_b *= -4.0 * np.pi / (3.0 * ws_radius)
    out = np.zeros((2 * k, 2 * k), dtype=np.complex128)
    out[:k, :k] = mat_b
    out[k:, k:] = mat_b
    return out


def p_matrix(pot, lmax, ene):
    """Diagonal LMTO potential function P(E) = (E - C - vmad)/Delta^2
    per (l, m, s) (``symbolic_atom.f90 p_matrix``).  (NE, 2K) diag."""
    k = (lmax + 1) ** 2
    ne = len(ene)
    p = np.zeros((ne, 2 * k), dtype=np.complex128)
    for s in range(2):
        for l in range(lmax + 1):
            c = pot.c[l, s] + pot.vmad
            d2 = pot.dele[l, s] ** 2
            for m in range(2 * l + 1):
                mls = l * l + m + k * s
                p[:, mls] = (ene - c) / d2
    return p


def transform_pmatrix(p, scr_in, scr_out, lmax):
    """P^beta = P^alpha / (1 + (alpha - beta) P^alpha) per diagonal
    entry (``transform_pmatrix``); scr arrays (lmax+1, 2)."""
    k = (lmax + 1) ** 2
    out = np.zeros_like(p)
    for s in range(2):
        for l in range(lmax + 1):
            d = scr_in[l, s] - scr_out[l, s]
            for m in range(2 * l + 1):
                mls = l * l + m + k * s
                out[:, mls] = p[:, mls] / (1.0 + d * p[:, mls])
    return out


def torque_operator_collinear(atoms) -> np.ndarray:
    """Collinear SOC torque operators T^x/T^y/T^z per type
    (``hamiltonian.f90 torque_operator_collinear`` :1429-1475).

    Returns (ntype, 3, 18, 18).  The prefactor is 0.5 sqrt(xi_p1 xi_p2)
    on the p block and 0.5 sqrt(xi_d1 xi_d2) on the d block; mixed-l
    blocks are irrelevant because L is block-diagonal in l (the
    reference's stale-prefactor carry-over multiplies exact zeros).
    """
    from ..physics.harmonics import L_X, L_Y, L_Z, cart2sph

    lx = cart2sph(L_X)
    ly = cart2sph(L_Y)
    lz = cart2sph(L_Z)
    ntype = len(atoms)
    tmat = np.zeros((ntype, 3, 18, 18), np.complex128)
    for t, at in enumerate(atoms):
        pot = at.potential
        soc_p = 0.5 * np.sqrt(pot.xi_p[0] * pot.xi_p[1])
        soc_d = 0.5 * np.sqrt(pot.xi_d[0] * pot.xi_d[1])
        pref = np.zeros((9, 9))
        pref[1:4, 1:4] = soc_p
        pref[4:9, 4:9] = soc_d
        plx = pref * lx
        ply = pref * ly
        plz = pref * lz
        # T^x
        tmat[t, 0, :9, :9] = 2j * ply
        tmat[t, 0, :9, 9:] = -2.0 * plz
        tmat[t, 0, 9:, :9] = 2.0 * plz
        tmat[t, 0, 9:, 9:] = -2j * ply
        # T^y
        tmat[t, 1, :9, :9] = -2j * plx
        tmat[t, 1, :9, 9:] = 2j * plz
        tmat[t, 1, 9:, :9] = 2j * plz
        tmat[t, 1, 9:, 9:] = 2j * plx
        # T^z
        tmat[t, 2, :9, 9:] = 2.0 * (plx - 1j * ply)
        tmat[t, 2, 9:, :9] = -2.0 * (plx + 1j * ply)
    return tmat
