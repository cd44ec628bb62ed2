"""Kubo-Bastin conductivity from two-sided Chebyshev moments.

Port of ``rslmtoasa_tpu/models/conductivity.py`` (reference
``post_processing='conductivity'``):

* the Kubo operator tables on the host, bit for bit the JAX package's:
  real-space velocities v = -i (d.r_ij) H_ij per neighbour slot
  (``hamiltonian.f90 build_realspace_velocity_operators`` :1308-1368), their
  spin and orbital currents, accumulations and torques
  (``recursion.f90 set_kubo_operator_slot`` :242-585);
* the moments mu_nm = <r| T_m(H~) v_a T_n(H~) v_b |r> of every start unit
  (one per type, or ``random_vec_num`` random-phase vectors) side by side
  as start blocks of the block recursion's layout ``(kk+1, 18, 18 R)``,
  through ``parallel/dispatch.py kubo_moments_auto`` into
  ``BlockOperator``, the velocity operators and K4 (``ops/kubo.py``);
* Gamma_nm(E) with the Lorentz kernel (lambda = 6) and the (1 - w^2)^-2
  factor (``conductivity.f90 calculate_gamma_nm`` :158-224), contracted
  with the moments as batched matmuls on the moments' device;
* sigma(E): the cumulative Fermi-weighted Simpson integrals on the host,
  written as ``cond_total.out``, ``cond_total_orb_{real,im}.out`` and per
  type ``<El>_cond.out``, ``<El>_cond_orb_{real,im}.out``
  (``calculate_conductivity_tensor`` :226-376).

The JAX package's TPU routes (realified blocks, its conv engine, the
mesh-sharded vmap) do not come over.  An impurity cluster raises: the JAX
package's moments recur on ``ee``/``iz``, which drops the local zone's
rows (ROADMAP queue 3).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.block_lanczos import block_start_vectors
from ..ops.chebyshev import lorentz_kernel
from ..parallel.dispatch import kubo_moments_auto
from ..physics.energy_mesh import EnergyMesh
from ..physics.harmonics import L_X, L_Y, L_Z, cart2sph
from ..physics.quadrature import simpson_f_cumulative
from ..utils.device import synchronize
from ..utils.logger import g_logger
from ..utils.timer import g_timer
from .bulk import BulkSystem

IMPURITY_CONDUCTIVITY = ("ROADMAP queue 3, 'conductivity on an impurity "
                         "cluster drops the local zone's rows'")
RANDOM_SEED = 20260821  # the JAX package's seed of the random phases

#: spin operators in the 18x18 spinor basis (math.f90 S_x/S_y/S_z :200-280)
S_Z = np.zeros((18, 18), dtype=np.complex128)
S_Z[:9, :9] = np.eye(9) * 0.5
S_Z[9:, 9:] = -np.eye(9) * 0.5
S_X = np.zeros((18, 18), dtype=np.complex128)
S_X[:9, 9:] = np.eye(9) * 0.5
S_X[9:, :9] = np.eye(9) * 0.5
S_Y = np.zeros((18, 18), dtype=np.complex128)
S_Y[:9, 9:] = -0.5j * np.eye(9)
S_Y[9:, :9] = 0.5j * np.eye(9)


def build_velocity_operators(sys: BulkSystem, v_alpha, v_beta,
                             velocity_scale=None):
    """Velocity-operator ELL blocks (v_a, v_b) per type/slot, plus the
    HoH overlap tables vo = v @ obarm[type(j)] per neighbor slot
    (``build_realspace_velocity_operators`` :1355-1360) when the
    Hamiltonian carries HoH data (zeros otherwise)."""
    cl = sys.cluster
    hb = sys.ham
    ntype = hb.ee.shape[0]
    v_a = np.zeros_like(hb.ee)
    v_b = np.zeros_like(hb.ee)
    vo_a = np.zeros_like(hb.ee)
    vo_b = np.zeros_like(hb.ee)
    dir_a = np.asarray(v_alpha, float)
    dir_a /= np.linalg.norm(dir_a)
    dir_b = np.asarray(v_beta, float)
    dir_b /= np.linalg.norm(dir_b)
    if velocity_scale is None:
        velocity_scale = np.ones(ntype)
    hoh = hb.obarm is not None
    for t in range(ntype):
        ia = int(cl.atlist[t]) - 1
        nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
        for m in range(1, nd + 1):
            jj = int(cl.nn[ia, m - 1])
            if jj < 0:
                continue
            rij = cl.wrap_diff((cl.cr_ang[ia] - cl.cr_ang[jj]))
            dot_a = float(dir_a @ rij)
            dot_b = float(dir_b @ rij)
            v_a[t, m] = (1.0 / 1j) * dot_a * hb.ee[t, m]
            jt = int(cl.iz[jj]) - 1
            vsc = max(velocity_scale[t], velocity_scale[jt])
            v_b[t, m] = (1.0 / 1j) * dot_b * hb.ee[t, m] * vsc
            if hoh:
                vo_a[t, m] = v_a[t, m] @ hb.obarm[jt]
                vo_b[t, m] = v_b[t, m] @ hb.obarm[jt]
    return v_a, v_b, vo_a, vo_b


def spin_current(v: np.ndarray, pol: str = "z") -> np.ndarray:
    """j^S = 1/2 {S_pol, v} applied per slot block."""
    s_op = {"x": S_X, "y": S_Y, "z": S_Z}[pol]
    return 0.5 * (np.einsum("ab,tmbc->tmac", s_op, v)
                  + np.einsum("tmab,bc->tmac", v, s_op))


def _l_op18(pol: str) -> np.ndarray:
    """L_pol in spherical harmonics, spin-block-diagonal 18x18
    (``select_orbital_operator``)."""
    l9 = cart2sph({"x": L_X, "y": L_Y, "z": L_Z}[pol])
    out = np.zeros((18, 18), np.complex128)
    out[:9, :9] = l9
    out[9:, 9:] = l9
    return out


def orbital_current(v: np.ndarray, pol: str = "z") -> np.ndarray:
    """j^L = 1/2 {L_pol, v} per slot
    (``build_realspace_orbital_velocity_operators`` :568-654)."""
    l_op = _l_op18(pol)
    return 0.5 * (np.einsum("ab,tmbc->tmac", l_op, v)
                  + np.einsum("tmab,bc->tmac", v, l_op))


def _onsite_table(op: np.ndarray, like: np.ndarray) -> np.ndarray:
    out = np.zeros_like(like)
    out[:, 0] = op[None]
    return out


def build_kubo_operator(sys: BulkSystem, op_type: str, pol: str,
                        v_dir, velocity_scale=None):
    """ELL operator tables ``(op, op_o)`` for one Kubo slot
    (``recursion.f90 set_kubo_operator_slot`` :242-585 + the
    hamiltonian builders :490-840).  ``op_o`` is the HoH overlap
    companion used by ``velo_hoh_vec_matmul`` (zeros when HoH is off
    or the operator has no overlap image).

    op_type: charge | spin | orbital | spin_accumulation |
    orbital_accumulation | spin_torque | spin_soc_torque |
    orbital_torque.
    """
    hb = sys.ham
    v, _, vo, _ = build_velocity_operators(sys, v_dir, v_dir,
                                           velocity_scale)
    s_op = {"x": S_X, "y": S_Y, "z": S_Z}.get(pol, S_Z)
    ntype = hb.ee.shape[0]
    lsh = hb.lsham if hb.lsham is not None else np.zeros(
        (ntype, 18, 18), np.complex128)
    zeros = np.zeros_like(hb.ee)
    if op_type == "charge":
        return v, vo
    if op_type == "spin":
        # jso = 1/2 {S, vo} (build_realspace_spin_operators :532-549)
        return spin_current(v, pol), spin_current(vo, pol)
    if op_type == "orbital":
        return orbital_current(v, pol), orbital_current(vo, pol)
    if op_type == "spin_accumulation":
        # bare S_pol on the onsite slot; no overlap image (vo_a zeroed,
        # compute_moments_stochastic :1046-1051)
        return _onsite_table(s_op, hb.ee), zeros
    if op_type == "orbital_accumulation":
        return _onsite_table(_l_op18(pol), hb.ee), zeros
    if op_type in ("spin_soc_torque", "soc_spin_torque"):
        # (1/i)[S_pol, H_soc] on the onsite slot (:658-703); in HoH the
        # reference reuses the same operator as its overlap container
        out = np.zeros_like(hb.ee)
        out[:, 0] = (1.0 / 1j) * (np.einsum("ab,tbc->tac", s_op, lsh)
                                  - np.einsum("tab,bc->tac", lsh, s_op))
        return out, (out.copy() if hb.obarm is not None else zeros)
    if op_type == "spin_torque":
        # (1/i)[S_pol, hxc] per slot, hxc = spin-odd (exchange-field)
        # part of each block: ee - I2 (x) (uu + dd)/2 (:711-763;
        # hxc assembly build_bulkham :1573-1576).  The HoH o-table is
        # disabled in the reference (:745-756 commented out).
        hxc = hb.ee.copy()
        h0 = 0.5 * (hb.ee[:, :, :9, :9] + hb.ee[:, :, 9:, 9:])
        hxc[:, :, :9, :9] -= h0
        hxc[:, :, 9:, 9:] -= h0
        return (1.0 / 1j) * (np.einsum("ab,tmbc->tmac", s_op, hxc)
                             - np.einsum("tmab,bc->tmac", hxc, s_op)), zeros
    if op_type == "orbital_torque":
        # (1/i)[L_pol, H] with lsham added on the onsite slot (:773-825);
        # HoH o-table is the same commutator over eeo (:807-818)
        l_op = _l_op18(pol)
        h = hb.ee.copy()
        h[:, 0] += lsh
        out = (1.0 / 1j) * (np.einsum("ab,tmbc->tmac", l_op, h)
                            - np.einsum("tmab,bc->tmac", h, l_op))
        if hb.obarm is not None and hb.eeo is not None:
            ho = hb.eeo.copy()
            ho[:, 0] += lsh
            out_o = (1.0 / 1j) * (np.einsum("ab,tmbc->tmac", l_op, ho)
                                  - np.einsum("tmab,bc->tmac", ho, l_op))
        else:
            out_o = zeros
        return out, out_o
    raise ValueError(f"unknown Kubo operator type {op_type!r}")


def kubo_start_vectors(cluster, calctype: str, nunits: int,
                       device) -> torch.Tensor:
    """The start blocks of ``nunits`` units side by side, (kk+1, 18, 18 R)
    complex128 on ``device``: for ``per_type`` the unit block at the
    ``atlist`` atom of each of the first ``nunits`` types, else random-phase
    blocks (``compute_moments_stochastic`` :1120-1143: one phase per atom
    on all 18 diagonal orbitals, normalised by sqrt(kk)), drawn unit after
    unit from the JAX package's seeded generator."""
    kk = cluster.kk
    if calctype == "per_type":
        return block_start_vectors(
            kk, [int(j) - 1 for j in cluster.atlist[:nunits]], device)
    rng = np.random.default_rng(RANDOM_SEED)
    ph = np.stack([np.exp(2j * np.pi * rng.random(kk)) / np.sqrt(float(kk))
                   for _ in range(nunits)], axis=1)  # (kk, R)
    psi0 = torch.zeros((kk + 1, 18, nunits, 18), dtype=torch.complex128,
                       device=device)
    idx = torch.arange(18, device=device)
    psi0[:kk, idx, :, idx] = torch.as_tensor(ph, device=device)
    return psi0.view(kk + 1, 18, 18 * nunits)


class ConductivityCalculation:
    def __init__(self, sys: BulkSystem, workdir: str = "."):
        if sys.cfg.control.calctype == "I":
            raise NotImplementedError(
                f"post_processing='conductivity' with calctype='I': "
                f"{IMPURITY_CONDUCTIVITY}")
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir

    @property
    def device(self) -> torch.device:
        return self.sys.device

    # ------------------------------------------------------------------
    def run(self, cond_type: str = "charge", pol_alpha: str = "z"):
        """The moments, Gamma_nm and the output files; returns mu_nm
        (18, 18, n, m, units) on the host, the JAX package's layout."""
        cfg = self.cfg
        sys = self.sys
        emesh = EnergyMesh.build(cfg.energy)
        sys.build_hamiltonian()

        nml = cfg.namelists.get("hamiltonian")
        v_alpha = np.array([0.0, 1.0, 0.0])
        v_beta = np.array([1.0, 0.0, 0.0])
        pol_beta = "z"
        if nml is not None:
            va = np.zeros(3)
            vb = np.zeros(3)
            if nml.has("v_alpha"):
                nml.fill_array("v_alpha", va)
                v_alpha = va
            if nml.has("v_beta"):
                nml.fill_array("v_beta", vb)
                v_beta = vb
            if nml.has("pol_alpha"):
                pol_alpha = str(nml.get_scalar("pol_alpha", pol_alpha))
            if nml.has("pol_beta"):
                pol_beta = str(nml.get_scalar("pol_beta", pol_beta))
        # slot b carries linear_in, slot a linear_out
        # (setup_kubo_operators :242-260); legacy cond_type='spin'
        # shorthand maps to a spin-current output slot
        linear_out = cfg.control.linear_out
        linear_in = cfg.control.linear_in
        if cond_type == "spin" and linear_out == "charge":
            linear_out = "spin"
        v_a, vo_a = build_kubo_operator(sys, linear_out, pol_alpha, v_alpha)
        v_b, vo_b = build_kubo_operator(sys, linear_in, pol_beta, v_beta)

        cond_ll = cfg.control.cond_ll
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0

        with g_timer.section("kubo-moments"):
            mu_nm = self.compute_moments(v_a, v_b, a, b, cond_ll,
                                         vo_a=vo_a, vo_b=vo_b)
            synchronize(self.device)

        with g_timer.section("gamma-and-integrals"):
            self.conductivity_tensor(mu_nm, emesh, a, b, cond_ll)
        return mu_nm.cpu().numpy()

    # ------------------------------------------------------------------
    def compute_moments(self, v_a, v_b, a, b, cond_ll, *,
                        vo_a=None, vo_b=None) -> torch.Tensor:
        """mu_nm (18, 18, n, m, units) on the system's device (a view of
        the moments laid out per unit): every start unit of
        ``cond_calctype`` (``per_type``: one per type; ``random_vec``:
        ``random_vec_num``) side by side.  When the Hamiltonian carries
        HoH data the chains switch to the HoH-corrected H and v - vo.(h .)
        (ham_hoh_vec_matmul / velo_hoh_vec_matmul,
        recursion.f90:656-912)."""
        sys = self.sys
        hb = sys.ham
        ntype = hb.ee.shape[0]
        lsh = hb.lsham if hb.lsham is not None else np.zeros(
            (ntype, 18, 18), np.complex128)
        hoh = bool(self.cfg.hamiltonian.hoh) and hb.eeo is not None
        enim = hb.enim if hb.enim is not None else np.zeros_like(lsh)
        calctype = self.cfg.control.cond_calctype
        nunits = ntype if calctype == "per_type" else int(
            self.cfg.control.random_vec_num)
        psi0 = kubo_start_vectors(sys.cluster, calctype, nunits,
                                  self.device)
        mu = kubo_moments_auto(
            hb.ee, lsh, hb.iz, hb.cols, v_a, v_b, psi0, cond_ll, float(a),
            float(b), hoh=hoh, hso=hb.eeo if hoh else None,
            enim=enim if hoh else None, vo_a=vo_a, vo_b=vo_b,
            plain=sys.plain)
        g_logger.info(f"Kubo moments done for {mu.shape[0]} {calctype} "
                      f"units")
        return mu.permute(3, 4, 1, 2, 0)

    # ------------------------------------------------------------------
    def conductivity_tensor(self, mu_nm, emesh, a, b, cond_ll):
        """Gamma_nm assembly on the moments' device + the cumulative
        conductivity integrals on the host; returns the integrand
        (18, NE, units) on the host.

        integrand(E) per orbital l: sum_nm Gamma_nm(E) mu_nm[l, l, n, m],
        Gamma_nm(E) = (cn_n T_m + cm_m T_n) / (1 - w^2)^2 k_n k_m w_n w_m:
        tn contracted over m (and over n for the second term) as one
        batched matmul each, then weighted by cn / cm and summed."""
        cfg = self.cfg
        mu = torch.as_tensor(mu_nm)
        dev = mu.device
        ene = emesh.ene
        w = (ene - b) / a
        acx = np.arccos(w)
        sq = np.sqrt(1.0 - w**2)
        kern = lorentz_kernel(cond_ll, 6.0)
        weights = np.ones(cond_ll)
        weights[0] = 0.5
        n_idx = np.arange(cond_ll)
        cn = (w[:, None] - 1j * n_idx[None, :] * sq[:, None]) \
            * np.exp(1j * n_idx[None, :] * acx[:, None])
        cm = (w[:, None] + 1j * n_idx[None, :] * sq[:, None]) \
            * np.exp(-1j * n_idx[None, :] * acx[:, None])
        tn = np.cos(n_idx[None, :] * acx[:, None])  # T_n(w)
        de = emesh.energy_max - emesh.energy_min
        factor = 16.0 / (np.pi * de**2)
        kw = kern * weights
        pref = 1.0 / (1.0 - w**2) ** 2

        def dev_t(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   dtype=torch.complex128, device=dev)

        units = mu.shape[4]
        # diag mu[l, l, n, m, t] weighted by kw_n kw_m, as (t l, n, m)
        diag = torch.diagonal(mu, dim1=0, dim2=1).permute(2, 3, 0, 1)
        kwt = dev_t(kw)
        m1 = (kwt[:, None] * kwt[None, :]) * diag
        m1 = m1.reshape(units * 18, cond_ll, cond_ll)
        tn_t = dev_t(tn.T)  # (N, NE)
        # sum_nm cn_n T_m m1[n, m] and sum_nm cm_m T_n m1[n, m]
        term1 = (torch.matmul(m1, tn_t) * dev_t(cn.T)).sum(1)
        term2 = (torch.matmul(m1.transpose(1, 2), tn_t)
                 * dev_t(cm.T)).sum(1)
        integrand = (term1 + term2) * dev_t(pref) * factor
        integrand_at = integrand.view(units, 18, -1).permute(
            1, 2, 0).cpu().numpy()

        per_type = cfg.control.cond_calctype == "per_type"
        self._write_outputs(integrand_at, emesh, w, per_type=per_type)
        return integrand_at

    # ------------------------------------------------------------------
    def _write_outputs(self, integrand_at, emesh, w, per_type=True):
        """Totals are averaged over the loop units (types or random
        vectors, conductivity.f90:322-328); the per-type files exist
        only for cond_calctype='per_type' (:331-371)."""
        ntype = integrand_at.shape[2]
        tot = integrand_at.sum(axis=2)  # (18, NE)
        tot_r = tot.real.sum(axis=0)
        tot_i = tot.imag.sum(axis=0)
        npts = emesh.npts
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0

        def cumulative(y):
            # cumulative Fermi-cut Simpson over the scaled variable w
            return simpson_f_cumulative(y, w, emesh.nv1)

        def write(name, cols):
            with open(os.path.join(self.workdir, name), "w") as fh:
                for i in range(npts):
                    fh.write(f"{a * w[i] + b - emesh.fermi:16.6e}" + "".join(
                        f"{c[i]:16.6e}" for c in cols) + "\n")

        # orbital-resolved cumulative curves (calculate_conductivity_tensor
        # :300-376: cond_total_orb_real/im.out, 18 orbital columns)
        write("cond_total_orb_real.out",
              [cumulative(tot[l].real) / ntype for l in range(18)])
        write("cond_total_orb_im.out",
              [cumulative(tot[l].imag) / ntype for l in range(18)])
        for t in range(ntype if per_type else 0):
            sym = self.sys.atoms[t].element.symbol
            write(sym + "_cond_orb_real.out",
                  [cumulative(integrand_at[l, :, t].real) for l in range(18)])
            write(sym + "_cond_orb_im.out",
                  [cumulative(integrand_at[l, :, t].imag) for l in range(18)])
        write("cond_total.out",
              [cumulative(tot_r) / ntype, cumulative(tot_i) / ntype])
        for t in range(ntype if per_type else 0):
            sym = self.sys.atoms[t].element.symbol
            write(f"{sym}_cond.out",
                  [cumulative(integrand_at[:, :, t].real.sum(axis=0)),
                   cumulative(integrand_at[:, :, t].imag.sum(axis=0))])
