"""The exchange table of a bcc bulk cluster (Jij, DMI, the anisotropic
tensor and the two-index split) from the seed's potential, in plain code.

The steps of the reference code's ``post_processing_exchange``
(``calculation.f90`` :816-951) as the program's ``ExchangeCalculation.run``
and ``calculate_exchange_twoindex`` take them: ``build_pot``, the
Hamiltonian's blocks, ``predls``; the pair chains (the block of atom i for
i == j, else (i+j), (i-j), (i+ij), (i-ij) over sqrt 2) by block Lanczos on
the grid of :mod:`lattice`; ``zsqr``, the terminators and ``bgreen``; the
intersite Green functions Gij, Gji and their n/x/y/z parts (``green.f90``
:425-470); the LKAG traces, integrated to the Fermi level (``exchange.f90``
:1437-1560), and the density/current split (:84-337).  The formulas are
copies of the program's (``models/exchange.py``), written for arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lattice
from .frozen.physics.energy_mesh import EnergyMesh
from .frozen.physics.greens import bgreen, get_terminf, zsqr
from .frozen.physics.quadrature import simpson_f_fermi
from .scf import ANG2AU, EnergyCfg, hamiltonian_blocks, make_atom, recursion

MRY = 1.0e3 / 4.0 / np.pi
_C = 1.0 / np.sqrt(2.0)
SIGNS = ((_C, _C), (_C, -_C), (_C, 1j * _C), (_C, -1j * _C))
_HP = 0.5 * np.pi
ANGLES = np.array([
    [_HP, _HP, 0, 0], [_HP, _HP, 0, _HP], [_HP, 0, 0, 0],
    [_HP, _HP, _HP, 0], [_HP, _HP, _HP, _HP], [_HP, 0, _HP, 0],
    [0, _HP, 0, 0], [0, _HP, 0, _HP], [0, 0, 0, 0],
])
TWOINDEX = ("jijso", "jijfo", "jijparts", "dijso", "dijfo", "dijparts",
            "aijso", "aijfo", "aijparts")


def pair_chains(pairs):
    """The chains of ``pairs`` ((m_i, m_j) site pairs): one for i == j,
    four otherwise; and for each pair the indices of its four chains (the
    one chain four times for i == j)."""
    chains, idx = [], []
    for mi, mj in pairs:
        if tuple(mi) == tuple(mj):
            idx.append([len(chains)] * 4)
            chains.append([(mi, 1.0)])
            continue
        idx.append(list(range(len(chains), len(chains) + 4)))
        for a, b in SIGNS:
            chains.append([(mi, a), (mj, b)])
    return chains, np.array(idx)


def _fermi_integral(y, emesh):
    return np.apply_along_axis(simpson_f_fermi, -1, y, emesh.ene,
                               emesh.fermi, emesh.nv1)


def _trace(a, b):
    return torch.einsum("...ab,...ba->...", a, b)


def _components(g):
    uu, dd = g[..., :9, :9], g[..., 9:, 9:]
    ud, du = g[..., :9, 9:], g[..., 9:, :9]
    return {"n": 0.5 * (uu + dd), "z": 0.5 * (uu - dd),
            "y": 0.5 * (1j * ud - 1j * du), "x": 0.5 * (ud + du)}


def exchange_table(box: lattice.BccBox, run: dict, state: dict, pairs,
                   device, cdtype=torch.complex128) -> dict:
    """Every stage of one exchange job for ``pairs`` (site pairs in
    primitive coordinates) from ``state``; ``run`` as in
    :func:`.scf.scf_iteration`."""
    atom = make_atom(state)
    pot = atom.potential
    pot.build_pot()
    blocks, lsham = hamiltonian_blocks(box, pot, run["wav"], run["r2"],
                                       run["nsp"] in (2, 4))
    pot.predls(run["wav"] * ANG2AU)
    emesh = EnergyMesh.build(EnergyCfg(**run["energy"]))
    chains, idx = pair_chains(pairs)
    a_b, b2_b = recursion(box, blocks, lsham, chains, run["lld"], "block",
                          None, device, cdtype)
    b_b = zsqr(b2_b)
    a_inf, b_inf = get_terminf(a_b, b_b)
    g = bgreen(a_b, b_b, a_inf, b_inf, emesh.ene, device,
               run.get("sym_term", False), cdtype).to(torch.complex128)
    g4 = g.permute(0, 3, 1, 2)[torch.as_tensor(idx, device=g.device)]
    diff = (1.0 / 1j) * (g4[:, 2] - g4[:, 3])
    onsite = torch.as_tensor([tuple(a) == tuple(b) for a, b in pairs],
                             device=g.device)[:, None, None, None]
    gij = torch.where(onsite, g4[:, 0], 0.5 * (g4[:, 0] - g4[:, 1] + diff))
    gji = torch.where(onsite, g4[:, 0], 0.5 * (g4[:, 0] - g4[:, 1] - diff))
    dtab = np.stack([np.diag(pot.d_matrix(e)).real for e in emesh.ene])
    d = torch.as_tensor(dtab, device=g.device)[None, :, :, None]
    ci, cj = _components(gij), _components(gji)
    gi = {k: d * v for k, v in ci.items()}
    gj = {k: d * v for k, v in cj.items()}
    jtot = _trace(gi["n"], gj["n"])
    for k in "xyz":
        jtot = jtot - _trace(gi[k], gj[k])
    dmi = [_trace(gi["n"], gj[k]) - _trace(gj["n"], gi[k]) for k in "xyz"]
    aij = [0.5 * (_trace(gi[k], gj[l]) + _trace(gj[k], gi[l]))
           for k in "xyz" for l in "xyz"]
    y = torch.stack([jtot.imag] + [t.real for t in dmi]
                    + [t.imag for t in aij], 1).cpu().numpy()
    vals = _fermi_integral(y, emesh) * MRY
    return {"blocks": blocks, "lsham": lsham, "coef": (a_b, b2_b),
            "term": (a_inf, b_inf), "gij": gij.cpu().numpy(),
            "jij": vals[:, 0], "dmi": vals[:, 1:4],
            "aij": vals[:, 4:].reshape(-1, 3, 3),
            "twoindex": _twoindex(ci, cj, d, emesh)}


def _twoindex(ci, cj, d, emesh) -> dict:
    """The columns of the two-index files, per pair, as
    ``calculate_exchange_twoindex`` writes them."""
    q = np.arange(1, 10)
    l1 = np.sqrt(q - 0.9).astype(int)
    k0 = l1 * (l1 + 1) + 1
    refl = torch.as_tensor(2 * k0 - q - 1, device=d.device)
    sign = torch.as_tensor((-1.0) ** np.add.outer(np.arange(9),
                                                  np.arange(9)),
                           device=d.device)

    def reflect(g):
        return sign * g[..., refl, :][..., refl].transpose(-1, -2)

    def integrate(v):
        return _fermi_integral(v, emesh) * MRY

    ch = {}
    for c in "nxyz":
        gi, gj = ci[c], cj[c]
        rgj, rgi = reflect(gj), reflect(gi)
        ch[c + "0ij"] = d * (0.5 * (gi + rgj))
        ch[c + "1ij"] = d * (0.5 * (gi - rgj))
        ch[c + "0ji"] = d * (0.5 * (gj + rgi))
        ch[c + "1ji"] = d * (0.5 * (gj - rgi))

    def tr(a, b):
        return _trace(ch[a], ch[b])

    jcd = tr("n0ij", "n0ji").imag
    jcc = tr("n1ij", "n1ji").imag
    jsd = sum(tr(c + "0ij", c + "0ji").imag for c in "xyz")
    jsc = sum(tr(c + "1ij", c + "1ji").imag for c in "xyz")
    dsc = torch.stack([tr("n0ij", c + "1ji").real for c in "xyz"], 1)
    dcc = torch.stack([tr("n1ij", c + "0ji").real for c in "xyz"], 1)
    isd = torch.stack([torch.stack([tr(a + "0ij", b + "0ji").imag
                                    for b in "xyz"], 1) for a in "xyz"], 1)
    isc = torch.stack([torch.stack([tr(a + "1ij", b + "1ji").imag
                                    for b in "xyz"], 1) for a in "xyz"], 1)
    jcd, jcc, jsd, jsc, dsc, dcc, isd, isc = (
        x.cpu().numpy() for x in (jcd, jcc, jsd, jsc, dsc, dcc, isd, isc))
    rows = {name: [] for name in TWOINDEX}
    for p in range(jcd.shape[0]):
        rows["jijso"].append([integrate(jcd[p] - jsd[p] + jcc[p] - jsc[p])])
        rows["jijfo"].append([integrate(jcd[p] + jsd[p] - jcc[p] - jsc[p])])
        rows["jijparts"].append([integrate(jcd[p]), integrate(jsd[p]),
                                 integrate(jcc[p]), integrate(jsc[p])])
        rows["dijso"].append(integrate(2.0 * (dsc[p] + dcc[p])))
        rows["dijfo"].append(integrate(2.0 * (dsc[p] - dcc[p])))
        rows["dijparts"].append(np.concatenate([2.0 * integrate(dcc[p]),
                                                2.0 * integrate(dsc[p])]))
        rows["aijso"].append(integrate(isd[p] + isc[p]).T.ravel())
        rows["aijfo"].append(integrate(-isd[p] + isc[p]).T.ravel())
        rows["aijparts"].append(np.concatenate(
            [integrate(isd[p]).T.ravel(), integrate(isc[p]).T.ravel()]))
    return {k: np.array(v, dtype=np.float64) for k, v in rows.items()}
