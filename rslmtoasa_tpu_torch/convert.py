"""Carry a system's state across from the JAX package as plain NumPy.

:func:`system_to_numpy` flattens a built bulk system (either package's:
it reads attributes only, so it needs no import of the other package)
into a dict of arrays plus one dict per species; :func:`system_from_numpy`
rebuilds the port's :class:`~.models.bulk.BulkSystem` from them, so that
both packages compute on identical inputs.

Array keys: the cluster's fields by name (``cr``, ``iz``, ``num``,
``alat``, ``wav``, ``ntype``, ``nbulk``, ``nrec``, ``iu``, ``ib``,
``irec``, ``atlist``, ``nn``, ``pbc``, an impurity's ``nmax``, ``nbas``
and ``chargetrf_type``, a slab's ``natoms_layer`` and ``miller``), its
cell as ``cell_<field>``, the per-site ragged lists as ``dirs_<site>``,
``sbar_<site>`` and ``sbarvec_<site>``, and the Hamiltonian's fields as
``ham_<field>`` (``ham_ee``, ``ham_cols``, ``ham_iz``, and ``ham_eeo``,
``ham_enim``, ``ham_lsham``, an impurity's combined tables ``ham_blocks``,
``ham_iz_eff``, ... where present).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .atoms.potential import Element, Potential, SymbolicAtom
from .config import JobConfig
from .geometry.cluster import Cluster
from .geometry.crystal import PrimitiveCell
from .models.bulk import BulkSystem
from .physics.energy_mesh import EnergyMesh
from .physics.hamiltonian import HamiltonianBlocks
from .utils.device import resolve_device
from .utils.namelist import Namelists

_CLUSTER = ("cr", "iz", "num", "kk", "alat", "wav", "ntype", "nbulk",
            "nrec", "iu", "ib", "irec", "atlist", "nmax", "pbc",
            "pbc_dims", "nn_count", "nn", "_ct1", "nbas", "chargetrf_type",
            "natoms_layer", "miller")
# a slab's attributes that build_surf_full sets beside the dataclass fields
_CLUSTER_EXTRA = ("natoms_layer", "miller")
_CELL = ("a", "crd", "izp", "no", "ntot")
_HAM = ("ee", "cols", "iz", "lsham", "hxc", "eeo", "eeoee", "enim",
        "obarm", "hall", "hallo", "blocks", "blocks_o", "iz_eff")
_ELEMENT = ("symbol", "atomic_number", "core", "valence", "f_core",
            "num_quant_s", "num_quant_p", "num_quant_d")


def system_to_numpy(sys) -> Tuple[Dict[str, np.ndarray], List[dict]]:
    """(arrays, potentials) of a built bulk system of either package."""
    cl = sys.cluster
    arrays = {k: np.asarray(getattr(cl, k)) for k in _CLUSTER
              if getattr(cl, k, None) is not None}
    arrays.update({f"cell_{k}": np.asarray(getattr(cl.cell, k))
                   for k in _CELL})
    for site, d in enumerate(cl.dirs):
        arrays[f"dirs_{site}"] = np.asarray(d)
    for site, (sb, vec) in enumerate(zip(sys.sbars, sys.sbarvecs)):
        arrays[f"sbar_{site}"] = np.asarray(sb)
        arrays[f"sbarvec_{site}"] = np.asarray(vec)
    if sys.ham is not None:
        arrays.update({f"ham_{k}": np.asarray(getattr(sys.ham, k))
                       for k in _HAM if getattr(sys.ham, k) is not None})
    potentials = []
    for at in sys.atoms:
        p = {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
             for k, v in vars(at.potential).items()}
        p["element"] = {k: getattr(at.element, k) for k in _ELEMENT}
        p["label"] = at.label
        potentials.append(p)
    return arrays, potentials


def _scalar(x):
    x = np.asarray(x)
    return x.item() if x.ndim == 0 else x


def system_from_numpy(arrays: Dict[str, np.ndarray], potentials: List[dict],
                      device, cfg: Optional[JobConfig] = None
                      ) -> BulkSystem:
    """The port's :class:`BulkSystem` from :func:`system_to_numpy`'s output,
    recursing on ``device``.  ``cfg`` defaults to a config with every
    namelist value at its default."""
    if cfg is None:
        cfg = JobConfig.from_namelists(Namelists())
    cell = PrimitiveCell(**{k: _scalar(arrays[f"cell_{k}"]) for k in _CELL})
    fields = {k: _scalar(arrays[k]) for k in _CLUSTER if k in arrays}
    ct1 = fields.pop("_ct1", 0.0)
    extra = {k: fields.pop(k) for k in _CLUSTER_EXTRA if k in fields}
    cl = Cluster(cell=cell, **fields)
    cl._ct1 = ct1
    for k, v in extra.items():
        setattr(cl, k, v)
    nsite = sum(1 for k in arrays if k.startswith("dirs_"))
    cl.dirs = [np.array(arrays[f"dirs_{s}"]) for s in range(nsite)]
    nsb = sum(1 for k in arrays if k.startswith("sbar_"))
    sys = BulkSystem(cfg=cfg, device=resolve_device(device))
    sys.cluster = cl
    sys.sbars = [np.array(arrays[f"sbar_{s}"]) for s in range(nsb)]
    sys.sbarvecs = [np.array(arrays[f"sbarvec_{s}"]) for s in range(nsb)]
    if "ham_ee" in arrays:
        sys.ham = HamiltonianBlocks(**{
            k: np.array(arrays[f"ham_{k}"]) for k in _HAM
            if f"ham_{k}" in arrays})
        if sys.ham.iz_eff is not None:
            sys.ham.iz_eff = sys.ham.iz_eff.astype(np.int32)
    for p in potentials:
        p = dict(p)
        el = Element(**p.pop("element"))
        label = p.pop("label")
        pot = Potential()
        for k, v in p.items():
            setattr(pot, k, np.array(v, copy=True)
                    if isinstance(v, np.ndarray) else v)
        sys.atoms.append(SymbolicAtom(element=el, potential=pot,
                                      label=label))
    sys.emesh = EnergyMesh.build(cfg.energy)
    return sys
