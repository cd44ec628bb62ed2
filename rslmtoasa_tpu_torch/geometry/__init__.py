from .crystal import PrimitiveCell, primitive_cell, cell_volume, default_wav
from .cluster import Cluster, bravais_cluster, neighbor_map, newclu
from .strconst import canonical_sc, streze, screened_sbar, sbar_for_cluster
from .surface import build_surf_full

__all__ = [
    "PrimitiveCell", "primitive_cell", "cell_volume", "default_wav",
    "Cluster", "bravais_cluster", "neighbor_map", "newclu",
    "canonical_sc", "streze", "screened_sbar", "sbar_for_cluster",
    "build_surf_full",
]
