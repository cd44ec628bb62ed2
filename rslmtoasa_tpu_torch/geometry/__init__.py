from .crystal import PrimitiveCell, primitive_cell, cell_volume, default_wav
from .cluster import Cluster, bravais_cluster, neighbor_map
from .strconst import canonical_sc, streze, screened_sbar, sbar_for_cluster

__all__ = [
    "PrimitiveCell", "primitive_cell", "cell_volume", "default_wav",
    "Cluster", "bravais_cluster", "neighbor_map",
    "canonical_sc", "streze", "screened_sbar", "sbar_for_cluster",
]
