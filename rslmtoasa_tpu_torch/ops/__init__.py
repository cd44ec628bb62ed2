from .lanczos import (
    HaydockOperator,
    block_spmv,
    lanczos_coefficients,
    scalar_start_vectors,
)
from .terminator import bpopt, emami
from .ldos import bprldos, orbital_density

__all__ = [
    "HaydockOperator", "block_spmv", "lanczos_coefficients",
    "scalar_start_vectors", "bpopt", "emami", "bprldos", "orbital_density",
]
