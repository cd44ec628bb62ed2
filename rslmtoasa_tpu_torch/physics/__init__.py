from . import harmonics
from .hamiltonian import (
    HamiltonianBlocks,
    build_bulkham,
    build_lsham,
    build_obarm,
    build_enim,
    ham0m_nc,
)

__all__ = [
    "harmonics", "HamiltonianBlocks", "build_bulkham", "build_lsham",
    "build_obarm", "build_enim", "ham0m_nc",
]
