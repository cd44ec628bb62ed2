from .potential import Element, Potential, SymbolicAtom, QM_CANONICAL

__all__ = ["Element", "Potential", "SymbolicAtom", "QM_CANONICAL"]
