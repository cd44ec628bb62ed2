"""K4's work as the inputs need it, and the chip's peaks.

The bound of one ``block_step`` launch is the larger of its operations over
the FP64 tensor peak and its bytes over the memory bandwidth (NVIDIA H100
SXM data sheet, 700 W).  The operations are counted from what the inputs
need, not from the rows the implementation touches: at recursion step k a
chain's vector is nonzero on the sites within k hops of its start sites
(the light cone, :meth:`lattice.BccBox.cone`), and its H application reads
the occupied (row, slot) blocks whose column lies in that cone, at 8 flop a
complex multiply-add; the onsite term adds one d x d block a cone site, and
the block Lanczos Gram one more (the Chebyshev step has no Gram).  Bytes:
each input read once (the tables, the cone's vector rows, the neighbour
indices of the rows written), each output written once (the rows within
k + 1 hops, the Gram blocks).  So the full-width route and the wavefront's
prefixes are held to the same count, and no reading can pass 100 %.

``full_width_bound`` is the arithmetic the port's kernel tables used before
the benchmark (every occupied block of the cluster, the onsite and Gram
terms on every row), kept for comparison.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = 67.0e12  # FP64 tensor core, flop/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
Z = 16  # bytes of a complex128


def launch_bound(cone_k, cone_next, d: int, nslots: int, gram: bool,
                 ntype: int = 1) -> float:
    """Seconds of one launch for one chain of d columns: ``cone_k`` =
    (sites, blocks) within k hops, ``cone_next`` the sites within k + 1."""
    sites, blocks = cone_k
    flops = 8.0 * d * d * d * (blocks + sites * (2 if gram else 1))
    nbytes = (Z * d * d * (ntype * nslots + ntype)          # tables
              + Z * d * d * sites                           # vector rows
              + 4 * (nslots + 1) * cone_next                # cols, iz
              + Z * d * d * cone_next                       # H psi rows
              + (Z * d * d if gram else 0))                 # Gram block
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def recursion_bound(box, chains_starts: Sequence[Sequence], launches: int,
                    d: int, gram: bool) -> float:
    """Seconds of the ``launches`` K4 launches of one recursion of the
    chains whose start sites are ``chains_starts``, each application k
    acting on the cone of k hops."""
    nslots = 1 + len(box.shifts)
    total = 0.0
    for starts in chains_starts:
        cone = box.cone(starts, launches + 1)
        total += sum(launch_bound(cone[k], cone[k + 1][0], d, nslots, gram)
                     for k in range(launches))
    return total


def full_width_bound(kk: int, occupied: int, d: int, r: int,
                     gram: bool = True) -> float:
    """Seconds of one launch counted over every occupied block of the
    cluster and every row (the port's kernel tables before the benchmark:
    ``PERF.md``'s kernel table, "How the bounds are reckoned")."""
    c = d * r
    flops = 8.0 * occupied * d * d * c + 8.0 * kk * d ** 3 * r * (
        2 if gram else 1)
    nbytes = 2 * Z * kk * d * c + 4 * occupied
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
