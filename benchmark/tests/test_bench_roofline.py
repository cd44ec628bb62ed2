"""The light-cone counter against a brute-force count, and the frozen
full-width arithmetic against the kernel table it came from."""

import numpy as np
import pytest

from benchmark import roofline
from benchmark.reference.lattice import BccBox


def brute_cone(dims, alat, ct1, starts, steps):
    """Sites within k hops and the blocks that read them, from an explicit
    list of atoms and their neighbours by distance."""
    a = np.array([[-0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, -0.5]]).T
    lc = [(n + 1) // 2 for n in dims]
    m = np.stack(np.meshgrid(*[np.arange(1 - c, n - c + 1)
                               for c, n in zip(lc, dims)], indexing="ij"),
                 -1).reshape(-1, 3)
    r = (m @ a.T) * alat
    d = np.linalg.norm(r[:, None] - r[None], axis=-1)
    nb = [set(np.nonzero((d[i] < ct1) & (d[i] > 1e-9))[0])
          for i in range(len(r))]
    index = {tuple(x): i for i, x in enumerate(m)}
    cone = {index[tuple(s)] for s in starts}
    out = []
    for _ in range(steps):
        out.append((len(cone), sum(1 + len(nb[j]) for j in cone)))
        cone = cone | {k for j in cone for k in nb[j]}
    return out


@pytest.mark.parametrize("dims,starts", [
    ((6, 6, 6), [(0, 0, 0)]),
    ((5, 7, 6), [(0, 0, 0), (1, 2, 2)]),
    ((4, 4, 4), [(-1, 2, 0)]),
])
def test_cone_matches_brute_force(dims, starts):
    box = BccBox(dims, 2.8612, 3.0)
    assert len(box.shifts) == 14
    assert box.cone(starts, 8) == brute_cone(dims, 2.8612, 3.0, starts, 8)


def test_full_width_arithmetic():
    """K4 at d = 18, R = 1 on the box-30 table (383 758 occupied blocks):
    0.3048 ms, the bound of the port's kernel table."""
    t = roofline.full_width_bound(27000, 383758, 18, 1)
    assert abs(t * 1e3 - 0.3048) < 5e-5


def test_cone_bound_below_full_width():
    box = BccBox((30, 30, 30), 2.8612, 3.0)
    cone = roofline.recursion_bound(box, [[(0, 0, 0)]], 19, 18, True)
    full = 19 * roofline.full_width_bound(27000, 383758, 18, 1)
    assert 0.2 * full < cone < full
