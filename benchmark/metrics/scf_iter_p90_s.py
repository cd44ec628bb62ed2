"""scf_iter_p90_s: the 90th percentile (nearest rank) of the window's
single-iteration walls."""

import math


def read(run):
    walls = sorted(run.walls)
    return walls[max(0, math.ceil(0.9 * len(walls)) - 1)]
