"""The 90th percentile of the loop's unit walls: a chunk (a single-beam
cell) or an epoch of every beam (a multi-beam cell), from the budget
accountant of the traced run."""

import numpy as np


def read(view):
    walls = [c["wall_s"] for c in view.chunks]
    if len(walls) < 2:
        return None
    return float(np.percentile(walls, 90))
