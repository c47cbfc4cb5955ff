"""95th percentile of the wall of every `BatchSolver.solve` call in the
window, host arrays in to host results out (numpy's linear quantile)."""

import numpy as np


def read(run):
    return float(np.percentile(run.walls, 95)) * 1e3
