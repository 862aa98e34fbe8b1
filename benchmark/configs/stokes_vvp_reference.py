"""stokes_vvp's closed-form solution, in NumPy: the fields a solve's grid is
held against.  Each function computes in the dtype of its points.

The exact pressure is zero, so it is held by magnitude (``prs_max``): a
ratio to its RMS has no meaning.
"""

import numpy as np


def vel(x, y):
    """The manufactured velocity (sin x cos y, -cos x sin y), divergence-free."""
    return np.stack((np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)), axis=-1)


def vor(x, y):
    """Its vorticity 0-form, -2 sin x sin y."""
    return -2 * np.sin(x) * np.sin(y)


FIELDS = {"vel": vel, "vor": vor}
MAGNITUDE_FIELDS = ("prs",)
