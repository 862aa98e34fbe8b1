"""navier_stokes_re10's closed-form solution, in NumPy: the fields a
solve's grid is held against.  Each function computes in the dtype of its
points.

The pressure is not compared: at 32x32, p=5, Picard's stop at a residual
of 1e-8 leaves it off by 9.3e-7 of its RMS on every seed, more than the
float32 control's 1.4e-7, so no limit lies between the two.
"""

import numpy as np


def vel(x, y):
    """The manufactured velocity (sin y, cos x), divergence-free."""
    return np.stack((np.sin(y) + 0 * x, np.cos(x) + 0 * y), axis=-1)


def vor(x, y):
    """Its vorticity 0-form, -(sin x + cos y)."""
    return -(np.sin(x) + np.cos(y))


FIELDS = {"vel": vel, "vor": vor}
