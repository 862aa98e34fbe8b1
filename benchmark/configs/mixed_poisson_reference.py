"""mixed_poisson's closed-form solution, in NumPy: the fields a solve's
grid is held against.  Each function computes in the dtype of its points.
"""

import numpy as np


def u(x, y):
    """The manufactured 2-form 2 cos(pi x/2) cos(pi y/2) + 5."""
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y) + 5


def q(x, y):
    """Its flux, the gradient of u, as (x, y) components."""
    return np.stack(
        (
            -np.pi * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


FIELDS = {"u": u, "q": q}
