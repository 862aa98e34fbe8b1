"""The one generator of the benchmark's traffic: a closed loop of solves,
each on a new curved square mesh.

A traffic file (``traffic/<name>.json``) gives the mesh (``mesh`` by
``mesh`` elements), the order, the linear solver, the reconstruction order
and the range of the deformation's amplitude.  The seed draws one
amplitude a solve, so no two solves of a run share an operator, while
every solve has the same sizes.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator

import numpy as np


def curved_square(amplitude: float) -> Callable:
    """The gallery's curved square, ``x + a sin(pi x) sin(pi y)``,
    ``y - a sin(pi x) sin(pi y)``, at the amplitude ``a``.  It keeps the
    boundary of [-1, 1]^2 in place."""

    def deformation(x, y):
        s = amplitude * np.sin(np.pi * x) * np.sin(np.pi * y)
        return x + s, y - s

    return deformation


def amplitudes(seed: int, traffic: dict) -> Iterator[float]:
    """The amplitude of each solve, uniform in the traffic's range, drawn
    from the seed (any whole number, above 2**32 too)."""
    low, high = traffic["amplitude"]
    rng = np.random.Generator(np.random.PCG64(int(seed) % 2**64))
    while True:
        yield float(rng.uniform(low, high))
