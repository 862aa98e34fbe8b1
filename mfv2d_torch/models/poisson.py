"""Poisson model family: direct (0-form) and mixed (2-form) formulations.

Library versions of the reference example setups (examples/steady/
plot_direct_poisson.py, plot_mixed_poisson.py) with their manufactured
solutions, usable as tests, benchmarks, or starting points.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mfv2d_torch.kform import KFormUnknown, UnknownFormOrder
from mfv2d_torch.system import KFormSystem


def u_exact(x, y):
    """Manufactured solution 2 cos(pi x/2) cos(pi y/2) + 5."""
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y) + 5


def grad_u_exact(x, y):
    """Gradient of the manufactured solution (vector components)."""
    return np.stack(
        (
            -np.pi * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def curl_u_exact(x, y):
    """Rotated gradient (the flux-form 1-form du of the 0-form u)."""
    return np.stack(
        (
            -np.pi * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
            +np.pi * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
        ),
        axis=-1,
    )


def source_exact(x, y):
    """Laplacian of the manufactured solution."""
    return -(np.pi**2) * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


@dataclass(frozen=True)
class PoissonModel:
    """A Poisson problem setup: the system plus its unknowns."""

    system: KFormSystem
    u: KFormUnknown
    q: KFormUnknown


def mixed_poisson() -> PoissonModel:
    """Mixed formulation: u as a 2-form, flux q as a 1-form, weak BCs."""
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = KFormSystem(
        p.derivative @ u - p @ q == p ^ u_exact,
        v @ q.derivative == -(v @ source_exact),
    )
    return PoissonModel(system, u, q)


def direct_poisson() -> PoissonModel:
    """Direct formulation: u as a 0-form with auxiliary 1-form q.

    Pair with a strong Dirichlet BC on ``u`` over the mesh boundary.
    """
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = KFormSystem(
        v.derivative @ u.derivative == -(v @ source_exact) + (v ^ curl_u_exact),
        p @ u.derivative - p @ q == 0,
        sorting=lambda f: f.order,
    )
    return PoissonModel(system, u, q)
