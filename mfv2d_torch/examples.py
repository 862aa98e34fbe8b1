"""Common example mesh setups (reference: python/mfv2d/examples.py)."""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np

from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.mimetic import mesh_create


def unit_square_mesh(
    nh: int,
    nv: int,
    orders: int | Sequence[int],
    deformation: Callable | None = None,
) -> Mesh:
    """Structured quad mesh of the square [-1, 1]^2, optionally deformed."""
    xi, eta = np.meshgrid(np.linspace(-1, +1, nh + 1), np.linspace(-1, +1, nv + 1))
    if deformation is not None:
        p_xi, p_eta = deformation(xi, eta)
        xi = np.asarray(p_xi, np.float64)
        eta = np.asarray(p_eta, np.float64)

    lines_h = [
        ((nh + 1) * j + i + 1, (nh + 1) * j + i + 2)
        for j in range(nv + 1)
        for i in range(nh)
    ]
    lines_v = [
        ((nh + 1) * j + i + 1, (nh + 1) * j + i + nh + 2)
        for j in range(nv)
        for i in range(nh + 1)
    ]
    surfaces = [
        (
            i + nh * j + 1,
            nh * (nv + 1) + j * (nh + 1) + (i + 1) + 1,
            -(i + nh * j + 1 + nh),
            -(nh * (nv + 1) + j * (nh + 1) + i + 1),
        )
        for j in range(nv)
        for i in range(nh)
    ]
    return mesh_create(
        orders,
        np.stack((xi.flatten(), eta.flatten()), axis=-1),
        lines_h + lines_v,
        surfaces,
    )
