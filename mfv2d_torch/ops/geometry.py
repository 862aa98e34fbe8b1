"""Bilinear element geometry: mapping and Jacobians, batched over elements.

Conventions match the reference (python/mfv2d/mimetic2d.py:876-1000 and
src/fem_space/fem_space.c:39-53):

    J = [[j00, j01], [j10, j11]] = [[dx/dxi, dy/dxi], [dx/deta, dy/deta]]
    det = j00 * j11 - j10 * j01

Corner order is counter-clockwise starting bottom-left: c0=(−1,−1), c1=(+1,−1),
c2=(+1,+1), c3=(−1,+1) in the reference square.

Inputs may be NumPy arrays or tensors; NumPy inputs become CPU tensors of
their own dtype, and reference coordinates follow the corners' dtype and
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mfv2d_torch.transfer import to_device


def _tensor(v) -> torch.Tensor:
    # NumPy inputs are copied: the basis tables are read-only arrays.
    return v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))


def _as_like(v, like: torch.Tensor) -> torch.Tensor:
    return to_device(_tensor(v), like.device, like.dtype)


def bilinear_interpolate(corner_vals, xi, eta):
    """Bilinear interpolation of per-corner values at reference points.

    ``corner_vals`` has the 4 corner values along its *last* axis (so batched
    ``[E, 4]`` works); ``xi``/``eta`` broadcast against each other.
    """
    c = _tensor(corner_vals)
    t0 = _as_like(xi, c)
    t1 = _as_like(eta, c)
    b11 = (1 - t0) / 2
    b12 = (1 + t0) / 2
    b21 = (1 - t1) / 2
    b22 = (1 + t1) / 2
    c = c[..., None, None]  # broadcast corner axis against grid axes
    return (c[..., 0, :, :] * b11 + c[..., 1, :, :] * b12) * b21 + (
        c[..., 3, :, :] * b11 + c[..., 2, :, :] * b12
    ) * b22


class JacobianTerms(NamedTuple):
    """Jacobian entries and determinant at a grid of reference points."""

    j00: torch.Tensor  # dx/dxi
    j01: torch.Tensor  # dy/dxi
    j10: torch.Tensor  # dx/deta
    j11: torch.Tensor  # dy/deta
    det: torch.Tensor


def jacobian(corners, nodes_xi, nodes_eta) -> JacobianTerms:
    """Jacobian terms at the tensor grid of reference points.

    Parameters
    ----------
    corners : (..., 4, 2) array or tensor
        Element corners; a leading batch axis is supported.
    nodes_xi, nodes_eta : arrays
        Reference coordinates, broadcast against each other (the usual call is
        ``nodes_xi[None, :]`` and ``nodes_eta[:, None]`` giving an
        (n_eta, n_xi) grid).

    Returns
    -------
    JacobianTerms
        Each entry has shape ``corners.shape[:-2] + broadcast(xi, eta).shape``.
    """
    c = _tensor(corners)
    t0 = _as_like(nodes_xi, c)
    t1 = _as_like(nodes_eta, c)
    x = c[..., 0]
    y = c[..., 1]

    def _mk(v):
        return v[..., None, None]

    x0, x1, x2, x3 = (_mk(x[..., i]) for i in range(4))
    y0, y1, y2, y3 = (_mk(y[..., i]) for i in range(4))

    dx_dxi = ((x1 - x0) * (1 - t1) + (x2 - x3) * (1 + t1)) / 4
    dx_deta = ((x3 - x0) * (1 - t0) + (x2 - x1) * (1 + t0)) / 4
    dy_dxi = ((y1 - y0) * (1 - t1) + (y2 - y3) * (1 + t1)) / 4
    dy_deta = ((y3 - y0) * (1 - t0) + (y2 - y1) * (1 + t0)) / 4
    det = dx_dxi * dy_deta - dx_deta * dy_dxi
    # Terms that depend on only one reference coordinate would keep a
    # degenerate axis; broadcast everything to the full grid shape.
    shape = det.shape
    dx_dxi, dy_dxi, dx_deta, dy_deta = (
        v.expand(shape) for v in (dx_dxi, dy_dxi, dx_deta, dy_deta)
    )
    return JacobianTerms(dx_dxi, dy_dxi, dx_deta, dy_deta, det)


def physical_coordinates(corners, nodes_xi, nodes_eta):
    """Map reference grid points to physical (x, y); batched like jacobian."""
    c = _tensor(corners)
    x = bilinear_interpolate(c[..., 0], nodes_xi, nodes_eta)
    y = bilinear_interpolate(c[..., 1], nodes_xi, nodes_eta)
    return x, y
