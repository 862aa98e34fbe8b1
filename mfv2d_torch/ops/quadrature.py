"""Spectral primitives: GLL quadrature, Lagrange and Legendre evaluation.

These are host-side (NumPy, float64) table generators.  The device kernels only
consume the resulting small tables (basis values at integration points), so
there is no benefit to computing them on the device; what matters is that the
values are bit-stable and match the reference semantics
(reference: src/polynomials/gauss_lobatto.c:17-87,
lagrange.c:173-585, legendre.c:39).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import numpy.typing as npt


def _legendre_and_derivative(n: int, x: npt.NDArray[np.float64]):
    """Evaluate P_n and P_n' at ``x`` via the Bonnet recurrence."""
    p_prev = np.ones_like(x)
    if n == 0:
        return p_prev, np.zeros_like(x)
    p = x.copy()
    for k in range(1, n):
        p_next = ((2 * k + 1) * x * p - k * p_prev) / (k + 1)
        p_prev = p
        p = p_next
    # Derivative from the relation (1 - x^2) P_n' = n (P_{n-1} - x P_n)
    with np.errstate(divide="ignore", invalid="ignore"):
        dp = n * (p_prev - x * p) / (1.0 - x * x)
    # Endpoints: P_n'(±1) = (±1)^{n-1} n (n+1) / 2
    endpoint = np.isclose(np.abs(x), 1.0)
    if np.any(endpoint):
        sgn = np.where(x > 0, 1.0, (-1.0) ** (n - 1))
        dp = np.where(endpoint, sgn * n * (n + 1) / 2.0, dp)
    return p, dp


@lru_cache(maxsize=None)
def gauss_lobatto_nodes_weights(
    n_points: int, tol: float = 1e-15, max_iter: int = 20
) -> tuple[npt.NDArray[np.float64], npt.NDArray[np.float64]]:
    """Gauss-Lobatto-Legendre nodes and weights for ``n_points`` points.

    Nodes are the roots of (1 - x^2) P'_{n-1}(x); weights are
    2 / (n (n-1) P_{n-1}(x_i)^2).
    """
    n = int(n_points)
    if n < 2:
        raise ValueError("GLL rule requires at least 2 points.")
    if n == 2:
        nodes = np.array([-1.0, 1.0])
        weights = np.array([1.0, 1.0])
        nodes.setflags(write=False)
        weights.setflags(write=False)
        return nodes, weights

    # Chebyshev-Gauss-Lobatto initial guess.
    x = -np.cos(np.pi * np.arange(n) / (n - 1))
    # Newton iteration on q(x) = P'_{n-1}(x) for the interior nodes.
    # q'(x) follows from the Legendre ODE:
    #   (1 - x^2) P''_{n-1} = 2 x P'_{n-1} - n (n-1) P_{n-1}
    xi = x[1:-1]
    for _ in range(max_iter):
        p, dp = _legendre_and_derivative(n - 1, xi)
        ddp = (2.0 * xi * dp - n * (n - 1) * p) / (1.0 - xi * xi)
        dx = dp / ddp
        xi = xi - dx
        if np.max(np.abs(dx)) < tol:
            break
    x[1:-1] = xi
    p, _ = _legendre_and_derivative(n - 1, x)
    w = 2.0 / (n * (n - 1) * p * p)
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w


def compute_gll(order: int) -> tuple[npt.NDArray[np.float64], npt.NDArray[np.float64]]:
    """GLL nodes/weights of the rule of the given order (order + 1 points).

    Mirrors the reference ``compute_gll`` (src/polynomials/gauss_lobatto.c).
    """
    return gauss_lobatto_nodes_weights(order + 1)


def lagrange1d(roots: npt.ArrayLike, x: npt.ArrayLike) -> npt.NDArray[np.float64]:
    """Values of the Lagrange basis defined by ``roots`` at points ``x``.

    Returns an array of shape ``x.shape + (len(roots),)`` where the last axis
    indexes the basis polynomial (reference: lagrange.c:173 ``lagrange1d``).
    """
    r = np.asarray(roots, np.float64)
    xv = np.asarray(x, np.float64)
    n = r.size
    out = np.empty(xv.shape + (n,), np.float64)
    for j in range(n):
        others = np.delete(r, j)
        denom = np.prod(r[j] - others)
        out[..., j] = np.prod(xv[..., None] - others[None, :], axis=-1) / denom
    return out


def dlagrange1d(roots: npt.ArrayLike, x: npt.ArrayLike) -> npt.NDArray[np.float64]:
    """First derivatives of the Lagrange basis at points ``x``.

    Shape ``x.shape + (len(roots),)`` (reference: lagrange.c:379 ``dlagrange1d``).
    """
    r = np.asarray(roots, np.float64)
    xv = np.asarray(x, np.float64)
    n = r.size
    out = np.zeros(xv.shape + (n,), np.float64)
    for j in range(n):
        others = np.delete(r, j)
        denom = np.prod(r[j] - others)
        # d/dx prod (x - r_k) = sum_m prod_{k != m} (x - r_k)
        total = np.zeros_like(xv)
        for m in range(n - 1):
            rest = np.delete(others, m)
            total += np.prod(xv[..., None] - rest[None, :], axis=-1)
        out[..., j] = total / denom
    return out


def edge_basis_values(roots: npt.ArrayLike, x: npt.ArrayLike) -> npt.NDArray[np.float64]:
    """Histopolation (edge) basis values at points ``x``.

    ``e_j = -sum_{k <= j} dL_k`` so that the integral of ``e_j`` over
    ``[roots[j], roots[j+1]]`` is one (reference: basis.c:77-86).
    Shape ``x.shape + (len(roots) - 1,)``.
    """
    dl = dlagrange1d(roots, x)
    return -np.cumsum(dl[..., :-1], axis=-1)


def compute_legendre(order: int, x: npt.ArrayLike) -> npt.NDArray[np.float64]:
    """Legendre polynomials P_0..P_order at points ``x``.

    Returns shape ``(order + 1, len(x))`` matching the reference
    ``compute_legendre`` (legendre.c:39).
    """
    xv = np.asarray(x, np.float64).ravel()
    out = np.empty((order + 1, xv.size), np.float64)
    out[0] = 1.0
    if order >= 1:
        out[1] = xv
    for k in range(1, order):
        out[k + 1] = ((2 * k + 1) * xv * out[k] - k * out[k - 1]) / (k + 1)
    return out
