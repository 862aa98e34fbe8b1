"""1D/2D FEM basis containers and the basis cache.

Host-side objects holding small NumPy tables of basis values at integration
points.  The device assembly kernels consume these tables directly.

Reference parity: ``IntegrationRule1D``/``Basis1D``/``Basis2D`` mirror the C
types in the reference's src/fem_space/{integration_rule.c,basis.c};
``FemCache`` mirrors python/mfv2d/mimetic2d.py:441-598.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import numpy.typing as npt

from mfv2d_torch.ops.quadrature import (
    compute_gll,
    edge_basis_values,
    lagrange1d,
)


class IntegrationRule1D:
    """GLL integration rule of a given order (order + 1 points)."""

    __slots__ = ("order", "nodes", "weights")

    def __init__(self, order: int) -> None:
        if order < 0:
            raise ValueError("Integration rule order can not be negative.")
        self.order = int(order)
        nodes, weights = compute_gll(self.order)
        self.nodes = nodes
        self.weights = weights

    def __repr__(self) -> str:
        return f"IntegrationRule1D({self.order})"


class Basis1D:
    """Nodal (Lagrange on GLL roots) and edge (histopolation) basis tables.

    Attributes
    ----------
    node : (order + 1, n_pts) array
        Nodal basis values at the integration points.
    edge : (order, n_pts) array
        Edge basis values at the integration points.
    roots : (order + 1,) array
        GLL roots defining the nodal basis.
    """

    __slots__ = ("order", "rule", "roots", "node", "edge")

    def __init__(self, order: int, rule: IntegrationRule1D) -> None:
        if order <= 0:
            raise ValueError(f"Order must be greater than zero, got {order}.")
        self.order = int(order)
        self.rule = rule
        self.roots = compute_gll(self.order)[0]
        # Tables are stored (basis, point) like the reference Basis1D.
        self.node = np.ascontiguousarray(lagrange1d(self.roots, rule.nodes).T)
        self.edge = np.ascontiguousarray(edge_basis_values(self.roots, rule.nodes).T)

    def __repr__(self) -> str:
        return f"Basis1D(order={self.order}, rule_order={self.rule.order})"


class Basis2D:
    """Pair of 1D bases for the two reference directions."""

    __slots__ = ("basis_xi", "basis_eta")

    def __init__(self, basis_xi: Basis1D, basis_eta: Basis1D) -> None:
        self.basis_xi = basis_xi
        self.basis_eta = basis_eta

    @property
    def orders(self) -> tuple[int, int]:
        return (self.basis_xi.order, self.basis_eta.order)

    @property
    def integration_orders(self) -> tuple[int, int]:
        return (self.basis_xi.rule.order, self.basis_eta.rule.order)

    @property
    def order_1(self) -> int:
        return self.basis_xi.order

    @property
    def order_2(self) -> int:
        return self.basis_eta.order


@lru_cache(maxsize=None)
def _cached_rule(order: int) -> IntegrationRule1D:
    return IntegrationRule1D(order)


@lru_cache(maxsize=None)
def _cached_basis(order: int, int_order: int) -> Basis1D:
    return Basis1D(order, _cached_rule(int_order))


class FemCache:
    """Cache for integration rules and 1D bases.

    Parameters
    ----------
    order_difference : int
        Offset between the basis order and the default integration-rule order
        (the reference's over-integration policy, mimetic2d.py:441-463).
    """

    def __init__(self, order_difference: int) -> None:
        self.order_diff = int(order_difference)
        self._min_cache: dict[int, npt.NDArray[np.float64]] = {}
        self._mie_cache: dict[int, npt.NDArray[np.float64]] = {}

    def get_integration_rule(self, order: int) -> IntegrationRule1D:
        return _cached_rule(int(order))

    def get_basis1d(self, order: int, int_order: int | None = None) -> Basis1D:
        if int_order is None:
            int_order = order + self.order_diff
        return _cached_basis(int(order), int(int_order))

    def get_basis2d(
        self,
        order1: int,
        order2: int,
        int_order1: int | None = None,
        int_order2: int | None = None,
    ) -> Basis2D:
        b_xi = self.get_basis1d(order1, int_order1)
        b_eta = (
            b_xi
            if (order2 == order1 and int_order1 == int_order2)
            else self.get_basis1d(order2, int_order2)
        )
        return Basis2D(b_xi, b_eta)

    def clean(self) -> None:
        self._min_cache.clear()
        self._mie_cache.clear()

    def get_mass_inverse_1d_node(self, order: int) -> npt.NDArray[np.float64]:
        if order not in self._min_cache:
            basis = self.get_basis1d(order)
            w = basis.rule.weights
            mat = np.einsum("ip,jp,p->ij", basis.node, basis.node, w)
            self._min_cache[order] = np.linalg.inv(mat)
        return self._min_cache[order]

    def get_mass_inverse_1d_edge(self, order: int) -> npt.NDArray[np.float64]:
        if order not in self._mie_cache:
            basis = self.get_basis1d(order)
            w = basis.rule.weights
            mat = np.einsum("ip,jp,p->ij", basis.edge, basis.edge, w)
            self._mie_cache[order] = np.linalg.inv(mat)
        return self._mie_cache[order]
