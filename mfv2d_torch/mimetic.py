"""Mesh construction and element-side DoF helpers.

Hosts the glue between topology and discretization: creating a :class:`Mesh`
from geometry, mapping element sides to boundary DoF indices, and small
constraint containers.  Mirrors python/mfv2d/mimetic2d.py:601-873 of the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import numpy.typing as npt

from mfv2d_torch.kform import UnknownFormOrder
from mfv2d_torch.mesh.manifold import Manifold2D, Surface
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.ops.geometry import jacobian, physical_coordinates


class ElementSide(IntEnum):
    """Side of a quadrilateral element, counter-clockwise from the bottom."""

    SIDE_BOTTOM = 1
    SIDE_RIGHT = 2
    SIDE_TOP = 3
    SIDE_LEFT = 4

    @property
    def next(self) -> ElementSide:
        return ElementSide((self.value & 3) + 1)

    @property
    def prev(self) -> ElementSide:
        return ElementSide(((self.value - 2) & 3) + 1)


def find_surface_boundary_id_line(s: Surface, i: int) -> ElementSide:
    """Which side of the surface is the line with (0-based) index ``i``."""
    for side, gid in zip(ElementSide, s):
        if gid.index == i:
            return side
    raise ValueError(f"Line with index {i} is not in the surface {s}.")


def element_node_children_on_side(
    side: ElementSide, children: tuple[int, int, int, int]
) -> tuple[int, int]:
    """The two children adjacent to a side, in CCW order along the side."""
    i_begin = side.value - 1
    i_end = side.value & 3
    return int(children[i_begin]), int(children[i_end])


def element_boundary_dofs(
    side: ElementSide, order: UnknownFormOrder, order_1: int, order_2: int
) -> npt.NDArray[np.uint32]:
    """Indices of a form's DoFs along an element side (CCW orientation).

    Matches mimetic2d.py:712-800: 0-forms give order+1 nodal DoFs, 1-forms
    give the "order" normal-flux edge DoFs; top/left sides are flipped so the
    walk is always counter-clockwise.
    """
    if order == UnknownFormOrder.FORM_ORDER_0:
        # Nodal DoFs: a (order_2 + 1, order_1 + 1) row-major (eta, xi) grid;
        # a side is one border row/column, reversed on top/left for CCW.
        grid = np.arange((order_1 + 1) * (order_2 + 1), dtype=np.uint32).reshape(
            order_2 + 1, order_1 + 1
        )
        per_side = {
            ElementSide.SIDE_BOTTOM: grid[0, :],
            ElementSide.SIDE_RIGHT: grid[:, -1],
            ElementSide.SIDE_TOP: grid[-1, ::-1],
            ElementSide.SIDE_LEFT: grid[::-1, 0],
        }
    elif order == UnknownFormOrder.FORM_ORDER_1:
        # Edge DoFs come in two row-major blocks: xi-directed edges on a
        # (order_2 + 1, order_1) grid, then eta-directed edges on a
        # (order_2, order_1 + 1) grid.  A side's flux DoFs are the border
        # row/column of the block whose edges run along that side.  (The
        # reference's right-side expression, mimetic2d.py:744-750, offsets
        # by order_2 where the anisotropic layout requires order_1; the
        # grid form is correct for any (order_1, order_2).)
        xi_edges = np.arange(order_1 * (order_2 + 1), dtype=np.uint32).reshape(
            order_2 + 1, order_1
        )
        eta_edges = order_1 * (order_2 + 1) + np.arange(
            (order_1 + 1) * order_2, dtype=np.uint32
        ).reshape(order_2, order_1 + 1)
        per_side = {
            ElementSide.SIDE_BOTTOM: xi_edges[0, :],
            ElementSide.SIDE_RIGHT: eta_edges[:, -1],
            ElementSide.SIDE_TOP: xi_edges[-1, ::-1],
            ElementSide.SIDE_LEFT: eta_edges[::-1, 0],
        }
    elif order == UnknownFormOrder.FORM_ORDER_2:
        raise ValueError("2-forms have no boundary DoFs.")
    else:
        raise ValueError(f"Invalid order {order=}.")
    if side not in per_side:
        raise ValueError(f"Invalid side {side=}.")
    return np.ascontiguousarray(per_side[side])


def get_side_order(mesh: Mesh, element_idx: int, side: ElementSide, /) -> int:
    """Polynomial order along a side; children of split elements add up."""
    children = mesh.get_element_children(element_idx)
    if children is not None:
        c1, c2 = element_node_children_on_side(side, children)
        return get_side_order(mesh, c1, side) + get_side_order(mesh, c2, side)
    orders = mesh.get_leaf_orders(element_idx)
    return int(orders[(side.value - 1) & 1])


@dataclass(frozen=True)
class ElementConstraint:
    """DoFs and coefficients of one element participating in a constraint."""

    i_e: int
    dofs: npt.NDArray[np.uint32]
    coeffs: npt.NDArray[np.float64]


@dataclass(init=False, frozen=True)
class Constraint:
    """One Lagrange constraint row: rhs and contributing elements."""

    rhs: float
    element_constraints: tuple[ElementConstraint, ...]

    def __init__(self, rhs: float, *element_constraints: ElementConstraint) -> None:
        object.__setattr__(self, "rhs", float(rhs))
        object.__setattr__(self, "element_constraints", element_constraints)


def vtk_lagrange_ordering(order: int) -> npt.NDArray[np.uint32]:
    """Node ordering of a VTK Lagrange quadrilateral of the given order.

    VTK stores high-order quads as corners (CCW), then the four edge
    interiors (bottom, right, top, left, each in increasing coordinate),
    then the cell interior row-major.  Expressed as selections from the
    row-major (eta, xi) node grid.
    """
    n = int(order) + 1
    grid = np.arange(n * n, dtype=np.uint32).reshape(n, n)
    corners = grid[[0, 0, -1, -1], [0, -1, -1, 0]]
    if order <= 1:
        return corners
    return np.concatenate(
        (
            corners,
            grid[0, 1:-1],  # bottom edge interior
            grid[1:-1, -1],  # right edge interior
            grid[-1, 1:-1],  # top edge interior
            grid[1:-1, 0],  # left edge interior
            grid[1:-1, 1:-1].ravel(),  # cell interior
        )
    )


def mesh_create(order, positions, lines, surfaces) -> Mesh:
    """Create a mesh from point positions, line and surface connectivity.

    ``lines`` are 1-based point index pairs; ``surfaces`` are 1-based signed
    line ids (negative = reversed).  ``order`` may be a scalar, per-element
    sequence, or (N, 2) array (mimetic2d.py:633-700).
    """
    pos = np.array(positions, np.float64, copy=True, ndmin=2)
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError("Positions must be a (N, 2) array.")
    surf = np.asarray(surfaces, np.int64)
    if surf.ndim != 2 or surf.shape[1] != 4:
        raise ValueError("Surfaces should be an (M, 4) array of integers.")
    n_surf = surf.shape[0]

    orders_array = np.asarray(order, np.int64)
    if orders_array.ndim == 0:
        orders_array = np.full((n_surf, 2), orders_array)
    elif orders_array.shape[0] != n_surf:
        raise ValueError("Orders array must have one entry per surface.")
    elif orders_array.ndim == 1:
        orders_array = np.stack((orders_array, orders_array), axis=1)
    elif orders_array.ndim != 2 or orders_array.shape[1] != 2:
        raise ValueError("Orders must be scalar, (N,) or (N, 2).")
    if np.any(orders_array < 1):
        raise ValueError("Order can not be lower than 1.")

    primal = Manifold2D.from_regular(pos.shape[0], np.asarray(lines, np.int64), surf)
    dual = primal.compute_dual()

    corners = np.empty((n_surf, 4, 2), np.float64)
    for idx_surf in range(n_surf):
        s = primal.get_surface(idx_surf + 1)
        assert len(s) == 4
        for n_line in range(4):
            line = primal.get_line(s[n_line])
            corners[idx_surf, n_line] = pos[line.begin.index]

    bnd = [
        n_line
        for n_line in range(dual.n_lines)
        if not dual.get_line(n_line + 1).begin or not dual.get_line(n_line + 1).end
    ]
    return Mesh(primal, dual, corners, orders_array, np.array(bnd, np.uintc))


def integrate_over_elements(mesh: Mesh, function, orders=None) -> np.ndarray:
    """Integral of a function over each leaf element (mimetic2d.py:1282)."""
    leaf_indices = mesh.get_leaf_indices()
    if orders is not None:
        if isinstance(orders, int):
            order_vals = np.full((len(leaf_indices), 2), orders, np.int64)
        else:
            order_vals = np.asarray(orders, np.int64)
            if order_vals.ndim == 1:
                order_vals = np.stack((order_vals, order_vals), axis=-1)
            if len(order_vals) != len(leaf_indices):
                raise ValueError("Orders array length must match leaf count.")
    else:
        order_vals = None

    cache = FemCache(order_difference=0)
    integrals = []
    for ie, idx_leaf in enumerate(leaf_indices):
        o1, o2 = (
            order_vals[ie] if order_vals is not None else mesh.get_leaf_orders(idx_leaf)
        )
        rule_1 = cache.get_integration_rule(int(o1))
        rule_2 = cache.get_integration_rule(int(o2))
        corners = mesh.get_leaf_corners(idx_leaf)
        x, y = physical_coordinates(
            corners, rule_1.nodes[None, :], rule_2.nodes[:, None]
        )
        v = np.asarray(function(x.numpy(), y.numpy()))
        jac = jacobian(corners, rule_1.nodes[None, :], rule_2.nodes[:, None])
        w = (
            jac.det.numpy()
            * rule_1.weights[None, :]
            * rule_2.weights[:, None]
        )
        integrals.append(np.sum(w * v, axis=(0, 1)))
    return np.array(integrals, np.float64)
