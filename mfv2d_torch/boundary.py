"""Boundary conditions: strong (constraint rows) and weak (RHS integrals).

Semantics follow the reference (python/mfv2d/boundary.py): weak BCs add
boundary integrals of ``KBoundaryProjection`` terms to element RHS entries
(tangential integral for 0-forms, normal flux for 1-forms); strong BCs emit
per-DoF constraint rows with nodal values (0-forms) or edge-integrated normal
fluxes (1-forms), skipping already-constrained shared corners.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import numpy.typing as npt

from mfv2d_torch.kform import (
    Function2D,
    KBoundaryProjection,
    KFormUnknown,
    KSum,
    UnknownFormOrder,
)
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.mimetic import (
    ElementConstraint,
    ElementSide,
    element_boundary_dofs,
    element_node_children_on_side,
    find_surface_boundary_id_line,
    get_side_order,
)
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.system import ElementFormSpecification


@dataclass(frozen=True, init=False)
class BoundaryCondition2D:
    """Base class: a form plus boundary-line indices it applies to."""

    form: KFormUnknown
    indices: npt.NDArray[np.uint64]

    def __init__(self, form: KFormUnknown, indices) -> None:
        object.__setattr__(self, "form", form)
        idx = np.array(indices, np.uint64)
        if idx.ndim != 1:
            raise ValueError("Indices array is not a 1D array.")
        object.__setattr__(self, "indices", np.unique(idx))


@dataclass(frozen=True, init=False)
class BoundaryCondition2DSteady(BoundaryCondition2D):
    """Strong Dirichlet-type condition prescribing form values on edges."""

    func: Function2D

    def __init__(self, form: KFormUnknown, indices, func: Function2D) -> None:
        super().__init__(form, indices)
        object.__setattr__(self, "func", func)


@dataclass(frozen=True, init=False)
class BoundaryCondition2DUnsteady(BoundaryCondition2D):
    """Strong condition with a time-dependent value ``func(x, y, t)``.

    The reference defines this type but never evaluates it
    (python/mfv2d/boundary.py); here the time march re-evaluates the
    prescribed values at each new time level ``t = (n + 1) dt``.
    """

    func: Function2D

    def __init__(self, form: KFormUnknown, indices, func) -> None:
        super().__init__(form, indices)
        object.__setattr__(self, "func", func)


def freeze_unsteady_boundary_conditions(
    boundary_conditions: Sequence[BoundaryCondition2D], t: float
) -> list[BoundaryCondition2DSteady]:
    """Bind unsteady conditions to time ``t``; steady ones pass through."""
    out: list[BoundaryCondition2DSteady] = []
    for bc in boundary_conditions:
        if isinstance(bc, BoundaryCondition2DUnsteady):
            out.append(
                BoundaryCondition2DSteady(
                    bc.form,
                    bc.indices,
                    lambda x, y, _f=bc.func, _t=t: _f(x, y, _t),
                )
            )
        else:
            out.append(bc)
    return out


def _element_weak_boundary_condition(
    mesh: Mesh,
    element_idx: int,
    side: ElementSide,
    form_specs: ElementFormSpecification,
    unknown_index: int,
    weak_terms: Sequence[tuple[float, KBoundaryProjection]],
    basis_cache: FemCache,
) -> tuple[ElementConstraint, ...]:
    """RHS contributions of weak boundary terms on one element side."""
    children = mesh.get_element_children(element_idx)
    if children is not None:
        c1, c2 = element_node_children_on_side(side, children)
        return _element_weak_boundary_condition(
            mesh, c1, side, form_specs, unknown_index, weak_terms, basis_cache
        ) + _element_weak_boundary_condition(
            mesh, c2, side, form_specs, unknown_index, weak_terms, basis_cache
        )

    side_order = get_side_order(mesh, element_idx, side)
    basis_1d = basis_cache.get_basis1d(side_order)
    ndir = 2 * ((side.value & 2) >> 1) - 1
    i0 = side.value - 1
    i1 = side.value & 3
    corners = mesh.get_leaf_corners(element_idx)
    p0 = corners[i0]
    p1 = corners[i1]
    dx = (p1[0] - p0[0]) / 2
    dy = (p1[1] - p0[1]) / 2
    xv = (p1[0] + p0[0]) / 2 + dx * basis_1d.rule.nodes
    yv = (p1[1] + p0[1]) / 2 + dy * basis_1d.rule.nodes
    _, form_order = form_specs[unknown_index]
    element_orders = mesh.get_leaf_orders(element_idx)
    dofs = element_boundary_dofs(side, form_order, *element_orders)
    dofs = dofs + form_specs.form_offset(unknown_index, *element_orders)
    vals = np.zeros_like(dofs, np.float64)

    for k, bp in weak_terms:
        func = bp.func
        assert func is not None
        f_vals = np.asarray(func(xv, yv), np.float64)
        if form_order == UnknownFormOrder.FORM_ORDER_0:
            # Tangential integral against the nodal basis.
            basis = basis_1d.node
            f_vals = -(f_vals[..., 0] * dx + f_vals[..., 1] * dy) * basis_1d.rule.weights
        elif form_order == UnknownFormOrder.FORM_ORDER_1:
            # Normal-direction integral against the edge basis.
            basis = basis_1d.edge
            f_vals = f_vals * (-basis_1d.rule.weights * ndir)
        else:
            raise ValueError(f"Unknown/invalid weak form order {form_order=}.")
        vals[:] += np.sum(f_vals[None, ...] * basis, axis=1) * k

    return (ElementConstraint(mesh.get_leaf_index(element_idx), dofs, vals),)


def _element_strong_boundary_condition(
    mesh: Mesh,
    element_idx: int,
    side: ElementSide,
    form_specs: ElementFormSpecification,
    unknown_index: int,
    strong_bc: BoundaryCondition2DSteady,
    basis_cache: FemCache,
    skip_first: bool,
    skip_last: bool,
) -> tuple[ElementConstraint, ...]:
    """Per-DoF prescriptions of a strong boundary condition on one side."""
    children = mesh.get_element_children(element_idx)
    if children is not None:
        c1, c2 = element_node_children_on_side(side, children)
        return _element_strong_boundary_condition(
            mesh, c1, side, form_specs, unknown_index, strong_bc, basis_cache,
            skip_first, False,
        ) + _element_strong_boundary_condition(
            mesh, c2, side, form_specs, unknown_index, strong_bc, basis_cache,
            False, skip_last,
        )

    side_order = get_side_order(mesh, element_idx, side)
    basis_1d = basis_cache.get_basis1d(side_order)
    ndir = 2 * ((side.value & 2) >> 1) - 1
    i0 = side.value - 1
    i1 = side.value & 3
    corners = mesh.get_leaf_corners(element_idx)
    p0 = corners[i0]
    p1 = corners[i1]
    dx = (p1[0] - p0[0]) / 2
    dy = (p1[1] - p0[1]) / 2
    xv = (p1[0] + p0[0]) / 2 + dx * basis_1d.roots
    yv = (p1[1] + p0[1]) / 2 + dy * basis_1d.roots
    _, form_order = form_specs[unknown_index]
    element_orders = mesh.get_leaf_orders(element_idx)
    dofs = element_boundary_dofs(side, form_order, *element_orders)
    dofs = dofs + form_specs.form_offset(unknown_index, *element_orders)
    vals = np.zeros_like(dofs, np.float64)

    if form_order == UnknownFormOrder.FORM_ORDER_0:
        vals[:] = strong_bc.func(xv, yv)
        if skip_first:
            vals = vals[1:]
            dofs = dofs[1:]
        if skip_last:
            vals = vals[:-1]
            dofs = dofs[:-1]
        if len(vals) == 0:
            return tuple()
    elif form_order == UnknownFormOrder.FORM_ORDER_1:
        # Edge DoF value = integral of the normal flux over the sub-edge.
        lnds = basis_1d.rule.nodes
        wnds = basis_1d.rule.weights
        for i in range(side_order):
            xc = (xv[i + 1] + xv[i]) / 2 + (xv[i + 1] - xv[i]) / 2 * lnds
            yc = (yv[i + 1] + yv[i]) / 2 + (yv[i + 1] - yv[i]) / 2 * lnds
            ddx = (xv[i + 1] - xv[i]) / 2
            ddy = (yv[i + 1] - yv[i]) / 2
            normal = ndir * np.array((ddy, -ddx))
            fvals = np.asarray(strong_bc.func(xc, yc), np.float64)
            fvals = fvals[..., 0] * normal[0] + fvals[..., 1] * normal[1]
            vals[i] = np.sum(fvals * wnds)
    else:
        raise AssertionError

    assert vals.size == dofs.size
    return (ElementConstraint(mesh.get_leaf_index(element_idx), dofs, vals),)


def mesh_boundary_conditions(
    evaluatable_terms: Sequence[KSum],
    form_specs: ElementFormSpecification,
    mesh: Mesh,
    strong_bcs: Sequence[Sequence[BoundaryCondition2DSteady]],
    basis_cache: FemCache,
) -> tuple[tuple[ElementConstraint, ...], tuple[ElementConstraint, ...]]:
    """Walk the mesh boundary choosing strong vs weak handling per equation.

    Returns (strong constraints with prescribed values, weak RHS additions).
    """
    w_bcs: list[ElementConstraint] = []
    s_bcs: list[ElementConstraint] = []
    projections = [
        [
            (k, v)
            for k, v in weak_term.pairs
            if (type(v) is KBoundaryProjection and v.func is not None)
        ]
        for weak_term in evaluatable_terms
    ]
    # Corner dedup must be tracked per equation (per constrained form):
    # with one shared set, the second form with strong BCs on lines meeting
    # at a node would silently lose its corner constraint row.
    set_nodes: dict[int, set[int]] = {}

    for i_boundary in mesh.boundary_indices:
        i_boundary = int(i_boundary)
        dual_line = mesh.dual.get_line(i_boundary + 1)
        if dual_line.begin:
            id_surf = dual_line.begin
        elif dual_line.end:
            id_surf = dual_line.end
        else:
            raise ValueError("Dual line should be on the boundary.")

        primal_surface = mesh.primal.get_surface(id_surf)
        i_side = find_surface_boundary_id_line(primal_surface, i_boundary)
        primal_line = mesh.primal.get_line(primal_surface[i_side.value - 1])
        for idx, (weak_term, strong_terms) in enumerate(zip(projections, strong_bcs)):
            strong_term = None
            for strong in strong_terms:
                if i_boundary in strong.indices:
                    strong_term = strong
                    break
            if strong_term is not None:
                p0 = primal_line.begin.index
                p1 = primal_line.end.index
                seen = set_nodes.setdefault(idx, set())
                s_bcs.extend(
                    _element_strong_boundary_condition(
                        mesh,
                        id_surf.index,
                        i_side,
                        form_specs,
                        idx,
                        strong_term,
                        basis_cache,
                        p0 in seen,
                        p1 in seen,
                    )
                )
                seen |= {p0, p1}
            elif len(weak_term):
                w_bcs.extend(
                    _element_weak_boundary_condition(
                        mesh,
                        id_surf.index,
                        i_side,
                        form_specs,
                        idx,
                        weak_term,
                        basis_cache,
                    )
                )
    return tuple(s_bcs), tuple(w_bcs)
