"""Inter-/intra-element continuity constraints (Lagrange multiplier rows).

The hybridized formulation keeps all DoFs element-local; continuity of
0-forms (point values) and 1-forms (normal fluxes) across element boundaries
— including hanging nodes from quadtree splits — is enforced by constraint
rows ``G u = b`` appended as a Lagrange-multiplier block.  This module builds
those rows host-side as static index/coefficient maps which the device solver
consumes as one sparse gather/scatter operator.

The constraint *semantics* follow the reference (python/mfv2d/continuity.py):
parent side order = sum of child side orders, child DoFs are mapped through
nodal/edge Vandermonde inverses at the merged GLL nodes, corners of 0-forms
are pinned pointwise, and 1-form rows flip sign with side orientation.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import numpy.typing as npt
from mfv2d_torch.utils.lazy import lazy_module

sp = lazy_module("scipy.sparse")

from mfv2d_torch.boundary import BoundaryCondition2DSteady, mesh_boundary_conditions
from mfv2d_torch.kform import KFormUnknown, UnknownFormOrder
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.mimetic import (
    Constraint,
    ElementConstraint,
    ElementSide,
    element_boundary_dofs,
    element_node_children_on_side,
    find_surface_boundary_id_line,
    get_side_order,
)
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.ops.quadrature import compute_gll, lagrange1d
from mfv2d_torch.system import ElementFormSpecification, KFormSystem


def _get_corner_dof(mesh: Mesh, element: int, side: ElementSide, /) -> tuple[int, int]:
    """Leaf element index + 0-form DoF index of the corner starting ``side``."""
    children = mesh.get_element_children(element)
    if children is None:
        order_1, order_2 = mesh.get_leaf_orders(element)
        if side == ElementSide.SIDE_BOTTOM:
            idx = 0
        elif side == ElementSide.SIDE_RIGHT:
            idx = order_1
        elif side == ElementSide.SIDE_TOP:
            idx = (order_1 + 1) * order_2 + order_1
        elif side == ElementSide.SIDE_LEFT:
            idx = order_2 * (order_1 + 1)
        else:
            raise ValueError(f"Invalid side given by {side=}")
        return (element, idx)
    return _get_corner_dof(mesh, children[side.value - 1], side)


def _edge_integral_table(nodal_table: np.ndarray) -> np.ndarray:
    """Integrals of each edge-basis polynomial between consecutive points.

    Derivation: the mimetic edge basis paired with the nodal basis
    ``l_0..l_p`` has the antiderivative ``-sum_{k < j} l_k`` for edge
    function ``j`` (so its integral over ``[t_{j-1}, t_j]`` is one).  Given
    the table ``nodal_table[i, k] = l_k(x_i)`` at sorted points ``x_i``, the
    integral of edge function ``j`` over ``[x_i, x_{i+1}]`` is therefore
    ``sum_{k < j} (l_k(x_i) - l_k(x_{i+1}))``: a cumulative sum along the
    basis axis followed by a backward difference along the point axis.
    """
    running = np.cumsum(nodal_table[:, :-1], axis=1)
    return running[:-1, :] - running[1:, :]


def _side_strips(mesh: Mesh, element: int, side: ElementSide) -> list[tuple[int, float, float]]:
    """Flatten one (possibly split) element side into leaf strips.

    Returns ``(leaf_element, lo, hi)`` triples ordered along the side's own
    coordinate, where ``[lo, hi]`` is the sub-interval of the root side's
    [-1, 1] coordinate covered by that leaf.  Splitting an element halves
    the interval of the two children that touch the side.
    """
    strips: list[tuple[int, float, float]] = []
    pending = [(element, -1.0, 1.0)]
    while pending:
        elem, lo, hi = pending.pop(0)
        children = mesh.get_element_children(elem)
        if children is None:
            strips.append((elem, lo, hi))
        else:
            first, second = element_node_children_on_side(side, children)
            mid = 0.5 * (lo + hi)
            pending[:0] = [(first, lo, mid), (second, mid, hi)]
    return strips


def _get_side_dofs(
    mesh: Mesh,
    element: int,
    side: ElementSide,
    form_order: UnknownFormOrder,
    output_order: int | None = None,
    /,
) -> tuple[Constraint, ...]:
    """Side-restriction operator: side DoFs as combinations of leaf DoFs.

    A side of a split element has a "virtual" polynomial space of order
    ``q = sum of the leaf side orders``; its DoFs are determined by the leaf
    DoFs through an interpolation system.  With every leaf's GLL nodes
    mapped affinely into the leaf's strip of the side, the merged node set
    has exactly ``q + 1`` points, so:

    - 0-forms: leaf nodal values pin the virtual polynomial pointwise —
      the restriction matrix is the inverse of the nodal Vandermonde
      ``V[i, j] = l_j(x_i)`` at the merged nodes.
    - 1-forms: leaf edge DoFs are integrals of the virtual 1-form between
      consecutive merged nodes — the restriction matrix is the inverse of
      the edge-integral table over those ``q`` sub-intervals.

    When ``output_order`` differs from ``q``, the virtual DoFs are further
    re-expanded at the output order's GLL nodes/intervals, composing the
    evaluation table at the output nodes with the inverse above.
    """
    virtual_order = get_side_order(mesh, element, side)
    if output_order is None:
        output_order = virtual_order

    strips = _side_strips(mesh, element, side)
    if len(strips) == 1 and output_order == virtual_order:
        # Unsplit side, no projection: each side DoF is one leaf DoF.
        indices = element_boundary_dofs(
            side, form_order, *mesh.get_leaf_orders(element)
        )
        return tuple(
            Constraint(
                0.0,
                ElementConstraint(
                    mesh.get_leaf_index(element),
                    np.array([idx], np.uint32),
                    np.ones(1, np.float64),
                ),
            )
            for idx in indices
        )

    if form_order not in (UnknownFormOrder.FORM_ORDER_0, UnknownFormOrder.FORM_ORDER_1):
        raise ValueError("2-forms have no boundary DoFs.")
    is_nodal = form_order == UnknownFormOrder.FORM_ORDER_0

    # Per-strip leaf DoF indices and their node positions on the root side.
    strip_dofs: list[npt.NDArray[np.uint32]] = []
    strip_nodes: list[npt.NDArray[np.float64]] = []
    for rank, (leaf, lo, hi) in enumerate(strips):
        p1, p2 = mesh.get_leaf_orders(leaf)
        p_side = (p1, p2)[(side.value - 1) & 1]
        dof_idx = element_boundary_dofs(side, form_order, p1, p2)
        nodes = lo + 0.5 * (compute_gll(p_side)[0] + 1.0) * (hi - lo)
        if rank > 0:
            # The strip's first node coincides with the previous strip's
            # last; keep one merged breakpoint (and for nodal DoFs let the
            # earlier strip's DoF represent the shared value).
            nodes = nodes[1:]
            if is_nodal:
                dof_idx = dof_idx[1:]
        strip_dofs.append(dof_idx)
        strip_nodes.append(nodes)

    merged_nodes = np.concatenate(strip_nodes)
    virtual_nodes = compute_gll(virtual_order)[0]
    eval_table = lagrange1d(virtual_nodes, merged_nodes)
    if not is_nodal:
        eval_table = _edge_integral_table(eval_table)
    restriction = np.linalg.inv(eval_table)

    if output_order != virtual_order:
        out_table = lagrange1d(virtual_nodes, compute_gll(output_order)[0])
        if not is_nodal:
            out_table = _edge_integral_table(out_table)
        restriction = out_table @ restriction

    # Split each restriction row into per-leaf coefficient slices.
    splits = np.cumsum([d.size for d in strip_dofs])[:-1]
    leaf_ranks = [mesh.get_leaf_index(leaf) for leaf, _, _ in strips]
    return tuple(
        Constraint(
            0.0,
            *(
                ElementConstraint(rank, dof_idx, coeff_slice)
                for rank, dof_idx, coeff_slice in zip(
                    leaf_ranks, strip_dofs, np.split(row, splits)
                )
            ),
        )
        for row in restriction
    )


def connect_corner_based(mesh: Mesh, *pairs: tuple[int, ElementSide]) -> list[Constraint]:
    """0-form point-continuity constraints through a shared corner."""
    constraints: list[Constraint] = []
    e1, s1 = pairs[0]
    l1, d1 = _get_corner_dof(mesh, e1, s1)
    for e2, s2 in pairs[1:]:
        l2, d2 = _get_corner_dof(mesh, e2, s2)
        constraints.append(
            Constraint(
                0.0,
                ElementConstraint(
                    mesh.get_leaf_index(l1),
                    np.array([d1], np.uint32),
                    np.array([+1], np.float64),
                ),
                ElementConstraint(
                    mesh.get_leaf_index(l2),
                    np.array([d2], np.uint32),
                    np.array([-1], np.float64),
                ),
            )
        )
        l1, d1 = l2, d2
    return constraints


def connect_edge_center(mesh: Mesh, e1: int, e2: int, side: ElementSide) -> list[Constraint]:
    """0-form continuity at the shared mid-edge corner of split neighbors."""
    constraints = connect_corner_based(mesh, (e1, side.next), (e2, side))
    c1 = mesh.get_element_children(e1)
    c2 = mesh.get_element_children(e2)
    if c1 is not None:
        c11, c12 = element_node_children_on_side(side, c1)
        constraints += connect_edge_center(mesh, c11, c12, side)
    if c2 is not None:
        c21, c22 = element_node_children_on_side(side, c2)
        constraints += connect_edge_center(mesh, c21, c22, side)
    return constraints


def connect_edge_based(
    mesh: Mesh,
    e1: int,
    s1: ElementSide,
    e2: int,
    s2: ElementSide,
    form_order: UnknownFormOrder,
) -> list[Constraint]:
    """Continuity of 0-/1-form DoFs across the shared edge of two elements."""
    assert form_order in (
        UnknownFormOrder.FORM_ORDER_0,
        UnknownFormOrder.FORM_ORDER_1,
    )
    c1 = mesh.get_element_children(e1)
    c2 = mesh.get_element_children(e2)
    constraints: list[Constraint] = []
    if c1 is not None and c2 is not None:
        # Both split: recurse pairwise (children meet in reverse order).
        c11, c12 = element_node_children_on_side(s1, c1)
        c21, c22 = element_node_children_on_side(s2, c2)
        constraints_1 = connect_edge_based(mesh, c11, s1, c22, s2, form_order)
        constraints_2 = connect_edge_based(mesh, c12, s1, c21, s2, form_order)
        constraints_3: list[Constraint] = []
        if form_order == UnknownFormOrder.FORM_ORDER_0:
            constraints_3 = connect_corner_based(
                mesh,
                (c11, s1.next),
                (c12, s1),
                (c22, s2),
                (c21, s2.next),
            )
        return constraints_1 + constraints_2 + constraints_3

    if form_order == UnknownFormOrder.FORM_ORDER_0:
        # One side split: pin the hanging mid-edge corner chain.
        if c1 is not None:
            c11, c12 = element_node_children_on_side(s1, c1)
            constraints += connect_edge_center(mesh, c11, c12, s1)
        elif c2 is not None:
            c21, c22 = element_node_children_on_side(s2, c2)
            constraints += connect_edge_center(mesh, c21, c22, s2)

    order_1 = get_side_order(mesh, e1, s1)
    order_2 = get_side_order(mesh, e2, s2)
    highest_order = max(order_1, order_2)

    dofs_1 = _get_side_dofs(mesh, e1, s1, form_order, highest_order)
    dofs_2 = _get_side_dofs(mesh, e2, s2, form_order, highest_order)

    if form_order == UnknownFormOrder.FORM_ORDER_0:
        # Corners are handled by corner constraints.
        dofs_1 = dofs_1[1:-1]
        dofs_2 = dofs_2[1:-1]
        sign = -1.0
    else:
        sgn1 = 1 - (s1.value & 2)  # +1 for bottom/left, -1 for right/top
        sgn2 = 1 - (s2.value & 2)
        sign = float(sgn1 * sgn2)

    for d1, d2 in zip(dofs_1, reversed(dofs_2)):
        constraints.append(
            Constraint(
                0.0,
                *d1.element_constraints,
                *(
                    ElementConstraint(dof.i_e, dof.dofs, sign * dof.coeffs)
                    for dof in d2.element_constraints
                ),
            )
        )
    return constraints


def connect_element_inner(
    mesh: Mesh, element: int, form_order: UnknownFormOrder
) -> list[Constraint]:
    """Continuity constraints between the children inside a split element."""
    children = mesh.get_element_children(element)
    if children is None:
        return []
    c_bl, c_br, c_tr, c_tl = children

    child_constraints: list[Constraint] = sum(
        (connect_element_inner(mesh, c, form_order) for c in children), start=[]
    )
    edge_constraints = (
        connect_edge_based(
            mesh, c_bl, ElementSide.SIDE_RIGHT, c_br, ElementSide.SIDE_LEFT, form_order
        )
        + connect_edge_based(
            mesh, c_br, ElementSide.SIDE_TOP, c_tr, ElementSide.SIDE_BOTTOM, form_order
        )
        + connect_edge_based(
            mesh, c_tr, ElementSide.SIDE_LEFT, c_tl, ElementSide.SIDE_RIGHT, form_order
        )
        + connect_edge_based(
            mesh, c_tl, ElementSide.SIDE_BOTTOM, c_bl, ElementSide.SIDE_TOP, form_order
        )
    )
    corner_constraint: list[Constraint] = []
    if form_order == UnknownFormOrder.FORM_ORDER_0:
        corner_constraint = connect_corner_based(
            mesh,
            (c_bl, ElementSide.SIDE_TOP),
            (c_br, ElementSide.SIDE_LEFT),
            (c_tr, ElementSide.SIDE_BOTTOM),
            (c_tl, ElementSide.SIDE_RIGHT),
        )
    return child_constraints + edge_constraints + corner_constraint


BulkConstraints = tuple[
    npt.NDArray[np.intp], npt.NDArray[np.intp], npt.NDArray[np.float64]
]
"""``(leaf_ranks, dofs, coefs)``, each ``[n_rows, entries_per_row]``; every
row is one zero-RHS constraint over in-element DoF indices."""

# Test hook: force every edge/corner through the general per-row path so the
# bulk fast path can be cross-checked against it.
_DISABLE_BULK = False


def _bulk_conforming_edges(
    mesh: Mesh,
    groups: dict,
    form_order: UnknownFormOrder,
) -> list[BulkConstraints]:
    """Vectorized continuity rows for conforming equal-order leaf pairs.

    ``groups`` maps ``(side_1, side_2, orders_1, orders_2)`` to the list of
    ``(leaf_rank_1, leaf_rank_2)`` pairs sharing that geometry.  Each row
    pairs one side DoF of element 1 (+1) with the mirrored side DoF of
    element 2 (sign per the 1-form orientation rule / -1 for 0-forms) —
    identical semantics to the per-edge path, built in bulk.
    """
    out: list[BulkConstraints] = []
    for (side_1, side_2, o1, o2), pairs in groups.items():
        d1 = element_boundary_dofs(side_1, form_order, *o1)
        d2 = element_boundary_dofs(side_2, form_order, *o2)
        if form_order == UnknownFormOrder.FORM_ORDER_0:
            # Corners are handled by corner constraints.
            d1 = d1[1:-1]
            d2 = d2[1:-1][::-1]
            sign = -1.0
        else:
            d2 = d2[::-1]
            sgn1 = 1 - (side_1.value & 2)
            sgn2 = 1 - (side_2.value & 2)
            sign = float(sgn1 * sgn2)
        r = d1.size
        if r == 0:
            continue
        pairs_arr = np.asarray(pairs, np.intp)  # [E, 2]
        e = pairs_arr.shape[0]
        leaf_ranks = np.repeat(pairs_arr, r, axis=0)  # [E*r, 2]
        dofs = np.empty((e * r, 2), np.intp)
        dofs[:, 0] = np.tile(d1.astype(np.intp), e)
        dofs[:, 1] = np.tile(d2.astype(np.intp), e)
        coefs = np.broadcast_to(np.array([1.0, sign]), (e * r, 2)).copy()
        out.append((leaf_ranks, dofs, coefs))
    return out


def connect_elements(
    form_specs: ElementFormSpecification, mesh: Mesh
) -> tuple[list[Constraint], list[BulkConstraints]]:
    """All continuity constraints for all forms over the whole mesh.

    Returns per-row ``Constraint`` objects for the general cases (splits,
    hanging nodes, mixed side orders) plus vectorized ``BulkConstraints``
    blocks for the conforming equal-order edges — at production mesh sizes
    the per-edge Python path dominated assembly wall time (measured 1.9 s
    of a 5.3 s 64x64 p=4 solve).
    """
    has_0 = any(o == UnknownFormOrder.FORM_ORDER_0 for o in form_specs.orders)
    has_1 = any(o == UnknownFormOrder.FORM_ORDER_1 for o in form_specs.orders)

    intra_0: list[Constraint] = []
    intra_1: list[Constraint] = []
    for surf_index in range(mesh.primal.n_surfaces):
        if has_0:
            intra_0 += connect_element_inner(
                mesh, surf_index, UnknownFormOrder.FORM_ORDER_0
            )
        if has_1:
            intra_1 += connect_element_inner(
                mesh, surf_index, UnknownFormOrder.FORM_ORDER_1
            )

    inter_0: list[Constraint] = []
    inter_1: list[Constraint] = []
    conforming_groups: dict = {}
    for edge_index in range(mesh.primal.n_lines):
        dual_line = mesh.dual.get_line(edge_index + 1)
        idx1 = dual_line.begin
        idx2 = dual_line.end
        if not idx1 or not idx2:
            continue  # boundary line: left to BCs
        surf_1 = mesh.primal.get_surface(idx1)
        surf_2 = mesh.primal.get_surface(idx2)
        side_1 = find_surface_boundary_id_line(surf_1, edge_index)
        side_2 = find_surface_boundary_id_line(surf_2, edge_index)
        e1, e2 = idx1.index, idx2.index
        if (
            not _DISABLE_BULK
            and mesh.get_element_children(e1) is None
            and mesh.get_element_children(e2) is None
        ):
            o1 = mesh.get_leaf_orders(e1)
            o2 = mesh.get_leaf_orders(e2)
            if o1[(side_1.value - 1) & 1] == o2[(side_2.value - 1) & 1]:
                conforming_groups.setdefault(
                    (side_1, side_2, tuple(o1), tuple(o2)), []
                ).append((mesh.get_leaf_index(e1), mesh.get_leaf_index(e2)))
                continue
        if has_0:
            inter_0 += connect_edge_based(
                mesh, e1, side_1, e2, side_2, UnknownFormOrder.FORM_ORDER_0
            )
        if has_1:
            inter_1 += connect_edge_based(
                mesh, e1, side_1, e2, side_2, UnknownFormOrder.FORM_ORDER_1
            )

    bulk_0 = (
        _bulk_conforming_edges(mesh, conforming_groups, UnknownFormOrder.FORM_ORDER_0)
        if has_0
        else []
    )
    bulk_1 = (
        _bulk_conforming_edges(mesh, conforming_groups, UnknownFormOrder.FORM_ORDER_1)
        if has_1
        else []
    )

    inter_corner_0: list[Constraint] = []
    bulk_corner: list[BulkConstraints] = []
    if has_0:
        # One pass over root surfaces replaces the per-(node, element) side
        # search of _find_surface_boundary_id_node, and the corner chains
        # emit as one bulk (+1, -1) block instead of per-row Constraint
        # objects (the per-node Python path dominated 0-form constraint
        # generation at production mesh sizes).
        side_of: dict[tuple[int, int], ElementSide] = {}
        for e in range(mesh.primal.n_surfaces):
            s = mesh.primal.get_surface(e + 1)
            for line_id, side in zip(iter(s), ElementSide):
                line = mesh.primal.get_line(line_id)
                side_of[(e, line.begin.index)] = side
        chain_ranks: list[tuple[int, int]] = []
        chain_dofs: list[tuple[int, int]] = []
        for node_index in range(mesh.primal.n_points):
            dual_surf = mesh.dual.get_surface(node_index + 1)
            element_indices: list[int] = []
            for dual_line_id in iter(dual_surf):
                dual_line = mesh.dual.get_line(dual_line_id)
                e_idx = dual_line.begin
                if not e_idx:
                    continue
                element_indices.append(e_idx.index)
            if len(element_indices) <= 1:
                continue
            if _DISABLE_BULK:
                inter_corner_0 += connect_corner_based(
                    mesh,
                    *((ie, side_of[(ie, node_index)]) for ie in element_indices),
                )
                continue
            prev = None
            for ie in element_indices:
                leaf, dof = _get_corner_dof(mesh, ie, side_of[(ie, node_index)])
                cur = (mesh.get_leaf_index(leaf), dof)
                if prev is not None:
                    chain_ranks.append((prev[0], cur[0]))
                    chain_dofs.append((prev[1], cur[1]))
                prev = cur
        if chain_ranks:
            r = len(chain_ranks)
            bulk_corner.append(
                (
                    np.asarray(chain_ranks, np.intp),
                    np.asarray(chain_dofs, np.intp),
                    np.broadcast_to(np.array([1.0, -1.0]), (r, 2)).copy(),
                )
            )

    bulk_0 = bulk_0 + bulk_corner
    combined_0 = intra_0 + inter_0 + inter_corner_0
    combined_1 = intra_1 + inter_1

    # Per-leaf-rank form DoF offsets, for vectorized bulk-block shifting.
    leaf_orders = np.array(
        [mesh.get_leaf_orders(li) for li in mesh.get_leaf_indices()], np.intp
    )

    def _form_offsets_per_leaf(i_form: int) -> npt.NDArray[np.intp]:
        uniq, inverse = np.unique(leaf_orders, axis=0, return_inverse=True)
        offsets = np.array(
            [form_specs.form_offset(i_form, *o) for o in uniq], np.intp
        )
        return offsets[inverse]

    real_constraints: list[Constraint] = []
    real_bulk: list[BulkConstraints] = []
    for i_form, form in enumerate(form_specs.orders):
        if form == UnknownFormOrder.FORM_ORDER_0:
            base = combined_0
            bulk = bulk_0
        elif form == UnknownFormOrder.FORM_ORDER_1:
            base = combined_1
            bulk = bulk_1
        else:
            continue
        if i_form != 0:
            real_constraints += [
                Constraint(
                    0.0,
                    *(
                        ElementConstraint(
                            ec.i_e,
                            ec.dofs
                            + form_specs.form_offset(
                                i_form,
                                *mesh.get_leaf_orders(mesh.find_leaf_by_index(ec.i_e)),
                            ),
                            ec.coeffs,
                        )
                        for ec in constraint.element_constraints
                    ),
                )
                for constraint in base
            ]
            shift = _form_offsets_per_leaf(i_form)
            real_bulk += [
                (leaf_ranks, dofs + shift[leaf_ranks], coefs)
                for leaf_ranks, dofs, coefs in bulk
            ]
        else:
            real_constraints += base
            real_bulk += bulk
    return real_constraints, real_bulk


def add_system_constraints(
    system: KFormSystem,
    mesh: Mesh,
    basis_cache: FemCache,
    constrained_forms: Sequence[tuple[float, KFormUnknown]],
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
    leaf_indices: Sequence[int],
    element_offset: npt.NDArray[np.uint32],
    linear_vectors: Sequence[npt.NDArray[np.float64]] | None,
) -> tuple[sp.csr_array | None, npt.NDArray[np.float64]]:
    """Assemble all constraints into a CSR matrix + RHS values.

    Also adds weak-BC boundary integrals into ``linear_vectors`` in place
    (reference continuity.py:762-873).
    """
    form_specs = system.unknown_forms
    constrained_form_constraints: dict[KFormUnknown, Constraint] = {}
    for k, form in constrained_forms:
        i_unknown = form_specs.index(form)
        constrained_form_constraints[form] = Constraint(
            k,
            *(
                ElementConstraint(
                    i,
                    form_specs.form_offset(i_unknown, *orders)
                    + np.arange(
                        form_specs.form_size(i_unknown, *orders), dtype=np.uint32
                    ),
                    np.ones(form_specs.form_size(i_unknown, *orders)),
                )
                for (i, orders) in (
                    (i, mesh.get_leaf_orders(leaf_idx))
                    for i, leaf_idx in enumerate(leaf_indices)
                )
            ),
        )

    if boundary_conditions is None:
        boundary_conditions = []

    strong_bcs, weak_bcs = mesh_boundary_conditions(
        [eq.right for eq in system.equations],
        form_specs,
        mesh,
        [
            [bc for bc in boundary_conditions if bc.form == eq.weight.base_form]
            for eq in system.equations
        ],
        basis_cache,
    )

    continuity_constraints, continuity_bulk = connect_elements(form_specs, mesh)

    rows: list[npt.NDArray[np.intp]] = []
    cols: list[npt.NDArray[np.intp]] = []
    coefs: list[npt.NDArray[np.float64]] = []
    vals: list[float] = []
    ic = 0
    offsets_intp = np.asarray(element_offset, np.intp)
    for leaf_ranks, dofs_b, coefs_b in continuity_bulk:
        r, k = dofs_b.shape
        cols.append((offsets_intp[leaf_ranks] + dofs_b).ravel())
        rows.append(np.repeat(np.arange(ic, ic + r, dtype=np.intp), k))
        coefs.append(coefs_b.ravel())
        vals.extend([0.0] * r)
        ic += r
    for constraint in continuity_constraints:
        vals.append(constraint.rhs)
        for ec in constraint.element_constraints:
            offset = int(element_offset[ec.i_e])
            cols.append(np.asarray(ec.dofs, np.intp) + offset)
            rows.append(np.full(ec.dofs.size, ic, np.intp))
            coefs.append(np.asarray(ec.coeffs, np.float64))
        ic += 1

    for constraint in constrained_form_constraints.values():
        vals.append(constraint.rhs)
        for ec in constraint.element_constraints:
            offset = int(element_offset[ec.i_e])
            cols.append(np.asarray(ec.dofs, np.intp) + offset)
            rows.append(np.full(ec.dofs.size, ic, np.intp))
            coefs.append(np.asarray(ec.coeffs, np.float64))
        ic += 1

    for ec in strong_bcs:
        offset = int(element_offset[ec.i_e])
        for ci, cv in zip(ec.dofs, ec.coeffs):
            rows.append(np.array([ic], np.intp))
            cols.append(np.array([int(ci) + offset], np.intp))
            coefs.append(np.array([1.0]))
            vals.append(float(cv))
            ic += 1

    if linear_vectors is not None:
        for ec in weak_bcs:
            linear_vectors[ec.i_e][ec.dofs] += ec.coeffs

    if coefs:
        lagrange_mat = sp.csr_array(
            (
                np.concatenate(coefs),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(ic, int(element_offset[-1])),
        )
        lagrange_vec = np.array(vals, np.float64)
    else:
        lagrange_mat = None
        lagrange_vec = np.zeros(0, np.float64)
    return lagrange_mat, lagrange_vec
