"""hp-adaptive refinement: error estimators and the refinement loop.

Five estimators matching the reference (python/mfv2d/refinement.py): custom
user function, explicit (against a known solution), L2 order reduction,
local inverse (element-local fine-space residual solves) and a fine solve of
the whole problem.  Error spectra are measured in a Legendre basis;
h-refinement cost comes from the high-mode energy quadrants.

The projections, fine element systems and local solves run batched over
order buckets on the device of the coarse discretization; reconstruction
and the Legendre measures are NumPy on the host.  The VMS estimator
(``ErrorEstimateVMS``) builds its element matrices and projectors on that
device too and solves its two Green's saddles by host SuperLU, as the
reference does.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import Literal, Protocol

import numpy as np
import numpy.typing as npt
import torch

from mfv2d_torch.boundary import (
    BoundaryCondition2DSteady,
    _element_weak_boundary_condition,
)
from mfv2d_torch.compiler import CompiledSystem
from mfv2d_torch.evaluation import (
    ElementBatch,
    compute_element_matrices,
    compute_element_vectors,
    element_projector,
    evaluate_static_fields,
    project_between,
    projection_roundtrip_error,
)
from mfv2d_torch.kform import Function2D, KBoundaryProjection, KFormUnknown
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.mimetic import (
    ElementSide,
    element_boundary_dofs,
    find_surface_boundary_id_line,
)
from mfv2d_torch.ops.quadrature import compute_legendre
from mfv2d_torch.progress import HistogramFormat
from mfv2d_torch.projection import (
    _jacobian_np,
    _physical_coordinates_np,
    reconstruct_batched,
)
from mfv2d_torch.solver.discretization import Discretization, per_leaf
from mfv2d_torch.solver.solve import SystemEvaluator, compute_element_rhs_bucket
from mfv2d_torch.system import ElementFormSpecification, KFormSystem
from mfv2d_torch.utils.lazy import lazy_module

sp = lazy_module("scipy.sparse")
sla = lazy_module("scipy.sparse.linalg")


def _mode_norms(order_1: int, order_2: int) -> npt.NDArray[np.float64]:
    """L2 norms squared of the Legendre products: ||P_m P_n||^2 on [-1,1]^2."""
    per_mode_xi = 2.0 / (2.0 * np.arange(order_1 + 1) + 1.0)
    per_mode_eta = 2.0 / (2.0 * np.arange(order_2 + 1) + 1.0)
    return np.outer(per_mode_eta, per_mode_xi)


def compute_legendre_coefficients(
    order_1: int,
    order_2: int,
    nodes_xi: npt.NDArray[np.float64],
    nodes_eta: npt.NDArray[np.float64],
    weighted_function: npt.NDArray[np.float64],
    det: npt.NDArray[np.float64],
) -> npt.NDArray[np.float64]:
    """Legendre-spectrum coefficients of a function sampled at quadrature nodes.

    ``weighted_function`` carries function * quadrature weight * Jacobian
    determinant on an (eta, xi) grid; one 1/sqrt(det) factor converts the
    metric-weighted samples to the density the spectrum is taken of (the
    reference's convention, refinement.py:40-85).  The projection is two
    small GEMMs, ``moments = P_eta @ samples @ P_xi^T`` with
    ``P[k, i] = P_k(node_i)``, then each mode is divided by its basis norm.
    """
    samples = np.asarray(weighted_function) / np.sqrt(det)
    table_xi = compute_legendre(order_1, np.ravel(nodes_xi))
    table_eta = compute_legendre(order_2, np.ravel(nodes_eta))
    moments = table_eta @ samples @ table_xi.T
    return moments / _mode_norms(order_1, order_2)


def compute_legendre_error_estimates(
    order_1: int,
    order_2: int,
    xi: npt.NDArray[np.float64],
    eta: npt.NDArray[np.float64],
    w: npt.NDArray[np.float64],
    det: npt.NDArray[np.float64],
    u: npt.NDArray[np.float64],
    err: npt.NDArray[np.float64],
) -> tuple[float, float]:
    """(L2 error^2, h-refinement cost) from Legendre spectra.

    The h cost is the spectral energy the element's upper mode bands hold
    in the improved solution ``u + err``: per mode, the energy difference
    ``|c_{u+e}|^2 - |c_e|^2``, summed over every mode outside the low/low
    quadrant (reference refinement.py:88-152).
    """
    assert err.shape == u.shape
    if err.ndim == 3:
        # Vector-valued forms: estimate on the Euclidean magnitude.
        err = np.linalg.norm(err, axis=-1)
        u = np.linalg.norm(u, axis=-1)
    wdet = w * det
    spec_better = compute_legendre_coefficients(
        order_1, order_2, xi, eta, (u + err) * wdet, det
    )
    spec_err = compute_legendre_coefficients(order_1, order_2, xi, eta, err * wdet, det)
    energy = (spec_better**2 - spec_err**2) * _mode_norms(order_1, order_2)
    low_low = np.zeros(energy.shape, dtype=bool)
    low_low[: order_2 // 2, : order_1 // 2] = True
    h_cost = abs(float(np.sum(energy[~low_low])))
    return float(np.sum(err**2 * wdet)), h_cost


def compute_legendre_directional_costs(
    order_1: int,
    order_2: int,
    xi: npt.NDArray[np.float64],
    eta: npt.NDArray[np.float64],
    w: npt.NDArray[np.float64],
    det: npt.NDArray[np.float64],
    err: npt.NDArray[np.float64],
) -> tuple[float, float]:
    """Directional error content: energy in the high-xi vs high-eta modes,
    which says which direction's order limits the approximation
    (anisotropic p refinement)."""
    if err.ndim == 3:
        err = np.linalg.norm(err, axis=-1)
    spec = compute_legendre_coefficients(order_1, order_2, xi, eta, err * w * det, det)
    energy = spec**2 * _mode_norms(order_1, order_2)
    p1_cost = float(np.sum(energy[:, max(order_1 // 2, 1) :]))
    p2_cost = float(np.sum(energy[max(order_2 // 2, 1) :, :]))
    return p1_cost, p2_cost


class ErrorCalculationFunction(Protocol):
    """User error function: (x, y, w, **form values) -> (error, h_cost)."""

    def __call__(self, x, y, w, **kwargs) -> tuple[float, float]: ...


@dataclass(frozen=True)
class RefinementLimitUnknownCount:
    """Stop when the DoF count has grown by a fraction or absolute amount."""

    maximum_fraction: float
    maximum_count: int


@dataclass(frozen=True)
class RefinementLimitElementCount:
    """Stop after refining a fraction/number of elements."""

    maximum_fraction: float
    maximum_count: int


@dataclass(frozen=True)
class RefinementLimitErrorValue:
    """Refine elements until their error falls below a threshold."""

    minimum_fraction: float
    minimum_value: float


RefinementLimit = (
    RefinementLimitUnknownCount | RefinementLimitElementCount | RefinementLimitErrorValue
)


@dataclass(frozen=True)
class ErrorEstimateCustom:
    """User-supplied error estimator."""

    required_forms: Sequence[KFormUnknown]
    error_calculation_function: ErrorCalculationFunction
    reconstruction_orders: tuple[int, int] | None = None


@dataclass(frozen=True)
class ErrorEstimateLocalInverse:
    """Element-local solve of the fine-space residual."""

    target_form: KFormUnknown
    order_increase: int
    strong_forms: Sequence[KFormUnknown] = tuple()


@dataclass(frozen=True)
class ErrorEstimateL2OrderReduction:
    """Project solution down and back up; the difference estimates error."""

    target_form: KFormUnknown
    order_drop: int
    alternative: Literal["ignore", "prioritize"] = "prioritize"


@dataclass(frozen=True)
class ErrorEstimateExplicit:
    """Compare against a user-provided estimate of the exact solution."""

    target_form: KFormUnknown
    solution_estimate: Function2D
    reconstruction_orders: tuple[int, int] | None = None


@dataclass(frozen=True)
class ErrorEstimateFineSolve:
    """Fine-solve projection estimator.

    Re-solve the same problem on the same topology with every element's
    orders raised by ``order_increase`` and take the fine solution as the
    exact one.  Both meshes share topology, so each fine element has the
    same corners and reference coordinates as its coarse counterpart and
    the fine solution is reconstructed directly at the coarse estimator's
    quadrature points.
    """

    target_form: KFormUnknown
    order_increase: int = 1
    max_iterations: int = 20
    tolerance: float = 1e-10


@dataclass(frozen=True)
class ErrorEstimateVMS:
    """Variational multi-scale fine-scale error estimation."""

    target_form: KFormUnknown
    symmetric_system: KFormSystem
    nonsymmetric_system: KFormSystem
    order_increase: int
    max_iters: int
    atol: float
    rtol: float


ErrorEstimate = (
    ErrorEstimateCustom
    | ErrorEstimateLocalInverse
    | ErrorEstimateL2OrderReduction
    | ErrorEstimateExplicit
    | ErrorEstimateFineSolve
    | ErrorEstimateVMS
)


@dataclass(frozen=True)
class RefinementSettings:
    """hp-refinement settings (reference refinement.py:365-388)."""

    error_estimate: ErrorEstimate
    refinement_limit: RefinementLimit
    h_refinement_ratio: float = 0.0
    report_error_distribution: bool = False
    report_order_distribution: bool = False
    upper_order_limit: int | None = None
    lower_order_limit: int | None = None
    anisotropic_p: bool = False
    """Raise only the direction(s) whose high-mode error energy dominates
    (directional Legendre spectrum); an extension beyond the reference."""


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def error_estimate_with_custom_estimator(
    disc: Discretization,
    solution: np.ndarray,
    required_unknowns: Sequence[KFormUnknown],
    error_calculation_function,
    recon_order_1: int | None,
    recon_order_2: int | None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-element error via a user function of reconstructed form values.

    Reconstruction, coordinates and quadrature weights are batched per
    order bucket; only the (scalar-returning) user callable runs per leaf.
    """
    form_specs = disc.form_spec
    required = [form_specs.index(u) for u in required_unknowns]
    element_error = np.empty(disc.n_leaves)
    href_cost = np.empty(disc.n_leaves)
    dir_cost = np.ones((disc.n_leaves, 2))
    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        basis = disc.basis_cache.get_basis2d(p1, p2)
        rule_1 = disc.basis_cache.get_integration_rule(
            recon_order_1 if recon_order_1 is not None else p1
        )
        rule_2 = disc.basis_cache.get_integration_rule(
            recon_order_2 if recon_order_2 is not None else p2
        )
        nodes_xi = rule_1.nodes[None, :]
        nodes_eta = rule_2.nodes[:, None]
        corners = bucket.batch.corners_np
        dofs = solution[bucket.gather]
        x, y = _physical_coordinates_np(corners, nodes_xi, nodes_eta)
        batch_form_vals = {}
        for idx in required:
            label, order = form_specs[idx]
            off = form_specs.form_offset(idx, p1, p2)
            size = form_specs.form_size(idx, p1, p2)
            batch_form_vals[label] = reconstruct_batched(
                corners, basis, order, dofs[:, off : off + size], nodes_xi, nodes_eta
            )
        det = _jacobian_np(corners, nodes_xi, nodes_eta)[4]
        w_all = det * (rule_1.weights[None, :] * rule_2.weights[:, None])[None]
        for j, rank in enumerate(bucket.leaf_ranks):
            vals = error_calculation_function(
                x=x[j],
                y=y[j],
                w=w_all[j],
                order_1=p1,
                order_2=p2,
                xi=np.asarray(nodes_xi, np.float64),
                eta=np.asarray(nodes_eta, np.float64),
                **{k: v[j] for k, v in batch_form_vals.items()},
            )
            if vals[0] < 0:
                raise ValueError(
                    "Error calculation function returned a negative error estimate."
                )
            element_error[rank], href_cost[rank] = vals
    return element_error, href_cost, dir_cost


def _batched_legendre_measures(
    order_1: int,
    order_2: int,
    nodes_xi: npt.NDArray[np.float64],
    nodes_eta: npt.NDArray[np.float64],
    w2d: npt.NDArray[np.float64],
    det: npt.NDArray[np.float64],
    u: npt.NDArray[np.float64],
    err: npt.NDArray[np.float64],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched (L2 err^2, h cost, directional costs) over an element bucket:
    :func:`compute_legendre_error_estimates` and
    :func:`compute_legendre_directional_costs` over a leading ``[E]`` axis."""
    if err.ndim == 4:
        err = np.linalg.norm(err, axis=-1)
        u = np.linalg.norm(u, axis=-1)
    wdet = w2d[None] * det
    table_xi = compute_legendre(order_1, np.ravel(nodes_xi))
    table_eta = compute_legendre(order_2, np.ravel(nodes_eta))
    norms = _mode_norms(order_1, order_2)
    sqdet = np.sqrt(det)

    def spectrum(f):
        return np.einsum("ay,eyx,bx->eab", table_eta, f / sqdet, table_xi) / norms

    spec_better = spectrum((u + err) * wdet)
    spec_err = spectrum(err * wdet)
    energy = (spec_better**2 - spec_err**2) * norms
    low_low = np.zeros(energy.shape[1:], dtype=bool)
    low_low[: order_2 // 2, : order_1 // 2] = True
    h_cost = np.abs(np.sum(energy[:, ~low_low], axis=1))
    l2_sq = np.sum(err**2 * wdet, axis=(1, 2))

    err_energy = spec_err**2 * norms
    p1_cost = err_energy[:, :, max(order_1 // 2, 1) :].sum(axis=(1, 2))
    p2_cost = err_energy[:, max(order_2 // 2, 1) :, :].sum(axis=(1, 2))
    return l2_sq, h_cost, np.stack([p1_cost, p2_cost], axis=1)


def _bucket_measures(basis, p1, p2, corners, form_order, dofs_u, dofs_err):
    """Reconstruct ``u`` and its error on ``basis``'s rule; Legendre measures."""
    rule_1 = basis.basis_xi.rule
    rule_2 = basis.basis_eta.rule
    xi = rule_1.nodes[None, :]
    eta = rule_2.nodes[:, None]
    recon_u = reconstruct_batched(corners, basis, form_order, dofs_u, xi, eta)
    recon_err = reconstruct_batched(corners, basis, form_order, dofs_err, xi, eta)
    det = _jacobian_np(corners, xi, eta)[4]
    w2d = rule_1.weights[None, :] * rule_2.weights[:, None]
    return _batched_legendre_measures(
        p1, p2, rule_1.nodes, rule_2.nodes, w2d, det, recon_u, recon_err
    )


def error_estimate_with_fine_solve(
    disc: Discretization,
    solution: np.ndarray,
    system: KFormSystem,
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
    constrained: Sequence[tuple[float, KFormUnknown]],
    estimator: ErrorEstimateFineSolve,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Error against a fine solve of the same problem (orders + dp, same
    mesh), discretized on the coarse discretization's device."""
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import (
        FrozenSaddleSolver,
        compute_linear_system,
        non_linear_solve_run,
    )

    dp = estimator.order_increase
    target = estimator.target_form
    fine_mesh = disc.mesh.copy()
    fine_mesh.uniform_p_change(dp, dp)
    fine_disc = discretize_mesh(
        fine_mesh, disc.form_spec, disc.basis_cache, disc.buckets[0].batch.device
    )
    evaluator = SystemEvaluator(disc.form_spec, CompiledSystem(system), fine_disc)
    forcing, matrices, lagrange_mat, lagrange_vec = compute_linear_system(
        fine_disc, system, evaluator, list(constrained), list(boundary_conditions), None
    )
    solver = FrozenSaddleSolver(evaluator.matrices_per_leaf(matrices), lagrange_mat)
    explicit_vec = (
        forcing if lagrange_mat is None else np.concatenate((forcing, lagrange_vec))
    )
    fine_solution, _, _, _, _ = non_linear_solve_run(
        estimator.max_iterations,
        1.0,
        estimator.tolerance,
        0.0,
        False,
        evaluator,
        explicit_vec,
        np.zeros(fine_disc.n_dofs),
        np.zeros(0 if lagrange_mat is None else lagrange_mat.shape[0]),
        float(np.abs(explicit_vec).max()),
        solver,
        lagrange_mat,
    )

    form_specs = disc.form_spec
    idx = form_specs.index(target)
    element_error = np.empty(disc.n_leaves)
    href_cost = np.empty(disc.n_leaves)
    dir_cost = np.ones((disc.n_leaves, 2))
    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        f1, f2 = p1 + dp, p2 + dp
        ranks = np.asarray(bucket.leaf_ranks)
        basis = disc.basis_cache.get_basis2d(p1, p2)
        fine_basis = disc.basis_cache.get_basis2d(f1, f2)
        rule_1 = disc.basis_cache.get_integration_rule(f1 + 1)
        rule_2 = disc.basis_cache.get_integration_rule(f2 + 1)
        xi = rule_1.nodes[None, :]
        eta = rule_2.nodes[:, None]
        corners = bucket.batch.corners_np

        off = form_specs.form_offset(idx, p1, p2)
        size = form_specs.form_size(idx, p1, p2)
        coarse_dofs = solution[bucket.gather][:, off : off + size]
        recon_u = reconstruct_batched(corners, basis, target.order, coarse_dofs, xi, eta)

        # The fine mesh shares the topology: each leaf has the same corners,
        # so the fine DoF slices reconstruct at the same reference points.
        foff = form_specs.form_offset(idx, f1, f2)
        fsize = form_specs.form_size(idx, f1, f2)
        fidx = (
            np.asarray(fine_disc.element_offsets)[ranks][:, None]
            + foff
            + np.arange(fsize)[None, :]
        )
        recon_fine = reconstruct_batched(
            corners, fine_basis, target.order, fine_solution[fidx], xi, eta
        )

        w2d = rule_1.weights[None, :] * rule_2.weights[:, None]
        det = _jacobian_np(corners, xi, eta)[4]
        l2, hc, dc = _batched_legendre_measures(
            p1, p2, rule_1.nodes, rule_2.nodes, w2d, det, recon_u, recon_fine - recon_u
        )
        element_error[ranks] = l2
        href_cost[ranks] = hc
        dir_cost[ranks] = dc
    return element_error, href_cost, dir_cost


def error_estimate_with_explicit_solution(
    disc: Discretization,
    solution: np.ndarray,
    target: KFormUnknown,
    solution_estimate,
    recon_order_1: int | None,
    recon_order_2: int | None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Error against a user-provided (near-)exact solution function, batched
    over each bucket on the host."""
    form_specs = disc.form_spec
    idx = form_specs.index(target)
    element_error = np.empty(disc.n_leaves)
    href_cost = np.empty(disc.n_leaves)
    dir_cost = np.ones((disc.n_leaves, 2))
    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        basis = disc.basis_cache.get_basis2d(p1, p2)
        rule_1 = disc.basis_cache.get_integration_rule(
            recon_order_1 if recon_order_1 is not None else p1
        )
        rule_2 = disc.basis_cache.get_integration_rule(
            recon_order_2 if recon_order_2 is not None else p2
        )
        xi = rule_1.nodes[None, :]
        eta = rule_2.nodes[:, None]
        corners = bucket.batch.corners_np
        dofs = solution[bucket.gather]
        off = form_specs.form_offset(idx, p1, p2)
        size = form_specs.form_size(idx, p1, p2)
        recon_u = reconstruct_batched(
            corners, basis, target.order, dofs[:, off : off + size], xi, eta
        )
        x, y = _physical_coordinates_np(corners, xi, eta)
        exact = np.asarray(solution_estimate(x, y))
        det = _jacobian_np(corners, xi, eta)[4]
        w2d = rule_1.weights[None, :] * rule_2.weights[:, None]
        l2, hc, dc = _batched_legendre_measures(
            p1, p2, rule_1.nodes, rule_2.nodes, w2d, det, recon_u, exact - recon_u
        )
        element_error[bucket.leaf_ranks] = l2
        href_cost[bucket.leaf_ranks] = hc
        dir_cost[bucket.leaf_ranks] = dc
    return element_error, href_cost, dir_cost


def error_estimate_with_order_reduction(
    disc: Discretization,
    solution: np.ndarray,
    target: KFormUnknown,
    reduction_order: int,
    alternative: Literal["ignore", "prioritize"],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Error = u - P_up P_down u, measured per element (batched per bucket;
    the projections on the device)."""
    if alternative not in ("ignore", "prioritize"):
        raise ValueError(f"Invalid alternative strategy {alternative}")
    form_specs = disc.form_spec
    idx = form_specs.index(target)
    single_spec = ElementFormSpecification(target)
    element_error = np.empty(disc.n_leaves)
    href_cost = np.empty(disc.n_leaves)
    dir_cost = np.ones((disc.n_leaves, 2))

    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        off = form_specs.form_offset(idx, p1, p2)
        size = form_specs.form_size(idx, p1, p2)
        dofs = solution[bucket.gather][:, off : off + size]
        if p1 <= reduction_order or p2 <= reduction_order:
            val = 0.0 if alternative == "ignore" else np.inf
            element_error[bucket.leaf_ranks] = val
            href_cost[bucket.leaf_ranks] = val
            continue

        batch = bucket.batch
        lower_basis = disc.basis_cache.get_basis2d(
            p1 - reduction_order, p2 - reduction_order, *batch.basis.integration_orders
        )
        lower_batch = ElementBatch(lower_basis, batch.corners_np, batch.device)
        err_dofs = (
            projection_roundtrip_error(single_spec, batch, lower_batch, dofs).cpu().numpy()
        )
        l2, hc, dc = _bucket_measures(
            batch.basis, p1, p2, batch.corners_np, target.order, dofs, err_dofs
        )
        element_error[bucket.leaf_ranks] = l2
        href_cost[bucket.leaf_ranks] = hc
        dir_cost[bucket.leaf_ranks] = dc
    return element_error, href_cost, dir_cost


class _BucketView:
    """Adapter so RHS assembly can run over a substituted batch."""

    def __init__(self, batch: ElementBatch, bucket) -> None:
        self.batch = batch
        self.orders = batch.orders
        self.leaf_ranks = bucket.leaf_ranks


def _fine_residuals(
    disc: Discretization,
    system: KFormSystem,
    compiled: CompiledSystem,
    solution: np.ndarray,
    order_increase: int,
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
):
    """Fine-space residual r = rhs_f - LHS_f(P u) per bucket (+ weak BCs).

    Returns the fine batches (on the coarse batches' device), the projected
    solutions per bucket (device tensors), the residuals per bucket (host
    arrays, where the weak boundary terms are added) and the offsets of the
    leaves in a flat fine vector of leaf order.
    """
    fine_batches: list[ElementBatch] = []
    projected: list[torch.Tensor] = []
    residuals: list[np.ndarray] = []
    fine_sizes = np.zeros(disc.n_leaves, np.int64)

    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        batch = bucket.batch
        fine_basis = disc.basis_cache.get_basis2d(
            p1 + order_increase, p2 + order_increase, *batch.basis.integration_orders
        )
        fine_batch = ElementBatch(fine_basis, batch.corners_np, batch.device)
        fine_batches.append(fine_batch)
        fine_dofs = project_between(
            disc.form_spec, batch, fine_batch, solution[bucket.gather]
        )
        projected.append(fine_dofs)

        statics = evaluate_static_fields(fine_batch, compiled.fields)
        fine_rhs = compute_element_rhs_bucket(system, _BucketView(fine_batch, bucket))
        fine_forcing = compute_element_vectors(
            disc.form_spec, compiled.lhs_blocks, fine_batch, fine_dofs, static_fields=statics
        )
        if compiled.rhs_blocks is not None:
            fine_forcing = fine_forcing - compute_element_vectors(
                disc.form_spec, compiled.rhs_blocks, fine_batch, fine_dofs,
                static_fields=statics,
            )
        residuals.append(fine_rhs - fine_forcing.cpu().numpy())
        fine_sizes[bucket.leaf_ranks] = disc.form_spec.total_size(*fine_batch.orders)

    # Weak-BC contributions on the fine mesh boundary, added in place through
    # per-leaf views of the bucket residuals.
    per_leaf_residual = [None] * disc.n_leaves
    for bucket, res in zip(disc.buckets, residuals):
        for j, rank in enumerate(bucket.leaf_ranks):
            per_leaf_residual[int(rank)] = res[j]

    # The weak-BC lines read the leaf orders from the mesh, so it is raised to
    # the fine orders for the loop and lowered back afterwards.
    mesh = disc.mesh
    mesh.uniform_p_change(order_increase, order_increase)
    try:
        for equation in system.equations:
            form = equation.weight.base_form
            boundary_terms = [
                (v, f)
                for v, f in equation.right.explicit_terms
                if (type(f) is KBoundaryProjection and f.func is not None)
            ]
            if not boundary_terms:
                continue
            form_index = system.unknown_forms.index(form)
            strong_indices = [bc.indices for bc in boundary_conditions if bc.form == form]
            skip = (
                np.unique(np.concatenate(strong_indices))
                if strong_indices
                else np.zeros(0, np.uint32)
            )
            for line_index in mesh.boundary_indices:
                if line_index in skip:
                    continue
                dual_line = mesh.dual.get_line(int(line_index) + 1)
                surf_id = dual_line.begin if dual_line.begin else dual_line.end
                primal_surface = mesh.primal.get_surface(surf_id)
                side = find_surface_boundary_id_line(primal_surface, int(line_index))
                bc_data = _element_weak_boundary_condition(
                    mesh,
                    surf_id.index,
                    side,
                    system.unknown_forms,
                    form_index,
                    boundary_terms,
                    disc.basis_cache,
                )
                for bc in bc_data:
                    per_leaf_residual[bc.i_e][bc.dofs] += bc.coeffs
    finally:
        mesh.uniform_p_change(-order_increase, -order_increase)

    return fine_batches, projected, residuals, np.concatenate([[0], np.cumsum(fine_sizes)])


def _local_lagrange_rows(
    form_specs: ElementFormSpecification,
    orders: tuple[int, int],
    n_fine: int,
    zeroed: Sequence[int],
    constrained_idx: Sequence[int],
) -> np.ndarray | None:
    """The zeroed-boundary and mean-constraint rows of one bucket's local
    saddle systems: they depend only on the fine orders."""
    lag_rows: list[np.ndarray] = []
    if zeroed:
        col_idx = [
            form_specs.form_offset(fi, *orders)
            + element_boundary_dofs(side, form_specs[fi][1], *orders)
            for fi in zeroed
            for side in ElementSide
        ]
        indices = np.unique(np.concatenate(col_idx))
        rows = np.zeros((indices.size, n_fine))
        rows[np.arange(indices.size), indices] = 1.0
        lag_rows.append(rows)
    if constrained_idx:
        rows = np.zeros((len(constrained_idx), n_fine))
        for i_row, fi in enumerate(constrained_idx):
            dofs_i = form_specs.form_offset(fi, *orders) + np.arange(
                form_specs.form_size(fi, *orders)
            )
            rows[i_row, dofs_i] = 1.0
        lag_rows.append(rows)
    return np.concatenate(lag_rows, axis=0) if lag_rows else None


def error_estimate_with_local_inversion(
    disc: Discretization,
    solution: np.ndarray,
    system: KFormSystem,
    compiled: CompiledSystem,
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
    order_increase: int,
    target: KFormUnknown,
    strongly_zeroed: Sequence[KFormUnknown],
    constrained: Sequence[KFormUnknown],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve the fine-space residual element-locally; its target-form part
    reconstructed is the error estimate (reference refinement.py:832-1092).

    The fine element matrices and every bucket's local saddle systems stay
    on the device: one batched f64 ``torch.linalg.solve`` a bucket.
    """
    form_specs = disc.form_spec
    unknown_index = form_specs.index(target)
    zeroed = tuple(i for i, f in enumerate(form_specs.iter_forms()) if f in strongly_zeroed)
    constrained_idx = tuple(
        i for i, f in enumerate(form_specs.iter_forms()) if f in constrained
    )
    element_error = np.empty(disc.n_leaves)
    href_cost = np.empty(disc.n_leaves)
    dir_cost = np.ones((disc.n_leaves, 2))

    fine_batches, projected, residuals, _ = _fine_residuals(
        disc, system, compiled, solution, order_increase, boundary_conditions
    )

    for bucket, fine_batch, fine_sol, res in zip(
        disc.buckets, fine_batches, projected, residuals
    ):
        statics = evaluate_static_fields(fine_batch, compiled.fields)
        local_lhs = compute_element_matrices(
            form_specs, compiled.lhs_blocks, fine_batch, dofs=fine_sol, static_fields=statics
        )
        pf = fine_batch.orders
        e_cnt, n_fine = local_lhs.shape[0], local_lhs.shape[1]
        rhs = torch.as_tensor(res, dtype=local_lhs.dtype, device=local_lhs.device)

        lag = _local_lagrange_rows(form_specs, pf, n_fine, zeroed, constrained_idx)
        if lag is not None:
            m = lag.shape[0]
            lag_t = torch.as_tensor(lag, dtype=local_lhs.dtype, device=local_lhs.device)
            saddle = local_lhs.new_zeros((e_cnt, n_fine + m, n_fine + m))
            saddle[:, :n_fine, :n_fine] = local_lhs
            saddle[:, :n_fine, n_fine:] = lag_t.T
            saddle[:, n_fine:, :n_fine] = lag_t
            rhs = torch.cat([rhs, rhs.new_zeros((e_cnt, m))], dim=1)
            local_error = torch.linalg.solve(saddle, rhs[..., None])[:, :n_fine, 0]
        else:
            local_error = torch.linalg.solve(local_lhs, rhs[..., None])[..., 0]

        off = form_specs.form_offset(unknown_index, *pf)
        count = form_specs.form_size(unknown_index, *pf)
        p1, p2 = bucket.orders
        l2, hc, dc = _bucket_measures(
            fine_batch.basis,
            p1,
            p2,
            bucket.batch.corners_np,
            target.order,
            fine_sol[:, off : off + count].cpu().numpy(),
            local_error[:, off : off + count].cpu().numpy(),
        )
        element_error[bucket.leaf_ranks] = l2
        href_cost[bucket.leaf_ranks] = hc
        dir_cost[bucket.leaf_ranks] = dc
    return element_error, href_cost, dir_cost


def error_estimate_with_vms(
    disc: Discretization,
    solution: np.ndarray,
    system: KFormSystem,
    compiled: CompiledSystem,
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
    estimator: ErrorEstimateVMS,
    constrained_forms: Sequence[tuple[float, KFormUnknown]],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global fine-scale VMS estimate (reference refinement.py:1387-1662).

    The fine-space residual of the projected solution is iterated through
    the fine-scale Green's function G' = A_f^{-1} - P A_c^{-1} P^T against
    the non-symmetric operator; the target form's fine scales, turned into
    primal DoFs by the fine inverse mass, are the error.  Element matrices,
    projectors and inverse masses are built on the device; the two saddle
    factorizations and the iteration are host SuperLU and CSR products.
    """
    from mfv2d_torch.continuity import add_system_constraints

    target = estimator.target_form
    if target not in system.unknown_forms:
        raise ValueError(f"Target unknown form {target} is not in the system.")
    for name, sub in (
        ("symmetric", estimator.symmetric_system),
        ("nonsymmetric", estimator.nonsymmetric_system),
    ):
        if sub.unknown_forms != system.unknown_forms:
            raise ValueError(f"Unknown forms of {name} system do not match.")

    form_specs = disc.form_spec
    order_increase = estimator.order_increase
    compiled_sym = CompiledSystem(estimator.symmetric_system)
    compiled_nonsym = CompiledSystem(estimator.nonsymmetric_system)

    # The reference dual-projects the coarse forcing; the direct fine-space
    # residual of the projected solution agrees on resolved scales.
    fine_batches, projected, residuals, fine_offsets = _fine_residuals(
        disc, system, compiled, solution, order_increase, boundary_conditions
    )

    def matrices(compiled_blocks: CompiledSystem, batch: ElementBatch) -> np.ndarray:
        return (
            compute_element_matrices(
                form_specs,
                compiled_blocks.lhs_blocks,
                batch,
                static_fields=evaluate_static_fields(batch, compiled_blocks.fields),
            )
            .cpu()
            .numpy()
        )

    sym_coarse, sym_fine, nonsym_fine, projectors = [], [], [], []
    for bucket, fine_batch in zip(disc.buckets, fine_batches):
        sym_coarse.append(matrices(compiled_sym, bucket.batch))
        sym_fine.append(matrices(compiled_sym, fine_batch))
        nonsym_fine.append(matrices(compiled_nonsym, fine_batch))
        orders_c, orders_f = bucket.orders, fine_batch.orders
        off_c = form_specs.form_offsets(*orders_c)
        off_f = form_specs.form_offsets(*orders_f)
        big = np.zeros(
            (bucket.batch.n_elements, form_specs.total_size(*orders_f), off_c[-1])
        )
        for i, proj in enumerate(element_projector(form_specs, bucket.batch, fine_batch)):
            big[:, off_f[i] : off_f[i + 1], off_c[i] : off_c[i + 1]] = proj.cpu().numpy()
        projectors.append(big)

    mesh = disc.mesh
    mesh.uniform_p_change(order_increase, order_increase)
    try:
        fine_lag_mat, fine_lag_vec = add_system_constraints(
            system,
            mesh,
            disc.basis_cache,
            constrained_forms,
            boundary_conditions,
            disc.leaf_indices,
            fine_offsets,
            None,
        )
    finally:
        mesh.uniform_p_change(-order_increase, -order_increase)
    coarse_lag_mat, coarse_lag_vec = add_system_constraints(
        system,
        mesh,
        disc.basis_cache,
        constrained_forms,
        boundary_conditions,
        disc.leaf_indices,
        disc.element_offsets,
        None,
    )

    def saddle_lu(blocks, lag_mat):
        block = sp.block_diag(per_leaf(disc, blocks))
        if lag_mat is not None:
            block = sp.block_array([[block, lag_mat.T], [lag_mat, None]], format="csc")
        return sla.splu(sp.csc_matrix(block))

    fine_decomp = saddle_lu(sym_fine, fine_lag_mat)
    coarse_decomp = saddle_lu(sym_coarse, coarse_lag_mat)
    n_lag_fine = fine_lag_vec.size
    n_lag_coarse = coarse_lag_vec.size
    nonsym_op = sp.block_diag(per_leaf(disc, nonsym_fine), format="csr")
    projector = sp.block_diag(per_leaf(disc, projectors), format="csr")
    residual = np.concatenate(per_leaf(disc, residuals))

    def greens(x):
        rf = fine_decomp.solve(np.pad(x, (0, n_lag_fine)))[: x.size]
        xc = x @ projector
        rc = coarse_decomp.solve(np.pad(xc, (0, n_lag_coarse)))
        return rf - projector @ rc[: xc.size]

    agr = nonsym_op @ greens(residual)
    u = residual
    for _ in range(estimator.max_iters):
        u_new = agr - nonsym_op @ greens(u)
        max_du = np.abs(u - u_new).max()
        max_u = np.abs(u_new).max()
        u = u_new
        if max_du < max_u * estimator.rtol or max_du < estimator.atol:
            break

    element_error = np.empty(disc.n_leaves)
    href_cost = np.empty(disc.n_leaves)
    dir_cost = np.ones((disc.n_leaves, 2))
    unknown_index = form_specs.index(target)
    for bucket, fine_batch, fine_sol in zip(disc.buckets, fine_batches, projected):
        pf = fine_batch.orders
        off = form_specs.form_offset(unknown_index, *pf)
        count = form_specs.form_size(unknown_index, *pf)
        local = fine_offsets[bucket.leaf_ranks][:, None] + off + np.arange(count)[None, :]
        m_inv = fine_batch.mass(target.order, True)
        fine_scales = torch.as_tensor(u[local], dtype=m_inv.dtype, device=m_inv.device)
        target_dofs = torch.matmul(m_inv, fine_scales[..., None])[..., 0]
        p1, p2 = bucket.orders
        l2, hc, dc = _bucket_measures(
            fine_batch.basis,
            p1,
            p2,
            bucket.batch.corners_np,
            target.order,
            fine_sol[:, off : off + count].cpu().numpy(),
            target_dofs.cpu().numpy(),
        )
        element_error[bucket.leaf_ranks] = l2
        href_cost[bucket.leaf_ranks] = hc
        dir_cost[bucket.leaf_ranks] = dc
    return element_error, href_cost, dir_cost


# ---------------------------------------------------------------------------
# Refinement loop
# ---------------------------------------------------------------------------


def refine_mesh_based_on_error(
    mesh: Mesh,
    total_unknowns: int,
    h_refinement_ratio: float,
    refinement_limit: RefinementLimit,
    form_specs: ElementFormSpecification,
    leaf_indices,
    element_error: np.ndarray,
    href_cost: np.ndarray,
    order_limit: int | None,
    lower_order_limit: int | None,
    dir_cost: np.ndarray | None = None,
) -> Mesh:
    """Split or p-raise elements in decreasing-error order until the limit.

    With ``dir_cost`` (per-element [p1_cost, p2_cost] from the directional
    Legendre spectrum), p-refinement raises only the direction(s) whose
    high-mode energy dominates.
    """
    error_order = np.flip(np.argsort(element_error))
    ordered_indices = np.asarray(leaf_indices)[error_order]
    with np.errstate(divide="ignore", invalid="ignore"):
        cost_fraction = href_cost / element_error
    mesh = mesh.copy()
    if lower_order_limit is None:
        lower_order_limit = 1

    def should_split(i_leaf, order_1, order_2):
        return (
            cost_fraction[i_leaf] <= h_refinement_ratio
            and order_1 > lower_order_limit
            and order_2 > lower_order_limit
        ) or (
            order_limit is not None
            and (order_1 >= order_limit or order_2 >= order_limit)
        )

    def p_raise(i_leaf, order_1, order_2):
        """New orders after a p-refinement step (possibly anisotropic)."""
        if dir_cost is None:
            return order_1 + 1, order_2 + 1
        c1, c2 = dir_cost[i_leaf]
        total = c1 + c2
        if total <= 0:
            return order_1 + 1, order_2 + 1
        d1 = order_1 + 1 if c1 >= 0.33 * total else order_1
        d2 = order_2 + 1 if c2 >= 0.33 * total else order_2
        if (d1, d2) == (order_1, order_2):
            return order_1 + 1, order_2 + 1
        return d1, d2

    if isinstance(refinement_limit, RefinementLimitElementCount):
        budget = min(
            mesh.leaf_count * refinement_limit.maximum_fraction,
            refinement_limit.maximum_count,
        )
        refined = 0
        for i_leaf, idx in zip(error_order, ordered_indices):
            if refined >= budget:
                break
            o1, o2 = mesh.get_leaf_orders(int(idx))
            if should_split(i_leaf, o1, o2):
                new_orders = (max(o1 // 2, 1), max(o2 // 2, 1))
                mesh.split_element(int(idx), *([new_orders] * 4))
            else:
                mesh.set_leaf_orders(int(idx), *p_raise(i_leaf, o1, o2))
            refined += 1
    elif isinstance(refinement_limit, RefinementLimitUnknownCount):
        budget = min(
            total_unknowns * refinement_limit.maximum_fraction,
            refinement_limit.maximum_count,
        )
        added = 0
        for i_leaf, idx in zip(error_order, ordered_indices):
            if added >= budget:
                break
            o1, o2 = mesh.get_leaf_orders(int(idx))
            original = form_specs.total_size(o1, o2)
            if should_split(i_leaf, o1, o2):
                new_orders = (max((o1 + 1) // 2, 1), max((o2 + 1) // 2, 1))
                mesh.split_element(int(idx), *([new_orders] * 4))
                new_unknowns = 4 * form_specs.total_size(*new_orders)
            else:
                raised = p_raise(i_leaf, o1, o2)
                mesh.set_leaf_orders(int(idx), *raised)
                new_unknowns = form_specs.total_size(*raised)
            added += new_unknowns - original
    elif isinstance(refinement_limit, RefinementLimitErrorValue):
        total_error = np.sum(element_error)
        minimum = max(
            total_error * refinement_limit.minimum_fraction,
            refinement_limit.minimum_value,
        )
        for i_leaf, idx in zip(error_order, ordered_indices):
            o1, o2 = mesh.get_leaf_orders(int(idx))
            if should_split(i_leaf, o1, o2):
                new_orders = (max(o1 // 2, 1), max(o2 // 2, 1))
                mesh.split_element(int(idx), *([new_orders] * 4))
            else:
                mesh.set_leaf_orders(int(idx), o1 + 1, o2 + 1)
            if np.abs(element_error[i_leaf]) < minimum:
                break
    else:
        raise TypeError(
            f"Invalid type for refinement limit: {type(refinement_limit).__name__}"
        )
    return mesh


def perform_mesh_refinement(
    disc: Discretization,
    solution: np.ndarray,
    system: KFormSystem,
    evaluator: SystemEvaluator,
    error_estimator: ErrorEstimate,
    h_refinement_ratio: float,
    refinement_limit: RefinementLimit,
    report_error_distribution: bool,
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
    order_limit: int | None,
    lower_order_limit: int | None,
    constrained: Sequence[tuple[float, KFormUnknown]],
    anisotropic_p: bool = False,
) -> tuple[Mesh, np.ndarray, np.ndarray]:
    """Estimate per-element errors and produce a refined mesh."""
    if isinstance(error_estimator, ErrorEstimateCustom):
        ro = error_estimator.reconstruction_orders
        element_error, href_cost, dir_cost = error_estimate_with_custom_estimator(
            disc,
            solution,
            error_estimator.required_forms,
            error_estimator.error_calculation_function,
            ro[0] if ro is not None else None,
            ro[1] if ro is not None else None,
        )
    elif isinstance(error_estimator, ErrorEstimateLocalInverse):
        element_error, href_cost, dir_cost = error_estimate_with_local_inversion(
            disc,
            solution,
            system,
            evaluator.compiled,
            boundary_conditions,
            error_estimator.order_increase,
            error_estimator.target_form,
            error_estimator.strong_forms,
            [form for _, form in constrained],
        )
    elif isinstance(error_estimator, ErrorEstimateL2OrderReduction):
        element_error, href_cost, dir_cost = error_estimate_with_order_reduction(
            disc,
            solution,
            error_estimator.target_form,
            error_estimator.order_drop,
            error_estimator.alternative,
        )
    elif isinstance(error_estimator, ErrorEstimateExplicit):
        ro = error_estimator.reconstruction_orders
        element_error, href_cost, dir_cost = error_estimate_with_explicit_solution(
            disc,
            solution,
            error_estimator.target_form,
            error_estimator.solution_estimate,
            ro[0] if ro is not None else None,
            ro[1] if ro is not None else None,
        )
    elif isinstance(error_estimator, ErrorEstimateFineSolve):
        element_error, href_cost, dir_cost = error_estimate_with_fine_solve(
            disc, solution, system, boundary_conditions, constrained, error_estimator
        )
    elif isinstance(error_estimator, ErrorEstimateVMS):
        element_error, href_cost, dir_cost = error_estimate_with_vms(
            disc,
            solution,
            system,
            evaluator.compiled,
            boundary_conditions,
            error_estimator,
            constrained,
        )
    else:
        raise TypeError(
            f"Invalid type for error estimator {type(error_estimator).__name__}"
        )

    if report_error_distribution and np.all(np.isfinite(element_error)):
        error_log = np.log10(element_error)
        if np.all(np.isfinite(error_log)):
            hist = HistogramFormat(5, 60, 5, label_format=lambda x: f"10^({x:.2g})")
            print("Error estimate distribution\n" + "=" * 60)
            print(hist.format(error_log))
            print("=" * 60)

    return (
        refine_mesh_based_on_error(
            disc.mesh,
            solution.size,
            h_refinement_ratio,
            refinement_limit,
            disc.form_spec,
            disc.leaf_indices,
            element_error,
            href_cost,
            order_limit,
            lower_order_limit,
            dir_cost=dir_cost if anisotropic_p else None,
        ),
        element_error,
        href_cost,
    )
