"""Assembly of the global system and the nonlinear (Picard) solve loop.

Structure mirrors the reference solver (python/mfv2d/solve_system.py): the
element LHS is assembled once into a frozen saddle-point factorization; each
iteration re-evaluates the element residual with the current solution (the
nonlinear terms enter only through the residual — defect correction).  All
per-element work runs as batched tensor computations over the order buckets
on the discretization's device; the sparse factorization is host-side
(SciPy SuperLU).  Each bucket's ``[E, N, N]`` matrices cross to the host once
per assembly and each residual once per iteration.
"""

from __future__ import annotations

import time
from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass, field

import numpy as np
import numpy.typing as npt
import torch

from mfv2d_torch.boundary import BoundaryCondition2DSteady
from mfv2d_torch.compiler import CompiledSystem, MassMat, SystemBlocks
from mfv2d_torch.continuity import add_system_constraints
from mfv2d_torch.evaluation import (
    apply_mass,
    compute_element_matrices,
    compute_element_vectors,
    evaluate_static_fields,
)
from mfv2d_torch.kform import (
    KElementProjection,
    KFormUnknown,
    KWeight,
    UnknownFormOrder,
)
from mfv2d_torch.mimetic import vtk_lagrange_ordering
from mfv2d_torch.ops.kernels import supernodal
from mfv2d_torch.progress import ProgressTracker
from mfv2d_torch.projection import element_dual_dofs
from mfv2d_torch.solver.discretization import Discretization, OrderBucket, per_leaf
from mfv2d_torch.system import ElementFormSpecification, KFormSystem
from mfv2d_torch.tracing import tracer
from mfv2d_torch.transfer import to_device, to_host
from mfv2d_torch.utils.lazy import lazy_module
from mfv2d_torch.vis import VTK_LAGRANGE_QUADRILATERAL, ReconstructedGrid

sp = lazy_module("scipy.sparse")
sla = lazy_module("scipy.sparse.linalg")


@dataclass(frozen=True)
class ConvergenceSettings:
    """Convergence criteria of an iterative solver."""

    maximum_iterations: int = 100
    absolute_tolerance: float = 1e-6
    relative_tolerance: float = 1e-5


@dataclass(frozen=True)
class SolverSettings:
    """Nonlinear solver settings (reference solve_system.py:554-601).

    ``linear_solver`` selects the inner linear solve: "direct" (host sparse
    LU of the frozen saddle matrix, the reference behavior), "dense" (dense
    LU of the whole saddle matrix on the device), "schur_direct" (static
    condensation: assembled trace Schur complement, sparse-factored once),
    or the matrix-free paths "schur", "pcg", "gmres" on the device (see
    mfv2d_torch.solver.iterative).
    """

    convergence: ConvergenceSettings = ConvergenceSettings()
    relaxation: float = 1.0
    linear_solver: str = "direct"
    method: str = "picard"
    """Nonlinear iteration: "picard" (frozen operator, the reference scheme)
    or "newton" (exact element Jacobians by forward-mode differentiation,
    rebuilt every iteration)."""
    device_mesh: object | None = None
    """A one-dimensional ``torch.distributed`` DeviceMesh, or the
    ``parallel.sharding.TraceComm`` of one: the solve then runs
    element-sharded over its ranks, every rank calling alike, with every
    option (steady Picard and Newton, the linear, Picard and Newton marches,
    VMS, checkpoints, hp refinement)."""
    anderson_m: int = 0
    """Anderson acceleration window for the Picard loop (0 = off, the
    reference behavior).  With ``m > 0`` each update extrapolates over the
    last ``m`` (iterate, preconditioned-residual) pairs via a small
    least-squares problem.  Guarded: an extrapolation with large
    coefficients falls back to the plain damped update for that
    iteration."""


@dataclass(frozen=True)
class TimeSettings:
    """Trapezoidal time-march settings (reference solve_system.py:485-509)."""

    dt: float
    nt: int
    time_march_relations: Mapping[KWeight, KFormUnknown]
    sample_rate: int = 1


@dataclass(frozen=True)
class SystemSettings:
    """System, boundary conditions, constraints and initial conditions."""

    system: KFormSystem
    boundary_conditions: Sequence[BoundaryCondition2DSteady] = field(
        default_factory=tuple
    )
    constrained_forms: Sequence[tuple[float, KFormUnknown]] = field(
        default_factory=tuple
    )
    initial_conditions: Mapping[KFormUnknown, Callable] = field(default_factory=dict)
    over_integration_order: int = 3


@dataclass(frozen=True)
class VMSSettings:
    """Variational multi-scale fine-scale estimation settings."""

    symmetric_system: KFormSystem
    nonsymmetric_system: KFormSystem
    order_increase: int
    fine_scale_convergence: ConvergenceSettings
    relaxation: float = 1.0
    matrix_free: bool | None = None
    iteration: str = "gmres"
    inexact_forcing: bool = True
    anticipate_factor: float = 3.0
    inexact_eta: float = 0.005


@dataclass(frozen=True)
class SolutionStatistics:
    """Solve statistics (reference solve_system.py:620-631)."""

    element_orders: dict[tuple[int, int], int]
    n_total_dofs: int
    n_leaf_dofs: int
    n_lagrange: int
    n_elems: int
    n_leaves: int
    iter_history: npt.NDArray[np.uint32]
    residual_history: npt.NDArray[np.float64]


# ---------------------------------------------------------------------------
# RHS assembly
# ---------------------------------------------------------------------------


def compute_element_rhs_bucket(system: KFormSystem, bucket: OrderBucket) -> np.ndarray:
    """Explicit forcing projections for one bucket: ``[E, N]``."""
    p1, p2 = bucket.orders
    parts: list[np.ndarray] = []
    for eq in system.equations:
        n = eq.weight.order.full_unknown_count(p1, p2)
        acc = np.zeros((bucket.batch.n_elements, n))
        for k, f in eq.right.explicit_terms:
            if not isinstance(f, KElementProjection) or f.func is None:
                continue
            acc += float(k) * np.asarray(
                element_dual_dofs(eq.weight.order, bucket.batch, f.func)
            )
        parts.append(acc)
    return np.concatenate(parts, axis=1)


def compute_forcing_vector(disc: Discretization, system: KFormSystem) -> np.ndarray:
    """Global explicit forcing vector over all buckets."""
    out = np.zeros(disc.n_dofs)
    for bucket in disc.buckets:
        out[bucket.gather] = compute_element_rhs_bucket(system, bucket)
    return out


# ---------------------------------------------------------------------------
# Batched residual / matrix evaluation
# ---------------------------------------------------------------------------


# Bytes of one chunk of Jacobian tangents, counted as E N^2 per tangent: an
# interior-product matrix of a tangent is at most [E, N, N], and the chunk
# bounds how many of them are alive at once.
_JACOBIAN_CHUNK_BYTES = 1 << 30


def _to_device(values: np.ndarray, bucket: OrderBucket) -> torch.Tensor:
    return to_device(values, bucket.batch.device, torch.float64)


def warm_masses(batch, *block_sets) -> None:
    """Compute every mass (or inverse) that ``block_sets`` read on ``batch``,
    so a transformed residual only reads the memo and launches no kernel."""
    for blocks in block_sets:
        for row in blocks or ():
            for ops in row:
                for op in ops or ():
                    if isinstance(op, MassMat):
                        batch.mass(op.order, op.inv)


def forward_jacobians(residual, dofs: torch.Tensor) -> torch.Tensor:
    """Exact per-element Jacobians ``[E, N, N]`` of an element-local
    ``residual: [E, N] -> [E, N]`` at ``dofs``.

    Residuals are element-local, so a forward-mode tangent that is ``e_j``
    in every element gives column ``j`` of every element's Jacobian at once:
    a vmap over the N one-hot tangents of one jvp of the whole batch's
    residual.  The caller computes the masses first (:func:`warm_masses`),
    outside the transform, so the kernels run on plain tensors and the
    derivative only reads their output.
    """
    e, n = dofs.shape
    chunk = max(1, min(n, _JACOBIAN_CHUNK_BYTES // (e * n * n * dofs.element_size())))

    def column(tangent):
        return torch.func.jvp(residual, (dofs,), (tangent.expand(e, n),))[1]

    eye = torch.eye(n, dtype=dofs.dtype, device=dofs.device)
    columns = torch.func.vmap(column, chunk_size=chunk)(eye)  # [j, E, i]
    return columns.permute(1, 2, 0)


class SystemEvaluator:
    """Per-bucket evaluation of element matrices and residuals.

    Static (callable) interior-product fields are host-evaluated once per
    bucket; unknown-form fields are reconstructed from the DoFs at each
    evaluation, so the residual follows the Picard iterate.
    """

    def __init__(
        self,
        form_spec: ElementFormSpecification,
        compiled: CompiledSystem,
        disc: Discretization,
    ) -> None:
        self.form_spec = form_spec
        self.compiled = compiled
        self.disc = disc
        self._static_fields = [
            evaluate_static_fields(bucket.batch, compiled.fields)
            for bucket in disc.buckets
        ]

    def refresh_static_fields(self) -> None:
        """Re-evaluate callable (static) interior-product fields.

        Serves TimeDependent OPERATOR fields: the march sets
        ``TimeDependent.current_time`` to the new time level and calls this
        before re-assembling, so the advecting field re-evaluates at that
        time.  Every consumer reads ``self._static_fields`` at call time.
        """
        self._static_fields = [
            evaluate_static_fields(bucket.batch, self.compiled.fields)
            for bucket in self.disc.buckets
        ]

    def element_matrices(
        self, which: SystemBlocks, solution: np.ndarray | None = None
    ) -> list[np.ndarray]:
        """Batched element matrices per bucket for the given block set."""
        out = []
        for i, bucket in enumerate(self.disc.buckets):
            dofs = (
                _to_device(solution[bucket.gather], bucket)
                if solution is not None
                else None
            )
            mats = compute_element_matrices(
                self.form_spec,
                which,
                bucket.batch,
                dofs=dofs,
                static_fields=self._static_fields[i],
            )
            out.append(to_host(mats))
        return out

    def bucket_residual(self, i_bucket: int, dofs: torch.Tensor) -> torch.Tensor:
        """Element-wise LHS(u) - RHS(u) of one bucket: ``[E, N]`` on its device."""
        batch = self.disc.buckets[i_bucket].batch
        statics = self._static_fields[i_bucket]
        val = compute_element_vectors(
            self.form_spec, self.compiled.lhs_blocks, batch, dofs, static_fields=statics
        )
        if self.compiled.rhs_blocks is not None:
            val = val - compute_element_vectors(
                self.form_spec, self.compiled.rhs_blocks, batch, dofs, static_fields=statics
            )
        return val

    def residual_value(self, solution: np.ndarray) -> np.ndarray:
        """Element-wise LHS(u) - RHS(u) evaluation, scattered globally."""
        out = np.zeros(self.disc.n_dofs)
        for i, bucket in enumerate(self.disc.buckets):
            dofs = _to_device(solution[bucket.gather], bucket)
            out[bucket.gather] = to_host(self.bucket_residual(i, dofs))
        return out

    def bucket_jacobians(self, i_bucket: int, dofs: torch.Tensor) -> torch.Tensor:
        """Exact per-element Jacobians ``d(LHS - RHS)/du`` of one bucket,
        ``[E, N, N]`` on its device (:func:`forward_jacobians`)."""
        warm_masses(
            self.disc.buckets[i_bucket].batch, self.compiled.lhs_blocks, self.compiled.rhs_blocks
        )
        return forward_jacobians(lambda d: self.bucket_residual(i_bucket, d), dofs)

    def element_jacobians(self, solution: np.ndarray) -> list[np.ndarray]:
        """Exact per-element Jacobians d(LHS - RHS)/du per bucket (Newton).

        The reference's Picard loop freezes the linear operator; the true
        Newton operator additionally carries the derivative of the
        solution-dependent interior-product fields.
        """
        return [
            to_host(self.bucket_jacobians(i, _to_device(solution[bucket.gather], bucket)))
            for i, bucket in enumerate(self.disc.buckets)
        ]

    def matrices_per_leaf(self, matrices: list[np.ndarray]) -> list[np.ndarray]:
        """Reorder per-bucket matrix batches into leaf order."""
        return per_leaf(self.disc, matrices)


# ---------------------------------------------------------------------------
# Linear system assembly + factorization
# ---------------------------------------------------------------------------


def compute_linear_system(
    disc: Discretization,
    system: KFormSystem,
    evaluator: SystemEvaluator,
    constrained_forms: Sequence[tuple[float, KFormUnknown]],
    boundary_conditions: Sequence[BoundaryCondition2DSteady],
    initial_solution: np.ndarray | None,
):
    """Forcing vector, element matrices, and Lagrange constraint block."""
    forcing = compute_forcing_vector(disc, system)
    # Per-leaf views for the in-place weak-BC additions.
    linear_vectors = [
        forcing[disc.element_offsets[i] : disc.element_offsets[i + 1]]
        for i in range(disc.n_leaves)
    ]
    matrices = evaluator.element_matrices(
        evaluator.compiled.lhs_blocks, initial_solution
    )
    lagrange_mat, lagrange_vec = add_system_constraints(
        system,
        disc.mesh,
        disc.basis_cache,
        constrained_forms,
        boundary_conditions,
        disc.leaf_indices,
        disc.element_offsets,
        linear_vectors,
    )
    return forcing, matrices, lagrange_mat, lagrange_vec


# A factorization whose first solve on the host took less than this stays
# on the host: a solve on the card takes 2.4-3.1 ms with its copies (H100,
# n = 36,352 and 261,632), so it would gain too little a solve to pay for
# laying the factors out (0.06-0.3 s, about five host solves).
CARD_MIN_HOST_SOLVE_S = 0.005


class FrozenSaddleSolver:
    """LU factorization of [[A, G^T], [G, 0]] reused across iterations.

    A is block-diagonal over elements.  Host SciPy SuperLU.  Traced as
    ``saddle-matrix`` (the sparse saddle matrix, to CSC) and ``superlu``.

    On a CUDA ``device``, once the first solve (SuperLU's own) has taken at
    least :data:`CARD_MIN_HOST_SOLVE_S`, the second and later solves run the
    factors' triangular sweeps on the card
    (:mod:`mfv2d_torch.ops.kernels.supernodal`): the second solve lays the
    factors out there first, traced as ``frozen-solve-prepare``.  Every
    other solve is SuperLU's.  The tracer counts ``frozen_solve_host`` and
    ``frozen_solve_card``.
    """

    def __init__(
        self,
        element_matrices_per_leaf: list[np.ndarray],
        lagrange_mat: sp.csr_array | None,
        device: torch.device | str | None = None,
    ) -> None:
        with tracer.stage("saddle-matrix"):
            main_mat = sp.block_diag(element_matrices_per_leaf, format="csr")
            if lagrange_mat is not None:
                main_mat = sp.block_array(
                    ((main_mat, lagrange_mat.T), (lagrange_mat, None)), format="csr"
                )
            main_mat = sp.csc_matrix(main_mat)
        self.n_lagrange = 0 if lagrange_mat is None else lagrange_mat.shape[0]
        with tracer.stage("superlu"):
            self._decomp = sla.splu(main_mat)
        on_card = device is not None and torch.device(device).type == "cuda"
        self._card_device = torch.device(device) if on_card else None
        self._first_solve_s: float | None = None
        self._card = None

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """The solution for one right side ``rhs`` of the saddle system."""
        if (
            self._card is None
            and self._card_device is not None
            and self._first_solve_s is not None
            and self._first_solve_s >= CARD_MIN_HOST_SOLVE_S
        ):
            with tracer.stage("frozen-solve-prepare"):
                self._card = supernodal.CardSolve(
                    supernodal.build_schedule(self._decomp, self._card_device)
                )
        if self._card is None:
            tracer.count("frozen_solve_host")
            start = time.perf_counter()
            x = np.asarray(self._decomp.solve(rhs), np.float64)
            if self._first_solve_s is None:
                self._first_solve_s = time.perf_counter() - start
            return x
        tracer.count("frozen_solve_card")
        return self._card.solve(rhs)


def _preconditioned_newton_solve(
    solver,
    evaluator: SystemEvaluator,
    jac_blocks: list[np.ndarray],
    lagrange_mat,
    residual: np.ndarray,
    rel_tol: float,
    max_inner: int = 60,
) -> tuple[np.ndarray, bool]:
    """Solve ``J d = residual`` with the frozen factorization as preconditioner.

    Defect correction ``d += P^{-1}(residual - J d)`` converges at rate
    ``||I - P^{-1} J||``; each sweep costs one batched element GEMV plus one
    frozen solve, far below a sparse refactorization.  Returns
    ``(d, converged)``; on stall the caller refactorizes.
    """
    disc = evaluator.disc
    n = disc.n_dofs

    def jac_apply(x: np.ndarray) -> np.ndarray:
        u = x[:n]
        out = np.zeros(n)
        for blocks, bucket in zip(jac_blocks, disc.buckets):
            g = bucket.gather
            out[g] = np.einsum("eij,ej->ei", blocks, u[g], optimize=True)
        if lagrange_mat is None:
            return out
        out = out + lagrange_mat.T @ x[n:]
        return np.concatenate((out, lagrange_mat @ u))

    r_norm = float(np.abs(residual).max())
    if r_norm == 0.0:
        return np.zeros_like(residual), True
    d = solver.solve(residual)
    prev = np.inf
    for _ in range(max_inner):
        s = residual - jac_apply(d)
        s_norm = float(np.abs(s).max())
        if s_norm <= rel_tol * r_norm:
            return d, True
        if s_norm >= 0.9 * prev:
            # Not contracting: the frozen operator is too far from J.
            return d, False
        prev = s_norm
        d = d + solver.solve(s)
    return d, False


def anderson_step(
    aa_x: list[np.ndarray],
    aa_f: list[np.ndarray],
    x_k: np.ndarray,
    f_k: np.ndarray,
    anderson_m: int,
    restart: bool,
) -> np.ndarray:
    """One guarded type-II Anderson step for the fixed point ``x + f(x)``.

    ``aa_x``/``aa_f`` hold the last ``anderson_m + 1`` iterates and steps and
    are updated in place (emptied first when ``restart``).  The coefficients
    solve ``min |dF gamma - f_k|`` by ``lstsq(rcond=1e-10)``; where one
    exceeds 25 the differences are near-singular and the plain step
    ``x_k + f_k`` is taken.  Returns the next iterate.
    """
    if restart:
        aa_x.clear()
        aa_f.clear()
    aa_x.append(x_k)
    aa_f.append(f_k)
    if len(aa_x) > anderson_m + 1:
        aa_x.pop(0)
        aa_f.pop(0)
    x_new = x_k + f_k
    if len(aa_f) > 1:
        df = np.stack([aa_f[i + 1] - aa_f[i] for i in range(len(aa_f) - 1)], axis=1)
        dx = np.stack([aa_x[i + 1] - aa_x[i] for i in range(len(aa_x) - 1)], axis=1)
        gamma, *_ = np.linalg.lstsq(df, f_k, rcond=1e-10)
        if np.abs(gamma).max() <= 25.0:
            x_new = x_k + f_k - (dx + df) @ gamma
    return x_new


def non_linear_solve_run(
    max_iterations: int,
    relax: float,
    atol: float,
    rtol: float,
    print_residual: bool,
    evaluator: SystemEvaluator,
    explicit_vec: np.ndarray,
    solution: np.ndarray,
    global_lagrange: np.ndarray,
    max_mag: float,
    solver,
    lagrange_mat: sp.csr_array | None,
    return_all_residuals: bool = False,
    anderson_m: int = 0,
    *,
    time_carry_index_array: np.ndarray | None = None,
    time_carry_term: np.ndarray | None = None,
    newton: bool = False,
    fine_scales: np.ndarray | None = None,
    sg_operator=None,
    checkpoint_cb=None,
):
    """Picard / defect-correction iteration (reference solve_system.py:354).

    residual = forcing (plus the time-march carry on its rows) - (LHS(u) -
    RHS(u)) - G^T lambda, less the VMS unresolved-scale forcing when
    ``sg_operator`` (a :class:`mfv2d_torch.solver.vms.SuyashGreenOperator`)
    is given; update = frozen solve of the residual.  With ``newton`` every
    iteration after the first solves with the exact element Jacobians at the
    iterate instead (see _preconditioned_newton_solve).

    Returns ``(solution, lagrange, iterations, residual, unresolved)``: the
    last residual, or every iteration's with ``return_all_residuals``, and
    the unresolved scales (``fine_scales`` where there is no operator).
    """
    progress_tracker: ProgressTracker | None = None
    iter_cnt = 0
    # Anderson acceleration (type II) over the damped-Picard fixed point
    # x_{k+1} = x_k + relax * P^{-1} r(x_k): keep the last m (iterate,
    # step) pairs and extrapolate via a small least-squares problem.
    # Exact-Newton steps don't need it (quadratic already).
    use_aa = anderson_m > 0 and not newton
    aa_x: list[np.ndarray] = []
    aa_f: list[np.ndarray] = []
    base_vec = np.array(explicit_vec, copy=True)
    if time_carry_term is not None:
        base_vec[time_carry_index_array] += time_carry_term
    residuals = np.zeros(max_iterations)
    max_residual = 0.0
    unresolved_scales = fine_scales
    # Inexact forcing (VMSSettings.inexact_forcing): while the outer
    # residual is large, solve the unresolved-scale equation only to an
    # absolute tolerance of inexact_eta times the previous outer residual;
    # a convergence exit reached with a loosened tolerance re-solves the
    # scales at the configured tolerance and re-measures.  Within
    # anticipate_factor of the exit threshold the in-loop solve already runs
    # at the configured tolerance, so the exit needs no re-solve.  The JAX
    # package also serves loosened Green's applies ("accuracy tiers") on
    # the TPU only; here every apply is exact f64, so the loosened state
    # comes from the tolerance alone.
    vms_inexact = sg_operator is not None and sg_operator.inexact_forcing
    # The loop exits when max_residual <= atol or <= max_mag * rtol.
    exit_threshold = max(atol, max_mag * rtol)
    vms_loosened = False

    while iter_cnt < max_iterations:
        with tracer.stage("picard-residual"):
            main_value = evaluator.residual_value(solution)
        if lagrange_mat is not None:
            main_value = main_value + lagrange_mat.T @ global_lagrange
            main_value = np.concatenate((main_value, lagrange_mat @ solution))

        residual = base_vec - main_value
        if sg_operator is not None:
            with tracer.stage("picard-vms-advection"):
                sg_operator.update_nonlinear_advection(solution)
            final_atol = sg_operator.convergence.absolute_tolerance
            eta_abs: float | None = None
            if vms_inexact:
                # The outer residual this iteration will see: the previous
                # one, or the forcing's magnitude before the first.
                r_scale = (
                    residuals[iter_cnt - 1] if iter_cnt > 0 else float(np.abs(base_vec).max())
                )
                factor = sg_operator.anticipate_factor
                if not (factor > 0 and r_scale <= factor * exit_threshold):
                    eta_abs = max(final_atol, sg_operator.inexact_eta * r_scale)
            with tracer.stage("picard-vms-unresolved"):
                unresolved_scales = sg_operator.compute_unresolved_contributions(
                    solution, unresolved_scales, atol_override=eta_abs
                )
            vms_loosened = eta_abs is not None and eta_abs > final_atol
            residual -= sg_operator.fine_results_to_coarse_dofs(unresolved_scales, dual=True)

        max_residual = float(np.abs(residual).max())
        residuals[iter_cnt] = max_residual
        if print_residual:
            if progress_tracker is None:
                progress_tracker = ProgressTracker(
                    atol, max_residual, max_residual, max_iterations, err_width=20
                )
            else:
                progress_tracker.update_iteration(max_residual)
            import sys as _sys

            _end = "\r" if _sys.stdout.isatty() else "\n"
            print(progress_tracker.state_str("{} - {} | {}"), end=_end, flush=True)

        if not (max_residual > atol and max_residual > max_mag * rtol):
            if not (vms_inexact and vms_loosened):
                break
            # The exit was measured through a loosened unresolved-scale
            # solve: re-solve at the configured tolerance (warm-started)
            # and re-measure before accepting convergence.
            with tracer.stage("picard-vms-unresolved"):
                unresolved_scales = sg_operator.compute_unresolved_contributions(
                    solution, unresolved_scales
                )
            vms_loosened = False
            residual = (
                base_vec
                - main_value
                - sg_operator.fine_results_to_coarse_dofs(unresolved_scales, dual=True)
            )
            max_residual = float(np.abs(residual).max())
            residuals[iter_cnt] = max_residual
            if not (max_residual > atol and max_residual > max_mag * rtol):
                break

        if newton and iter_cnt > 0:
            # Exact-Newton step without refactorizing: solve J_k d = r by
            # defect correction preconditioned with the frozen initial
            # factorization.  Falls back to a fresh host factorization of
            # the Jacobian when the frozen preconditioner no longer
            # contracts (the iterate drifted far).
            with tracer.stage("newton-jacobian"):
                jac_blocks = evaluator.element_jacobians(solution)
            with tracer.stage("picard-solve"):
                d_solution, ok = _preconditioned_newton_solve(
                    solver, evaluator, jac_blocks, lagrange_mat, residual, rel_tol=1e-12
                )
                if not ok:
                    solver = FrozenSaddleSolver(
                        evaluator.matrices_per_leaf(jac_blocks),
                        lagrange_mat,
                        evaluator.disc.buckets[0].batch.device,
                    )
                    d_solution = solver.solve(residual)
        else:
            with tracer.stage("picard-solve"):
                d_solution = solver.solve(residual)
        n_lag = global_lagrange.size
        if use_aa:
            x_k = (
                np.concatenate((solution, global_lagrange))
                if n_lag
                else np.array(solution)
            )
            # Residual growth means the local linearization shifted (or the
            # VMS forcing moved); stale pairs then extrapolate the wrong
            # map — restart the window.
            grew = iter_cnt >= 1 and residuals[iter_cnt] > residuals[iter_cnt - 1]
            x_new = anderson_step(
                aa_x, aa_f, x_k, relax * np.asarray(d_solution), anderson_m, grew
            )
            if n_lag:
                solution = x_new[:-n_lag]
                global_lagrange = x_new[-n_lag:]
            else:
                solution = x_new
        elif n_lag:
            solution = solution + relax * d_solution[:-n_lag]
            global_lagrange = global_lagrange + relax * d_solution[-n_lag:]
        else:
            solution = solution + relax * d_solution
        iter_cnt += 1
        if checkpoint_cb is not None:
            checkpoint_cb(iter_cnt, solution, global_lagrange, unresolved_scales)

    if not return_all_residuals:
        return solution, global_lagrange, iter_cnt, np.array(max_residual), unresolved_scales
    return solution, global_lagrange, iter_cnt, residuals, unresolved_scales


# ---------------------------------------------------------------------------
# DoF conversions and time-march helpers
# ---------------------------------------------------------------------------


def compute_element_dual_from_primal_global(
    disc: Discretization, primal: np.ndarray
) -> np.ndarray:
    """Apply the per-form mass matrices to the whole solution vector."""
    out = np.zeros_like(primal)
    for bucket in disc.buckets:
        out[bucket.gather] = to_host(
            apply_mass(
                disc.form_spec,
                bucket.batch,
                _to_device(primal[bucket.gather], bucket),
                inverse=False,
            )
        )
    return out


def compute_element_primal_from_dual_global(
    disc: Discretization, dual: np.ndarray
) -> np.ndarray:
    """Apply the per-form inverse mass matrices to the whole vector."""
    out = np.zeros_like(dual)
    for bucket in disc.buckets:
        out[bucket.gather] = to_host(
            apply_mass(
                disc.form_spec,
                bucket.batch,
                _to_device(dual[bucket.gather], bucket),
                inverse=True,
            )
        )
    return out


def compute_initial_solution(
    disc: Discretization,
    system: KFormSystem,
    initial_conditions: Mapping[KFormUnknown, Callable],
) -> tuple[np.ndarray, np.ndarray]:
    """Project initial conditions: returns (dual dofs, primal dofs)."""
    dual = np.zeros(disc.n_dofs)
    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        offsets = disc.form_spec.form_offsets(p1, p2)
        parts = []
        for i, form in enumerate(disc.form_spec.iter_forms()):
            n = offsets[i + 1] - offsets[i]
            func = initial_conditions.get(form)
            if func is None:
                parts.append(np.zeros((bucket.batch.n_elements, n)))
            else:
                parts.append(
                    np.asarray(element_dual_dofs(form.order, bucket.batch, func))
                )
        dual[bucket.gather] = np.concatenate(parts, axis=1)
    primal = compute_element_primal_from_dual_global(disc, dual)
    return dual, primal


def find_time_carry_indices(
    unknowns: Sequence[int],
    form_specs: ElementFormSpecification,
    order_1: int,
    order_2: int,
) -> npt.NDArray[np.uint32]:
    """DoF indices (within one element) carried by the time march."""
    output: list[npt.NDArray[np.uint32]] = []
    for iu, u in enumerate(unknowns):
        if iu > 0 and unknowns[iu - 1] >= u:
            raise ValueError("Unknowns must be sorted.")
        offset = form_specs.form_offset(u, order_1, order_2)
        size = form_specs.form_size(u, order_1, order_2)
        output.append(offset + np.arange(size, dtype=np.uint32))
    return np.concatenate(output, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Output reconstruction
# ---------------------------------------------------------------------------


def reconstruct_mesh_from_solution(
    disc: Discretization,
    recon_order: int | None,
    solution: np.ndarray,
    vms_solution: np.ndarray | None = None,
) -> ReconstructedGrid:
    """Sample every form on a per-element nodal grid (VTK Lagrange cells).

    Reconstruction is vectorized per order bucket (reconstruct_batched) on
    the host.  ``vms_solution``, the VMS fine scales as coarse dual DoFs,
    adds the ``vms-<form>`` point data: the masses turn it into primal DoFs
    on the device.
    """
    from mfv2d_torch.projection import reconstruct_batched

    form_spec = disc.form_spec
    n_leaves = disc.n_leaves
    per_leaf_points: list[np.ndarray | None] = [None] * n_leaves
    per_leaf_forms: list[dict | None] = [None] * n_leaves
    per_leaf_vms: list[dict | None] = [None] * n_leaves
    order_list = [tuple(int(v) for v in disc.element_orders[i]) for i in range(n_leaves)]

    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        ro = max(p1, p2) if recon_order is None else recon_order
        nodes = np.linspace(-1.0, 1.0, ro + 1)
        xi = nodes[None, :]
        eta = nodes[:, None]
        corners = bucket.batch.corners_np
        e = corners.shape[0]
        # Physical points via bilinear interpolation (NumPy).
        b11 = (1 - xi) / 2
        b12 = (1 + xi) / 2
        b21 = (1 - eta) / 2
        b22 = (1 + eta) / 2
        cx = corners[..., 0][:, :, None, None]
        cy = corners[..., 1][:, :, None, None]
        ex = (cx[:, 0] * b11 + cx[:, 1] * b12) * b21 + (
            cx[:, 3] * b11 + cx[:, 2] * b12
        ) * b22
        ey = (cy[:, 0] * b11 + cy[:, 1] * b12) * b21 + (
            cy[:, 3] * b11 + cy[:, 2] * b12
        ) * b22

        dofs = np.asarray(solution)[bucket.gather]
        basis = bucket.batch.basis
        offsets = form_spec.form_offsets(p1, p2)
        form_vals = {}
        vms_vals = {}
        for idx, (name, order) in enumerate(form_spec):
            fd = dofs[:, offsets[idx] : offsets[idx + 1]]
            vals = reconstruct_batched(corners, basis, order, fd, xi, eta)
            shape = (e, -1, 2) if order == UnknownFormOrder.FORM_ORDER_1 else (e, -1)
            form_vals[name] = np.reshape(vals, shape)
            if vms_solution is not None:
                vdofs = _to_device(
                    np.asarray(vms_solution)[bucket.gather][:, offsets[idx] : offsets[idx + 1]],
                    bucket,
                )
                m = bucket.batch.mass(order, False)
                vdofs = to_host(torch.linalg.solve(m, vdofs[..., None])[..., 0])
                vvals = reconstruct_batched(corners, basis, order, vdofs, xi, eta)
                vms_vals[name] = np.reshape(vvals, shape)

        for j, rank in enumerate(bucket.leaf_ranks):
            rank = int(rank)
            per_leaf_points[rank] = np.stack(
                [ex[j].ravel(), ey[j].ravel()], axis=1
            )
            per_leaf_forms[rank] = {k: v[j] for k, v in form_vals.items()}
            if vms_solution is not None:
                per_leaf_vms[rank] = {k: v[j] for k, v in vms_vals.items()}

    cell_arrays: list[np.ndarray] = []
    node_cnt = 0
    xy_parts: list[np.ndarray] = []
    build: dict[str, list[np.ndarray]] = {n: [] for n in form_spec.names}
    vms_build: dict[str, list[np.ndarray]] = (
        {n: [] for n in form_spec.names} if vms_solution is not None else {}
    )
    for rank in range(n_leaves):
        p1, p2 = order_list[rank]
        ro = max(p1, p2) if recon_order is None else recon_order
        ordering = vtk_lagrange_ordering(ro).astype(np.int64) + node_cnt
        cell_arrays.append(np.concatenate(((ordering.size,), ordering)))
        node_cnt += ordering.size
        xy_parts.append(per_leaf_points[rank])
        for name in form_spec.names:
            build[name].append(per_leaf_forms[rank][name])
        for name in vms_build:
            vms_build[name].append(per_leaf_vms[rank][name])

    xy = np.concatenate(xy_parts, axis=0)
    points = np.concatenate([xy, np.zeros((node_cnt, 1))], axis=1)
    grid = ReconstructedGrid(
        points=points,
        cells=np.concatenate(cell_arrays).astype(np.int64),
        cell_types=np.full(n_leaves, VTK_LAGRANGE_QUADRILATERAL, np.uint8),
    )
    for name in build:
        grid.point_data[name] = np.concatenate(build[name], axis=0)
    for name in vms_build:
        grid.point_data["vms-" + name] = np.concatenate(vms_build[name], axis=0)
    grid.cell_data["orders"] = np.array(order_list)
    return grid
