"""The main solver entry point: the steady hybridized MSEM solve.

Orchestrates the pipeline (reference: python/mfv2d/solve_system_2d.py):

1. compile the k-form system to block op-lists,
2. bucket the mesh leaves by order and build batched element spaces on the
   requested device,
3. assemble batched element matrices + forcing + Lagrange constraints,
4. set up the linear solver once: host SuperLU of the frozen saddle system
   (``linear_solver="direct"``), a dense device LU (``"dense"``), or the
   element-local trace solvers (``"schur"``, ``"schur_direct"``, ``"pcg"``,
   ``"gmres"``),
5. run the Picard loop,
6. reconstruct the output grids.

Only the steady branch with ``method="picard"`` is ported so far; every
other input raises ``NotImplementedError`` naming the ROADMAP item that
will port it.
"""

from __future__ import annotations

import time
from collections.abc import Sequence

import numpy as np

from mfv2d_torch.compiler import CompiledSystem
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.solver.discretization import discretize_mesh
from mfv2d_torch.solver.solve import (
    ConvergenceSettings,
    FrozenSaddleSolver,
    SolutionStatistics,
    SolverSettings,
    SystemEvaluator,
    SystemSettings,
    TimeSettings,
    VMSSettings,
    compute_initial_solution,
    compute_linear_system,
    non_linear_solve_run,
    reconstruct_mesh_from_solution,
)
from mfv2d_torch.vis import ReconstructedGrid


def _not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to mfv2d_torch yet (ROADMAP 'Modules still"
        f" to port', item {item})."
    )


def _check_ported(
    solver_settings: SolverSettings,
    time_settings,
    refinement_settings,
    vms_settings,
    checkpoint_settings,
) -> None:
    if time_settings is not None:
        raise _not_ported("time_settings (time marches)", "6")
    if refinement_settings is not None:
        raise _not_ported("refinement_settings (hp refinement)", "7")
    if vms_settings is not None:
        raise _not_ported("vms_settings (VMS)", "9")
    if solver_settings.device_mesh is not None:
        raise _not_ported("SolverSettings.device_mesh (multi-device)", "10")
    if checkpoint_settings is not None:
        raise _not_ported("checkpoint_settings (checkpoints)", "11")
    if solver_settings.method != "picard":
        raise _not_ported(f"method={solver_settings.method!r} (Newton)", "4")


def solve_system_2d(
    mesh: Mesh,
    system_settings: SystemSettings,
    solver_settings: SolverSettings = SolverSettings(),
    time_settings: TimeSettings | None = None,
    refinement_settings=None,
    vms_settings: VMSSettings | None = None,
    *,
    recon_order: int | None = None,
    print_residual: bool = False,
    checkpoint_settings=None,
    device="cuda",
) -> tuple[Sequence[ReconstructedGrid], SolutionStatistics, Mesh]:
    """Solve the steady k-form system on the mesh.

    The element work runs on ``device`` in float64: the CUDA device by
    default, the CPU only where the caller passes ``device="cpu"``.  Without
    a CUDA device the default raises; it never falls back to the CPU.
    Returns the reconstructed solution grids (the initial iterate and the
    converged one), statistics, and the mesh.
    """
    _check_ported(
        solver_settings,
        time_settings,
        refinement_settings,
        vms_settings,
        checkpoint_settings,
    )
    system = system_settings.system
    constrained_forms = system_settings.constrained_forms
    boundary_conditions = system_settings.boundary_conditions

    from mfv2d_torch.boundary import BoundaryCondition2DUnsteady
    from mfv2d_torch.kform import KExplicit, TimeDependent
    from mfv2d_torch.tracing import tracer

    if any(
        isinstance(bc, BoundaryCondition2DUnsteady)
        for bc in (boundary_conditions or [])
    ):
        raise ValueError("Unsteady boundary conditions require time_settings.")
    if any(
        isinstance(f, KExplicit) and isinstance(f.func, TimeDependent)
        for eq in system.equations
        for _, f in eq.right.explicit_terms
    ):
        raise ValueError("TimeDependent forcing requires time_settings.")
    for _, form in constrained_forms:
        if form not in system.unknown_forms:
            raise ValueError(
                f"Form {form} which is to be zeroed is not involved in the system."
            )
        if boundary_conditions and form in (bc.form for bc in boundary_conditions):
            raise ValueError(
                f"Form {form} can not be zeroed because it is involved in a strong"
                " boundary condition."
            )

    basis_cache = FemCache(order_difference=system_settings.over_integration_order)

    # The evaluator host-evaluates callable fields at construction, so any
    # TimeDependent clock state left over from a previous march must reset
    # BEFORE setup.
    TimeDependent.current_time = 0.0
    with tracer.stage("setup"):
        compiled = CompiledSystem(system)
        disc = discretize_mesh(mesh, system.unknown_forms, basis_cache, device)
        evaluator = SystemEvaluator(system.unknown_forms, compiled, disc)

    if any(isinstance(f, TimeDependent) for f in compiled.fields):
        raise ValueError(
            "TimeDependent interior-product (operator) fields require"
            " time_settings."
        )

    if system_settings.initial_conditions:
        _, solution = compute_initial_solution(
            disc, system, system_settings.initial_conditions
        )
        initial_solution = solution
    else:
        solution = np.zeros(disc.n_dofs)
        initial_solution = None

    with tracer.stage("assembly+constraints"):
        forcing, matrices, lagrange_mat, lagrange_vec = compute_linear_system(
            disc,
            system,
            evaluator,
            constrained_forms,
            boundary_conditions if boundary_conditions is not None else [],
            initial_solution,
        )

    explicit_vec = forcing
    if lagrange_mat is not None:
        explicit_vec = np.concatenate((forcing, lagrange_vec))

    t_factor = time.perf_counter()
    if solver_settings.linear_solver == "direct":
        solver = FrozenSaddleSolver(
            evaluator.matrices_per_leaf(matrices), lagrange_mat
        )
    elif solver_settings.linear_solver == "dense":
        from mfv2d_torch.solver.iterative import DenseSaddleSolver

        solver = DenseSaddleSolver(disc, matrices, lagrange_mat)
    else:
        from mfv2d_torch.solver.iterative import IterativeSaddleSolver

        solver = IterativeSaddleSolver(
            disc,
            matrices,
            lagrange_mat,
            ConvergenceSettings(
                maximum_iterations=max(
                    200, 4 * (disc.n_dofs + int(lagrange_vec.size))
                ),
                absolute_tolerance=solver_settings.convergence.absolute_tolerance
                * 1e-3,
                relative_tolerance=1e-12,
            ),
            method=solver_settings.linear_solver,
        )
    tracer.add("factorize", time.perf_counter() - t_factor)

    t_solve = time.perf_counter()
    global_lagrange = np.zeros_like(lagrange_vec)
    max_mag = float(np.abs(explicit_vec).max())
    conv = solver_settings.convergence

    grid = reconstruct_mesh_from_solution(disc, recon_order, solution)
    grid.field_data["time"] = np.array([0.0])
    resulting_grids: list[ReconstructedGrid] = [grid]

    solution, global_lagrange, iter_cnt, all_residuals = non_linear_solve_run(
        conv.maximum_iterations,
        solver_settings.relaxation,
        conv.absolute_tolerance,
        conv.relative_tolerance,
        print_residual,
        evaluator,
        explicit_vec,
        solution,
        global_lagrange,
        max_mag,
        solver,
        lagrange_mat,
        return_all_residuals=True,
        anderson_m=solver_settings.anderson_m,
    )
    resulting_grids.append(
        reconstruct_mesh_from_solution(disc, recon_order, solution)
    )
    tracer.add("solve+reconstruct", time.perf_counter() - t_solve)

    orders, counts = np.unique(disc.element_orders, axis=0, return_counts=True)
    stats = SolutionStatistics(
        element_orders={
            (int(o[0]), int(o[1])): int(c) for o, c in zip(orders, counts)
        },
        n_total_dofs=explicit_vec.size,
        n_lagrange=int(lagrange_vec.size),
        n_elems=mesh.element_count,
        n_leaves=mesh.leaf_count,
        n_leaf_dofs=disc.n_dofs,
        iter_history=np.array((iter_cnt,), np.uint32),
        residual_history=np.asarray(all_residuals)[:iter_cnt],
    )
    if tracer.enabled:
        print(tracer.report())
    return tuple(resulting_grids), stats, mesh
