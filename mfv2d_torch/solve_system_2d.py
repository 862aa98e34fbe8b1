"""The main solver entry point: steady/unsteady hybridized MSEM solve.

Orchestrates the pipeline (reference: python/mfv2d/solve_system_2d.py):

1. compile the k-form system to block op-lists,
2. bucket the mesh leaves by order and build batched element spaces on the
   requested device,
3. assemble batched element matrices + forcing + Lagrange constraints,
4. set up the linear solver once: host SuperLU of the frozen saddle system
   (``linear_solver="direct"``), a dense device LU (``"dense"``), or the
   element-local trace solvers (``"schur"``, ``"schur_direct"``, ``"pcg"``,
   ``"gmres"``),
5. run the Picard or Newton loop (and the trapezoidal time march when
   requested): on the host over the frozen solver, or, with ``"dense"``,
   as device loops (solver/fused.py),
6. reconstruct the output grids,
7. with ``refinement_settings``, estimate the element errors and return the
   hp-refined mesh (refinement.py).

With ``vms_settings`` the Picard loop carries the VMS fine scales
(solver/vms.py) and the output grids their ``vms-<form>`` point data.
With ``checkpoint_settings`` marches and steady solves save their state and
resume from it (checkpoint.py), on the host loops.  With
``SolverSettings.device_mesh`` the solve runs element-sharded over
``torch.distributed`` (parallel/sharding.py, parallel/vms.py), with every
option the single-device path takes: Picard and Newton, the marches, VMS,
checkpoints and refinement.
"""

from __future__ import annotations

import os
import time
from collections.abc import Sequence

import numpy as np

from mfv2d_torch.compiler import CompiledSystem
from mfv2d_torch.kform import KEquation
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.progress import HistogramFormat
from mfv2d_torch.refinement import perform_mesh_refinement
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
    compute_element_dual_from_primal_global,
    compute_forcing_vector,
    compute_initial_solution,
    compute_linear_system,
    find_time_carry_indices,
    non_linear_solve_run,
    reconstruct_mesh_from_solution,
)
from mfv2d_torch.system import KFormSystem
from mfv2d_torch.tracing import tracer
from mfv2d_torch.vis import ReconstructedGrid


def _check_state_size(state: dict, n_dofs: int) -> dict:
    if state["solution"].size != n_dofs:
        raise ValueError(
            "Checkpoint DoF count does not match the mesh/system:"
            f" {state['solution'].size} != {n_dofs}."
        )
    return state


def _steady_checkpointer(checkpoint_settings, n_dofs: int, writes: bool = True):
    """Steady resume state and save hook, in the JAX package's file format.

    Returns ``(state, save)``: the state loaded from ``resume_from`` (None
    where there is none; a missing file means a first attempt), and
    ``save(iterations, solution, lagrange, unresolved, final=False)``, which
    writes every ``every`` iterations of this attempt and always at the end.
    The iteration count and the elapsed time add on to the resumed file's.
    Only a caller with ``writes`` writes the file.
    """
    from mfv2d_torch.checkpoint import load_steady_state, save_steady_state

    state = None
    resume = checkpoint_settings.resume_from
    if resume and os.path.exists(resume):
        state = _check_state_size(load_steady_state(resume), n_dofs)
    prior_iterations = 0 if state is None else state["iteration"]
    prior_elapsed = 0.0 if state is None else state["elapsed"]
    t0 = time.perf_counter()
    every = max(1, checkpoint_settings.every)

    def save(iterations, solution, lagrange, unresolved, final=False) -> None:
        if writes and (final or iterations % every == 0):
            save_steady_state(
                checkpoint_settings.path,
                solution,
                lagrange,
                unresolved,
                prior_iterations + iterations,
                prior_elapsed + time.perf_counter() - t0,
            )

    return state, save


def _check_vms_settings(
    system_settings: SystemSettings, vms_settings: VMSSettings | None
) -> None:
    if vms_settings is None:
        return
    system = system_settings.system
    for name, sub in (
        ("symmetric", vms_settings.symmetric_system),
        ("nonsymmetric", vms_settings.nonsymmetric_system),
    ):
        if sub.unknown_forms != system.unknown_forms:
            raise ValueError(
                f"VMS {name} system does not contain the same forms in the"
                " matching order as the full system."
            )
    if vms_settings.order_increase > system_settings.over_integration_order:
        raise ValueError("VMS order increase exceeds the over-integration order.")


def _vms_to_coarse(sg_operator, fine_scales, disc):
    """Project fine-scale VMS results to coarse dual DoFs for output.

    The reference slices the fine-space vector with coarse offsets
    (solve_system.py:233-239), which misaligns for order_increase > 0; the
    dual projection is the consistent restriction.
    """
    if fine_scales is None or sg_operator is None:
        return None
    return sg_operator.fine_results_to_coarse_dofs(fine_scales, dual=True)[: disc.n_dofs]



def _make_solver(solver_settings: SolverSettings, disc, evaluator, matrices,
                 lagrange_mat, n_lagrange: int):
    """The frozen linear solver that ``linear_solver`` names."""
    if solver_settings.linear_solver == "direct":
        return FrozenSaddleSolver(
            evaluator.matrices_per_leaf(matrices), lagrange_mat, disc.buckets[0].batch.device
        )
    if solver_settings.linear_solver == "dense":
        from mfv2d_torch.solver.iterative import DenseSaddleSolver

        return DenseSaddleSolver(disc, matrices, lagrange_mat)
    from mfv2d_torch.solver.iterative import IterativeSaddleSolver

    return IterativeSaddleSolver(
        disc,
        matrices,
        lagrange_mat,
        ConvergenceSettings(
            maximum_iterations=max(200, 4 * (disc.n_dofs + n_lagrange)),
            absolute_tolerance=solver_settings.convergence.absolute_tolerance * 1e-3,
            relative_tolerance=1e-12,
        ),
        method=solver_settings.linear_solver,
    )


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
    """Solve the k-form system on the mesh, steady or as a trapezoidal march.

    The element work runs on ``device`` in float64: the CUDA device by
    default, the CPU only where the caller passes ``device="cpu"``.  Without
    a CUDA device the default raises; it never falls back to the CPU.
    Returns the reconstructed solution grids (the initial state, then the
    converged steady solution or one grid per sampled time step, each with
    its ``time`` field), statistics, and the mesh: with
    ``refinement_settings`` the refined mesh, whose last grid carries the
    ``error_estimate`` and ``h_ref_cost_estimate`` cell data.
    """
    with tracer.solve():
        return _solve(
            mesh, system_settings, solver_settings, time_settings, refinement_settings,
            vms_settings, recon_order, print_residual, checkpoint_settings, device,
        )


def _solve(
    mesh: Mesh,
    system_settings: SystemSettings,
    solver_settings: SolverSettings,
    time_settings: TimeSettings | None,
    refinement_settings,
    vms_settings: VMSSettings | None,
    recon_order: int | None,
    print_residual: bool,
    checkpoint_settings,
    device,
) -> tuple[Sequence[ReconstructedGrid], SolutionStatistics, Mesh]:
    """:func:`solve_system_2d`'s work, inside its tracer solve."""
    _check_vms_settings(system_settings, vms_settings)
    system = system_settings.system
    constrained_forms = system_settings.constrained_forms
    boundary_conditions = system_settings.boundary_conditions

    from mfv2d_torch.boundary import (
        BoundaryCondition2DUnsteady,
        freeze_unsteady_boundary_conditions,
    )
    from mfv2d_torch.kform import KExplicit, TimeDependent

    has_unsteady_bcs = any(
        isinstance(bc, BoundaryCondition2DUnsteady)
        for bc in (boundary_conditions or [])
    )
    has_td_rhs = any(
        isinstance(f, KExplicit) and isinstance(f.func, TimeDependent)
        for eq in system.equations
        for _, f in eq.right.explicit_terms
    )
    if has_td_rhs and time_settings is None:
        raise ValueError("TimeDependent forcing requires time_settings.")
    if has_unsteady_bcs:
        if time_settings is None:
            raise ValueError("Unsteady boundary conditions require time_settings.")
        # Step n solves for t = (n + 1) dt; the initial system is frozen at
        # the first time level and re-evaluated inside the march loop.
        boundary_conditions = freeze_unsteady_boundary_conditions(
            boundary_conditions, time_settings.dt
        )
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

    if time_settings is not None:
        if time_settings.sample_rate < 1:
            raise ValueError("Sample rate can not be less than 1.")
        if len(time_settings.time_march_relations) < 1:
            raise ValueError("Problem has no time march relations.")
        system = update_system_for_time_march(time_settings, system)

    if solver_settings.device_mesh is not None:
        return _solve_sharded(
            mesh,
            system_settings,
            solver_settings,
            time_settings,
            basis_cache,
            recon_order,
            boundary_conditions,
            has_unsteady_bcs=has_unsteady_bcs,
            has_td_rhs=has_td_rhs,
            vms_settings=vms_settings,
            refinement_settings=refinement_settings,
            checkpoint_settings=checkpoint_settings,
        )

    # The evaluator host-evaluates callable fields at construction, so any
    # TimeDependent clock state left over from a previous march must reset
    # BEFORE setup.
    TimeDependent.current_time = 0.0
    with tracer.stage("setup"):
        compiled = CompiledSystem(system)
        disc = discretize_mesh(mesh, system.unknown_forms, basis_cache, device)
        evaluator = SystemEvaluator(system.unknown_forms, compiled, disc)

    # Time-dependent OPERATOR coefficients (interior-product fields): the
    # march re-evaluates the field, re-assembles the frozen element matrices
    # and refactorizes at every time level.  Steady solves have no time to
    # evaluate at.
    has_td_fields = any(isinstance(f, TimeDependent) for f in compiled.fields)
    if has_td_fields and time_settings is None:
        raise ValueError(
            "TimeDependent interior-product (operator) fields require"
            " time_settings."
        )
    if has_td_fields and vms_settings is not None:
        raise NotImplementedError(
            "TimeDependent operator fields with vms_settings are not"
            " supported: the fine-scale operator would need per-step"
            " reconstruction.  March without VMS, or freeze the field."
        )

    if system_settings.initial_conditions:
        initial_dual, solution = compute_initial_solution(
            disc, system, system_settings.initial_conditions
        )
        initial_solution = solution
    else:
        initial_dual = None
        solution = np.zeros(disc.n_dofs)
        initial_solution = None

    # Time-carry bookkeeping: the rows of the marched equations.
    if time_settings is not None:
        march_indices = tuple(
            sorted(
                system.weight_forms.index(form)
                for form in time_settings.time_march_relations
            )
        )
        time_carry_index_array = np.concatenate(
            [
                find_time_carry_indices(
                    march_indices,
                    system.unknown_forms,
                    *(int(v) for v in disc.element_orders[i]),
                )
                + disc.element_offsets[i]
                for i in range(disc.n_leaves)
            ]
        )
        if initial_dual is not None:
            old_solution_carry = initial_dual[time_carry_index_array]
        else:
            old_solution_carry = np.zeros(time_carry_index_array.size)
    else:
        time_carry_index_array = None
        old_solution_carry = None

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

    time_carry_term = None
    if time_settings is not None:
        if initial_solution is not None:
            # Consistent trapezoidal start: carry_0 = F_0 - A u_0 (the
            # reference uses F_0 regardless of the initial state, which
            # injects an O(dt) transient on the first step when u_0 != 0).
            # residual_value includes the marched 2/dt mass term, which
            # equals 2/dt * dual(u_0) on the carry rows, so it is added back.
            spatial = explicit_vec[: disc.n_dofs] - evaluator.residual_value(solution)
            time_carry_term = (
                spatial[time_carry_index_array]
                + 2.0 / time_settings.dt * old_solution_carry
            )
        else:
            time_carry_term = explicit_vec[time_carry_index_array]

    n_lagrange = int(lagrange_vec.size)
    with tracer.stage("factorize"):
        solver = _make_solver(
            solver_settings, disc, evaluator, matrices, lagrange_mat, n_lagrange
        )

    sg_operator = None
    if vms_settings is not None:
        from mfv2d_torch.solver.vms import SuyashGreenOperator

        with tracer.stage("vms-init"):
            sg_operator = SuyashGreenOperator(
                system,
                vms_settings,
                disc,
                evaluator,
                constrained_forms,
                boundary_conditions if boundary_conditions is not None else [],
            )
    fine_scales = None

    t_solve = time.perf_counter()
    global_lagrange = np.zeros_like(lagrange_vec)
    max_mag = float(np.abs(explicit_vec).max())
    conv = solver_settings.convergence
    max_iterations = conv.maximum_iterations
    relax = solver_settings.relaxation
    atol = conv.absolute_tolerance
    rtol = conv.relative_tolerance
    newton = solver_settings.method == "newton"

    # Resume from a checkpoint: a march restores its solution, multipliers
    # and trapezoidal carry and skips the steps already taken; a steady solve
    # restores its iterate and the VMS fine scales.
    start_index = 0
    steady_save = None
    if checkpoint_settings is not None and time_settings is None:
        state, steady_save = _steady_checkpointer(checkpoint_settings, disc.n_dofs)
        if state is not None:
            solution = state["solution"]
            global_lagrange = state["lagrange"]
            fine_scales = state["fine_scales"]
    elif checkpoint_settings is not None and checkpoint_settings.resume_from:
        from mfv2d_torch.checkpoint import load_march_state

        state = _check_state_size(load_march_state(checkpoint_settings.resume_from), disc.n_dofs)
        solution = state["solution"]
        global_lagrange = state["lagrange"]
        old_solution_carry = state["old_carry"]
        time_carry_term = state["carry_term"]
        start_index = state["time_index"]

    # The first grid shows the state the solve starts from, at its time.
    with tracer.stage("reconstruct"):
        grid = reconstruct_mesh_from_solution(disc, recon_order, solution)
    grid.field_data["time"] = np.array(
        [start_index * time_settings.dt if time_settings is not None else 0.0]
    )
    resulting_grids: list[ReconstructedGrid] = [grid]

    # The dense solver runs its loops on the device (solver/fused.py) unless
    # something forces a host loop: VMS, per-iteration output, checkpoints,
    # or a march whose boundary values, forcing or operator change with time.
    fused = (
        solver_settings.linear_solver == "dense"
        and sg_operator is None
        and not print_residual
        and checkpoint_settings is None
        and not has_unsteady_bcs
        and not has_td_rhs
        and not has_td_fields
    )
    linear = compiled.rhs_blocks is None and compiled.nonlin_blocks is None
    if time_settings is not None and fused:
        from mfv2d_torch.solver import fused as fused_loops

        nt = time_settings.nt
        dt = time_settings.dt
        if linear:
            # Linear march: one device solve per step.
            us, sample_steps, global_lagrange = fused_loops.fused_linear_time_march(
                disc, matrices, lagrange_mat, explicit_vec, time_carry_index_array,
                solution, old_solution_carry, np.asarray(time_carry_term), dt, nt,
                time_settings.sample_rate,
            )
            changes = np.zeros(nt)
            iters = np.ones(nt, np.uint32)
        else:
            march, extra = (
                (fused_loops.fused_newton_time_march, {})
                if newton
                else (
                    fused_loops.fused_nonlinear_time_march,
                    {"anderson_m": solver_settings.anderson_m},
                )
            )
            us, sample_steps, global_lagrange, iters, changes = march(
                disc, evaluator, matrices, lagrange_mat, explicit_vec,
                time_carry_index_array, solution, old_solution_carry,
                np.asarray(time_carry_term), dt, nt, max_iterations, relax, atol,
                rtol, max_mag, time_settings.sample_rate, **extra,
            )
        for s_i, time_index in enumerate(sample_steps):
            with tracer.stage("reconstruct"):
                grid = reconstruct_mesh_from_solution(disc, recon_order, us[s_i])
            grid.field_data["time"] = np.array([(int(time_index) + 1) * dt])
            resulting_grids.append(grid)
        solution = us[-1]
    elif time_settings is not None:
        nt = time_settings.nt
        dt = time_settings.dt
        changes = np.zeros(nt)
        iters = np.zeros(nt, np.uint32)
        rebuild_each_step = has_unsteady_bcs or has_td_rhs
        pure_forcing = (
            compute_forcing_vector(disc, system)
            if (has_unsteady_bcs and not has_td_rhs)
            else None
        )
        for time_index in range(start_index, nt):
            with tracer.stage("march-step"):
                tracer.count("march_steps")
                t_next = (time_index + 1) * dt
                if has_td_fields:
                    # TimeDependent OPERATOR fields: re-evaluate the field at the
                    # new time level, re-assemble the frozen element matrices,
                    # forcing and constraint values, and refactorize.
                    TimeDependent.current_time = t_next
                    evaluator.refresh_static_fields()
                    bcs_t = (
                        freeze_unsteady_boundary_conditions(
                            system_settings.boundary_conditions or [], t_next
                        )
                        if has_unsteady_bcs
                        else (boundary_conditions or [])
                    )
                    with tracer.stage("assembly+constraints"):
                        forcing, matrices, _, lagrange_vec_t = compute_linear_system(
                            disc, system, evaluator, constrained_forms, bcs_t, solution
                        )
                    explicit_vec = (
                        np.concatenate((forcing, lagrange_vec_t))
                        if lagrange_mat is not None
                        else forcing
                    )
                    max_mag = float(np.abs(explicit_vec).max())
                    with tracer.stage("factorize"):
                        solver = _make_solver(
                            solver_settings, disc, evaluator, matrices, lagrange_mat, n_lagrange
                        )
                elif rebuild_each_step and (time_index > 0 or has_td_rhs):
                    # Re-evaluate time-dependent boundary values / forcing at the
                    # new time level; the constraint matrix itself is
                    # time-independent.
                    from mfv2d_torch.continuity import add_system_constraints

                    if has_td_rhs:
                        TimeDependent.current_time = t_next
                    frozen = freeze_unsteady_boundary_conditions(
                        system_settings.boundary_conditions or [], t_next
                    )
                    forcing_t = (
                        compute_forcing_vector(disc, system)
                        if has_td_rhs
                        else pure_forcing.copy()
                    )
                    vec_views = [
                        forcing_t[disc.element_offsets[i] : disc.element_offsets[i + 1]]
                        for i in range(disc.n_leaves)
                    ]
                    _, lagrange_vec_t = add_system_constraints(
                        system,
                        mesh,
                        basis_cache,
                        constrained_forms,
                        frozen,
                        disc.leaf_indices,
                        disc.element_offsets,
                        vec_views,
                    )
                    explicit_vec = (
                        np.concatenate((forcing_t, lagrange_vec_t))
                        if lagrange_mat is not None
                        else forcing_t
                    )
                    max_mag = float(np.abs(explicit_vec).max())
                current_carry = 2 / dt * old_solution_carry + time_carry_term

                (
                    solution,
                    global_lagrange,
                    iter_cnt,
                    max_residual,
                    fine_scales,
                ) = non_linear_solve_run(
                    max_iterations,
                    relax,
                    atol,
                    rtol,
                    print_residual,
                    evaluator,
                    explicit_vec,
                    solution,
                    global_lagrange,
                    max_mag,
                    solver,
                    lagrange_mat,
                    anderson_m=solver_settings.anderson_m,
                    time_carry_index_array=time_carry_index_array,
                    time_carry_term=current_carry,
                    newton=newton,
                    fine_scales=fine_scales,
                    sg_operator=sg_operator,
                )
                changes[time_index] = float(max_residual)
                iters[time_index] = iter_cnt

                with tracer.stage("carry"):
                    projected = compute_element_dual_from_primal_global(disc, solution)
                    new_solution_carry = projected[time_carry_index_array]
                    time_carry_term = (
                        2 / dt * (new_solution_carry - old_solution_carry) - time_carry_term
                    )
                    old_solution_carry = new_solution_carry

                if checkpoint_settings is not None and (
                    (time_index + 1) % checkpoint_settings.every == 0 or time_index + 1 == nt
                ):
                    from mfv2d_torch.checkpoint import save_march_state

                    save_march_state(
                        checkpoint_settings.path,
                        mesh,
                        solution,
                        global_lagrange,
                        old_solution_carry,
                        time_carry_term,
                        time_index + 1,
                        dt,
                    )

                if (time_index % time_settings.sample_rate) == 0 or time_index + 1 == nt:
                    with tracer.stage("reconstruct"):
                        grid = reconstruct_mesh_from_solution(
                            disc,
                            recon_order,
                            solution,
                            _vms_to_coarse(sg_operator, fine_scales, disc),
                        )
                    grid.field_data["time"] = np.array([t_next])
                    resulting_grids.append(grid)

                if print_residual:
                    print(
                        f"Time step {time_index:d} finished in {iter_cnt:d} iterations"
                        f" with residual of {float(max_residual):.5e}"
                    )
    else:
        if fused:
            # Steady solve on the device: Picard with the frozen LU, or
            # exact Newton with the Jacobian saddle refactorized each
            # iteration.
            from mfv2d_torch.solver import fused as fused_loops

            loop, extra = (
                (fused_loops.fused_newton_solve, {})
                if newton
                else (
                    fused_loops.fused_picard_solve,
                    {"anderson_m": solver_settings.anderson_m},
                )
            )
            solution, global_lagrange, iter_cnt, all_residuals, _ = loop(
                disc, evaluator, matrices, lagrange_mat, explicit_vec, solution,
                global_lagrange, max_iterations, relax, atol, rtol, max_mag, **extra,
            )
        else:
            (
                solution,
                global_lagrange,
                iter_cnt,
                all_residuals,
                fine_scales,
            ) = non_linear_solve_run(
                max_iterations,
                relax,
                atol,
                rtol,
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
                newton=newton,
                fine_scales=fine_scales,
                sg_operator=sg_operator,
                checkpoint_cb=steady_save,
            )
            if steady_save is not None:
                steady_save(iter_cnt, solution, global_lagrange, fine_scales, final=True)
        changes = np.asarray(all_residuals)[:iter_cnt]
        iters = np.array((iter_cnt,), np.uint32)
        with tracer.stage("reconstruct"):
            resulting_grids.append(
                reconstruct_mesh_from_solution(
                    disc, recon_order, solution, _vms_to_coarse(sg_operator, fine_scales, disc)
                )
            )
    tracer.add("solve+reconstruct", time.perf_counter() - t_solve)

    mesh_orders = disc.element_orders
    orders, counts = np.unique(mesh_orders, axis=0, return_counts=True)
    stats = SolutionStatistics(
        element_orders={
            (int(o[0]), int(o[1])): int(c) for o, c in zip(orders, counts)
        },
        n_total_dofs=explicit_vec.size,
        n_lagrange=n_lagrange,
        n_elems=mesh.element_count,
        n_leaves=mesh.leaf_count,
        n_leaf_dofs=disc.n_dofs,
        iter_history=iters,
        residual_history=np.asarray(changes),
    )

    output_mesh = mesh
    if refinement_settings is not None:
        if refinement_settings.report_order_distribution:
            order_hist = HistogramFormat(5, 60, 5, label_format=lambda x: f"{x:.1f}")
            geo_order = np.linalg.norm(mesh_orders, axis=1) / np.sqrt(2)
            print("Initial mesh order distribution\n" + "=" * 60)
            print(order_hist.format(geo_order))
            print("=" * 60)

        t_refine = time.perf_counter()
        output_mesh, error_estimates, h_ref_cost = perform_mesh_refinement(
            disc,
            solution,
            system,
            evaluator,
            refinement_settings.error_estimate,
            refinement_settings.h_refinement_ratio,
            refinement_settings.refinement_limit,
            refinement_settings.report_error_distribution,
            boundary_conditions if boundary_conditions is not None else [],
            refinement_settings.upper_order_limit,
            refinement_settings.lower_order_limit,
            constrained_forms,
            anisotropic_p=refinement_settings.anisotropic_p,
        )
        tracer.add("refinement", time.perf_counter() - t_refine)
        resulting_grids[-1].cell_data["error_estimate"] = error_estimates
        resulting_grids[-1].cell_data["h_ref_cost_estimate"] = h_ref_cost
        if refinement_settings.report_order_distribution:
            geo_order = np.linalg.norm(
                [
                    output_mesh.get_leaf_orders(int(ie))
                    for ie in output_mesh.get_leaf_indices()
                ],
                axis=1,
            ) / np.sqrt(2)
            print("Refined mesh order distribution\n" + "=" * 60)
            print(order_hist.format(geo_order))
            print("=" * 60)

    return tuple(resulting_grids), stats, output_mesh


def _fine_to_coarse_dual(disc, dk: int, fine_scales: np.ndarray) -> np.ndarray:
    """The dual (P^T) projection of fine-scale VMS results to coarse DoFs on
    the sharded path: one inclusion-matrix product a bucket (the
    single-device ``fine_results_to_coarse_dofs(..., dual=True)``)."""
    from mfv2d_torch.evaluation import reference_inclusion_matrix
    from mfv2d_torch.parallel.vms import _fine_discretization

    fd = _fine_discretization(disc, dk)
    out = np.zeros(disc.n_dofs)
    x = np.asarray(fine_scales)
    for cb, fb in zip(disc.buckets, fd.buckets):
        c = reference_inclusion_matrix(disc.form_spec, cb.orders, fb.orders, cb.batch.device)
        out[cb.gather] = x[fb.gather] @ c
    return out


def _solve_sharded(
    mesh: Mesh,
    system_settings: SystemSettings,
    solver_settings: SolverSettings,
    time_settings: TimeSettings | None,
    basis_cache: FemCache,
    recon_order: int | None,
    boundary_conditions,
    *,
    has_unsteady_bcs: bool = False,
    has_td_rhs: bool = False,
    vms_settings: VMSSettings | None = None,
    refinement_settings=None,
    checkpoint_settings=None,
) -> tuple[Sequence[ReconstructedGrid], SolutionStatistics, Mesh]:
    """The element-sharded solve over ``solver_settings.device_mesh``.

    Every rank calls this with the same arguments and returns the same
    grids, statistics and mesh (parallel/sharding.py, parallel/vms.py).
    Routes as the JAX package's sharded branch does: a steady solve to the
    sharded Picard, Newton or VMS solve; a march to the host march when
    VMS, Newton or a checkpoint needs per-step host work, else to the
    linear or the nonlinear march.  Unsteady boundary values and
    ``TimeDependent`` forcing enter the marches as per-step data.  A steady
    solve's iteration count is its number of residual evaluations, and a
    steady solve without VMS does not read ``SolverSettings.anderson_m``.
    Checkpoints use the single-device file format, so the two paths' files
    interchange; rank 0 writes them and every rank reads them.  With
    ``refinement_settings`` every rank refines the mesh from the gathered
    solution on its own device.
    """
    from mfv2d_torch.parallel import sharding

    system = system_settings.system
    comm = sharding.trace_comm(solver_settings.device_mesh)
    conv = solver_settings.convergence
    t_solve = time.perf_counter()
    with tracer.stage("setup"):
        disc = discretize_mesh(mesh, system.unknown_forms, basis_cache, comm.device)
    bcs = list(boundary_conditions or [])
    # The marches also take the boundary conditions as the caller gave
    # them, to freeze the unsteady ones at every level.
    raw_bcs = list(system_settings.boundary_conditions or []) if has_unsteady_bcs else None
    cforms = list(system_settings.constrained_forms)
    common = dict(
        boundary_conditions=bcs,
        constrained_forms=cforms,
        cg_maximum_iterations=max(200, 4 * disc.n_dofs),
        cg_tolerance=conv.absolute_tolerance * 1e-3,
    )
    iterate = dict(
        relax=solver_settings.relaxation,
        absolute_tolerance=conv.absolute_tolerance,
        relative_tolerance=conv.relative_tolerance,
    )
    krylov = "gmres" if solver_settings.linear_solver == "gmres" else "cg"
    newton = solver_settings.method == "newton"
    initial_solution = None
    if system_settings.initial_conditions:
        _, initial_solution = compute_initial_solution(
            disc, system, system_settings.initial_conditions
        )

    grids: list[ReconstructedGrid] = []
    if time_settings is None:
        state, ckpt_cb = None, None
        if checkpoint_settings is not None:
            state, save = _steady_checkpointer(
                checkpoint_settings, disc.n_dofs, writes=comm.rank == 0
            )

            def ckpt_cb(iterations, solution, lagrange, unresolved, final=False):
                save(iterations, solution, lagrange, unresolved, final)
                comm.barrier()

        steady = dict(
            common,
            **iterate,
            maximum_iterations=conv.maximum_iterations,
            initial_solution=initial_solution if state is None else state["solution"],
            initial_lagrange=None if state is None else state["lagrange"],
            checkpoint_cb=ckpt_cb,
        )
        fine_scales = vms_dual = None
        if vms_settings is not None:
            from mfv2d_torch.parallel.vms import sharded_vms_steady_solve

            u, lam, residuals, fine_scales = sharded_vms_steady_solve(
                system, vms_settings, disc, comm, **steady,
                anderson_m=solver_settings.anderson_m,
                initial_unresolved=None if state is None else state["fine_scales"],
                newton=newton,
            )
            vms_dual = _fine_to_coarse_dual(disc, vms_settings.order_increase, fine_scales)
        else:
            solve = sharding.sharded_newton_steady_solve if newton else sharding.sharded_steady_solve
            u, lam, residuals = solve(system, disc, comm, **steady, krylov_method=krylov)
        if ckpt_cb is not None:
            # The final iterate, whatever ``every`` is; the JAX package's
            # sharded branch counts its residual evaluations here.  For VMS
            # the recovered fine scales stand in for the loop's unresolved
            # contributions: on resume they only start the inner solve.
            ckpt_cb(len(residuals), u, lam, fine_scales, final=True)
        grid = reconstruct_mesh_from_solution(disc, recon_order, u, vms_dual)
        grid.field_data["time"] = np.array([0.0])
        grids.append(grid)
        iters = np.array((len(residuals),), np.uint32)
        changes = np.asarray(residuals)
    else:
        from mfv2d_torch.checkpoint import load_march_state

        resume_state = None
        if (
            checkpoint_settings is not None
            and checkpoint_settings.resume_from
            and os.path.exists(checkpoint_settings.resume_from)
        ):
            resume_state = _check_state_size(
                load_march_state(checkpoint_settings.resume_from), disc.n_dofs
            )
        start_index = 0 if resume_state is None else resume_state["time_index"]
        if resume_state is not None:
            u0 = resume_state["solution"]
        elif initial_solution is not None:
            u0 = initial_solution
        else:
            u0 = np.zeros(disc.n_dofs)
        grid0 = reconstruct_mesh_from_solution(disc, recon_order, u0)
        grid0.field_data["time"] = np.array([start_index * time_settings.dt])
        grids.append(grid0)
        march = dict(common, unsteady_bcs=raw_bcs, has_td_rhs=has_td_rhs,
                     initial_solution=initial_solution, krylov_method=krylov)
        march_fine = None
        marched = CompiledSystem(update_system_for_time_march(time_settings, system))
        if vms_settings is not None or newton or checkpoint_settings is not None:
            # Newton, the VMS unresolved-scale solves and the checkpoint
            # writes need a step loop that does host work every step.
            us, sample_steps, lam, iters, changes, march_fine = (
                sharding.sharded_host_time_march(
                    system, disc, comm, time_settings, **march, **iterate,
                    max_iterations=conv.maximum_iterations, newton=newton,
                    vms_settings=vms_settings, anderson_m=solver_settings.anderson_m,
                    checkpoint_settings=checkpoint_settings, resume_state=resume_state,
                )
            )
        elif marched.nonlin_blocks is None and marched.rhs_blocks is None:
            us, sample_steps, lam = sharding.sharded_time_march(
                system, disc, comm, time_settings, **march
            )
            iters = np.ones(time_settings.nt, np.uint32)
            changes = np.zeros(time_settings.nt)
        else:
            us, sample_steps, lam, iters, changes = sharding.sharded_nonlinear_time_march(
                system, disc, comm, time_settings, **march, **iterate,
                max_iterations=conv.maximum_iterations,
            )
        for s_i, step in enumerate(sample_steps):
            # As in the JAX package, the recovered fine scales belong to the
            # final state of a VMS march alone.
            g_vms = (
                _fine_to_coarse_dual(disc, vms_settings.order_increase, march_fine)
                if march_fine is not None and s_i == len(sample_steps) - 1
                else None
            )
            grid = reconstruct_mesh_from_solution(disc, recon_order, us[s_i], g_vms)
            grid.field_data["time"] = np.array([(int(step) + 1) * time_settings.dt])
            grids.append(grid)
        u = np.asarray(us[-1]) if len(us) else u0
        iters = np.asarray(iters, np.uint32)
        changes = np.asarray(changes)
    tracer.add("solve+reconstruct", time.perf_counter() - t_solve)

    orders, counts = np.unique(disc.element_orders, axis=0, return_counts=True)
    stats = SolutionStatistics(
        element_orders={(int(o[0]), int(o[1])): int(c) for o, c in zip(orders, counts)},
        n_total_dofs=disc.n_dofs + lam.size,
        n_lagrange=int(lam.size),
        n_elems=mesh.element_count,
        n_leaves=mesh.leaf_count,
        n_leaf_dofs=disc.n_dofs,
        iter_history=iters,
        residual_history=changes,
    )

    output_mesh = mesh
    if refinement_settings is not None:
        # The estimators are element-local work on the flat solution: every
        # rank runs the single-device refinement on its own device, with the
        # marched system for a march, as the single-device path does.
        ref_system = (
            update_system_for_time_march(time_settings, system)
            if time_settings is not None
            else system
        )
        evaluator = SystemEvaluator(ref_system.unknown_forms, CompiledSystem(ref_system), disc)
        t_refine = time.perf_counter()
        output_mesh, error_estimates, h_ref_cost = perform_mesh_refinement(
            disc,
            u,
            ref_system,
            evaluator,
            refinement_settings.error_estimate,
            refinement_settings.h_refinement_ratio,
            refinement_settings.refinement_limit,
            refinement_settings.report_error_distribution,
            bcs,
            refinement_settings.upper_order_limit,
            refinement_settings.lower_order_limit,
            system_settings.constrained_forms,
            anisotropic_p=refinement_settings.anisotropic_p,
        )
        tracer.add("refinement", time.perf_counter() - t_refine)
        grids[-1].cell_data["error_estimate"] = error_estimates
        grids[-1].cell_data["h_ref_cost_estimate"] = h_ref_cost
    return tuple(grids), stats, output_mesh


def update_system_for_time_march(
    time_settings: TimeSettings, system: KFormSystem
) -> KFormSystem:
    """Add the 2/dt <w, u> terms of the trapezoidal rule to marched equations."""
    for w, u in time_settings.time_march_relations.items():
        if u not in system.unknown_forms:
            raise ValueError(f"Unknown form {u} is not in the system.")
        if w not in system.weight_forms:
            raise ValueError(f"Weight form {w} is not in the system.")
        if u.order != w.order:
            raise ValueError(
                f"Forms {u} and {w} in the time march relation can not be used, as"
                f" they have differing orders ({u.order} vs {w.order})."
            )

    time_march_indices = tuple(
        (
            system.unknown_forms.index(time_settings.time_march_relations[eq.weight])
            if eq.weight in time_settings.time_march_relations
            else None
        )
        for eq in system.equations
    )

    new_equations: list[KEquation] = []
    for eq, m_idx in zip(system.equations, time_march_indices):
        if m_idx is None:
            new_equations.append(eq)
        else:
            new_equations.append(
                eq.left
                + 2
                / time_settings.dt
                * (system.weight_forms[m_idx] @ system.unknown_forms.get_form(m_idx))
                == eq.right
            )
    return KFormSystem(*new_equations)
