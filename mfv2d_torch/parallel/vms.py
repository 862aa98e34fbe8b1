"""Element-sharded VMS fine-scale estimation over ``torch.distributed``.

Every VMS object partitions over the elements: the fine and coarse saddle
systems of the Green's operator are hybridized (block-diagonal A and trace
constraints, one ``all_reduce`` a trace matvec), the fine advection
operator and the coarse-fine transfers are element-local, and only the
trace vectors are replicated.  This module composes those pieces from
:mod:`mfv2d_torch.parallel.sharding` into a sharded Suyash-Green operator
and a sharded VMS nonlinear steady solve.

The port of the JAX package's ``mfv2d_tpu/parallel/vms.py``
(``_fine_discretization``, ``_make_sharded_assembler``,
``ShardedSuyashGreen``, ``sharded_vms_steady_solve``).  There the
assemblers are jitted ``shard_map`` programs over padded shards; here each
rank assembles its own elements as an ``ElementBatch`` (the M1 kernel on
CUDA tensors), with no padding.  The unresolved-scale iteration is the
single-device port's :func:`mfv2d_torch.solver.vms.
iterate_unresolved_contributions`, run alike on every rank over replicated
vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from mfv2d_torch.compiler import CompiledSystem
from mfv2d_torch.evaluation import (
    ElementBatch,
    compute_element_matrices,
    evaluate_static_fields,
    reference_inclusion_matrix,
)
from mfv2d_torch.parallel.sharding import (
    MultiBucketShardedSystem,
    _gemv,
    _newton_ctx,
    _sharded_nonlinear_iterate,
    _steady_setup,
    _trace_krylov,
    trace_comm,
)
from mfv2d_torch.solver.discretization import Discretization, OrderBucket
from mfv2d_torch.solver.solve import VMSSettings, compute_element_rhs_bucket
from mfv2d_torch.solver.vms import galerkin_product, iterate_unresolved_contributions
from mfv2d_torch.system import KFormSystem
from mfv2d_torch.tracing import tracer


def _fine_discretization(disc: Discretization, dk: int) -> Discretization:
    """The fine (p + dk) Discretization on the coarse mesh and leaf order.

    Its buckets pair index for index with ``disc.buckets``, and each keeps
    the coarse bucket's integration rule, so the Galerkin product ``C^T A_f
    C`` is taken on the single-device operator's quadrature.  The flat fine
    DoF layout is leaf-rank contiguous (``element_offsets``), which the fine
    constraint assembly reads.
    """
    form_spec = disc.form_spec
    fine_orders = disc.element_orders + dk
    sizes = np.array([form_spec.total_size(int(o1), int(o2)) for o1, o2 in fine_orders],
                     np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    fd = Discretization(
        mesh=disc.mesh,
        form_spec=form_spec,
        basis_cache=disc.basis_cache,
        leaf_indices=disc.leaf_indices,
        element_orders=fine_orders,
        element_sizes=sizes,
        element_offsets=offsets,
    )
    for bucket in disc.buckets:
        p1, p2 = bucket.orders
        fine_basis = disc.basis_cache.get_basis2d(
            p1 + dk, p2 + dk, *bucket.batch.basis.integration_orders
        )
        n = form_spec.total_size(p1 + dk, p2 + dk)
        fd.buckets.append(
            OrderBucket(
                orders=(p1 + dk, p2 + dk),
                leaf_ranks=bucket.leaf_ranks,
                batch=ElementBatch(fine_basis, bucket.batch.corners_np, bucket.batch.device),
                gather=offsets[bucket.leaf_ranks][:, None] + np.arange(n, dtype=np.int64)[None, :],
            )
        )
    return fd


def _make_sharded_assembler(batch: ElementBatch, form_spec, blocks_ir, fields):
    """``assemble(dofs=None) -> [E_rank, n, n]``: the element matrices of
    ``blocks_ir`` on the rank's ``batch``, its static fields evaluated once
    here and reused by every call (the nonlinear advection rebuilds)."""
    statics = evaluate_static_fields(batch, fields) if batch.n_elements else {}
    n = form_spec.total_size(*batch.orders)

    def assemble(dofs: torch.Tensor | None = None) -> torch.Tensor:
        if not batch.n_elements:
            return torch.zeros((0, n, n), dtype=torch.float64, device=batch.device)
        return compute_element_matrices(form_spec, blocks_ir, batch, dofs=dofs,
                                        static_fields=statics)

    return assemble


class ShardedSuyashGreen:
    """The element-sharded fine-scale Green's operator ``G' = A_f^-1 - P
    A_c^-1 P^T``.

    Mirrors :class:`mfv2d_torch.solver.vms.SuyashGreenOperator` with every
    element-sized object on its rank:

    - the fine and coarse symmetric saddles are
      :class:`MultiBucketShardedSystem`\\ s (each rank assembles and inverts
      its own blocks), solved by trace Krylov; the coarse operator is the
      Galerkin product ``C^T A_f C`` of each rank's fine blocks with the
      shared per-bucket inclusion matrices ``C``;
    - the fine advection operator is one ``[E_rank, n_f, n_f]`` sum a
      bucket (linear + nonlinear), rebuilt on each rank at every nonlinear
      update;
    - the coarse-fine transfers are element-local products with ``C``.
    """

    def __init__(
        self,
        system: KFormSystem,
        settings: VMSSettings,
        disc: Discretization,
        device_mesh,
        constrained_forms=(),
        strong_boundary_conditions=(),
        inner_max_iterations: int = 4000,
    ) -> None:
        from mfv2d_torch.continuity import add_system_constraints

        self.comm = comm = trace_comm(device_mesh)
        self.inner_max_iterations = int(inner_max_iterations)
        self.disc = disc
        self.convergence = settings.fine_scale_convergence
        self.iteration = settings.iteration
        self.relaxation = settings.relaxation
        self.inexact_forcing = settings.inexact_forcing
        self.anticipate_factor = settings.anticipate_factor
        self.inexact_eta = settings.inexact_eta
        self.compiled_advection = CompiledSystem(settings.nonsymmetric_system)
        compiled_sym = CompiledSystem(settings.symmetric_system)
        dk = settings.order_increase
        form_spec = disc.form_spec

        fd = self.fine_disc = _fine_discretization(disc, dk)
        self._incl = [
            reference_inclusion_matrix(form_spec, cb.orders, fb.orders, comm.device)
            for cb, fb in zip(disc.buckets, fd.buckets)
        ]

        # The fine forcing (replicated, leaf-rank layout) and the
        # constraints on the p-raised mesh; the weak boundary terms are
        # added in place through the per-leaf views.
        forcing = np.zeros(fd.n_dofs)
        for fb in fd.buckets:
            forcing[fb.gather] = compute_element_rhs_bucket(system, fb)
        views = [forcing[fd.element_offsets[i] : fd.element_offsets[i + 1]]
                 for i in range(fd.n_leaves)]
        mesh2d = disc.mesh
        mesh2d.uniform_p_change(dk, dk)
        try:
            fine_lag_mat, _ = add_system_constraints(
                system, mesh2d, disc.basis_cache, list(constrained_forms),
                list(strong_boundary_conditions), disc.leaf_indices, fd.element_offsets, views,
            )
        finally:
            mesh2d.uniform_p_change(-dk, -dk)
        self.fine_forcing = forcing

        with tracer.stage("svms-fine-saddle"):
            self.fine_saddle = MultiBucketShardedSystem.from_assembly(
                fd, compiled_sym.lhs_blocks, fine_lag_mat, comm
            )
        coarse_lag_mat, _ = add_system_constraints(
            system, mesh2d, disc.basis_cache, list(constrained_forms),
            list(strong_boundary_conditions), disc.leaf_indices, disc.element_offsets, None,
        )
        with tracer.stage("svms-coarse-saddle"):
            coarse_blocks = [
                galerkin_product(sub.blocks, torch.as_tensor(c, device=comm.device))
                for (_, sub), c in zip(self.fine_saddle.subsystems, self._incl)
            ]
            self.coarse_saddle = MultiBucketShardedSystem(
                disc, coarse_blocks, coarse_lag_mat, comm, _local=True
            )

        # The fine advection: the linear blocks depend on the geometry only
        # and are assembled once; a nonlinear update assembles the rest.
        adv = self.compiled_advection
        with tracer.stage("svms-advection"):
            self._lin_assemble = [
                _make_sharded_assembler(sub.batch, form_spec, adv.linear_blocks, adv.fields)
                for _, sub in self.fine_saddle.subsystems
            ]
            self._nonlin_assemble = [
                None if adv.nonlin_blocks is None
                else _make_sharded_assembler(sub.batch, form_spec, adv.nonlin_blocks, adv.fields)
                for _, sub in self.fine_saddle.subsystems
            ]
            self._adv_lin_blocks = [assemble() for assemble in self._lin_assemble]
            self._adv_blocks = list(self._adv_lin_blocks)

        self._fine_krylov = _trace_krylov(self.fine_saddle, "cg", self.inner_max_iterations)
        self._coarse_krylov = _trace_krylov(self.coarse_saddle, "cg", self.inner_max_iterations)

    # -- operator pieces ------------------------------------------------

    def _rebuild_advection(self, fine_dofs: np.ndarray | None) -> None:
        """(Re)build the rank's advection sums at the fine DoFs."""
        if fine_dofs is None or self.compiled_advection.nonlin_blocks is None:
            self._adv_blocks = list(self._adv_lin_blocks)
            return
        self._adv_blocks = []  # free the old sums before assembling the new
        for lin, assemble, d in zip(self._adv_lin_blocks, self._nonlin_assemble,
                                    self.fine_saddle.shard_dofs(fine_dofs)):
            self._adv_blocks.append(lin + assemble(d))

    def _apply_fine_advection(self, v: np.ndarray) -> np.ndarray:
        """F v: element-local GEMVs, gathered (one all_reduce)."""
        parts = self.fine_saddle.shard_dofs(v)
        return self.fine_saddle.unshard_dofs(
            [_gemv(blocks, x) for blocks, x in zip(self._adv_blocks, parts)]
        )

    def _prolong_to_fine(self, u: np.ndarray) -> np.ndarray:
        """P u: coarse DoFs to the fine space (products with C)."""
        out = np.zeros(self.fine_disc.n_dofs)
        u = np.asarray(u)
        for cb, fb, c in zip(self.disc.buckets, self.fine_disc.buckets, self._incl):
            out[fb.gather] = u[cb.gather] @ c.T
        return out

    def _project_to_coarse(self, x: np.ndarray) -> np.ndarray:
        """P^T x: the dual projection to coarse DoFs."""
        out = np.zeros(self.disc.n_dofs)
        x = np.asarray(x)
        for cb, fb, c in zip(self.disc.buckets, self.fine_disc.buckets, self._incl):
            out[cb.gather] = x[fb.gather] @ c
        return out

    def _saddle_solve(self, msys, runner, b_flat, tol: float) -> np.ndarray:
        """A saddle solve with zero constraint values (the Green's function
        sees homogeneous multiplier data), through the cached runner."""
        out, _, _, _ = msys.solve_schur(
            b_flat, np.zeros(msys.n_lagrange), self.inner_max_iterations, tol,
            krylov_runner=runner,
        )
        return out

    def fine_scale_greens_function(self, x: np.ndarray) -> np.ndarray:
        """G' x by two sharded saddle solves (trace Krylov)."""
        tol = max(self.convergence.absolute_tolerance * 1e-2, 1e-13)
        with tracer.stage("svms-greens-fine"):
            u_f = self._saddle_solve(self.fine_saddle, self._fine_krylov, np.asarray(x), tol)
        with tracer.stage("svms-greens-coarse"):
            u_c = self._saddle_solve(self.coarse_saddle, self._coarse_krylov,
                                     self._project_to_coarse(x), tol)
        return u_f - self._prolong_to_fine(u_c)

    # -- the VMS iteration (as solver.vms) --------------------------------

    def update_nonlinear_advection(self, coarse_dofs: np.ndarray) -> None:
        if self.compiled_advection.nonlin_blocks is None:
            return
        self._rebuild_advection(self._prolong_to_fine(coarse_dofs[: self.disc.n_dofs]))

    def compute_unresolved_contributions(
        self,
        coarse_solution: np.ndarray,
        initial_guess: np.ndarray | None,
        rtol_override: float | None = None,
        atol_override: float | None = None,
    ) -> np.ndarray:
        return iterate_unresolved_contributions(
            self._apply_fine_advection,
            self.fine_scale_greens_function,
            self._prolong_to_fine,
            self.fine_forcing,
            self.convergence,
            self.iteration,
            self.relaxation,
            coarse_solution,
            initial_guess,
            rtol_override=rtol_override,
            atol_override=atol_override,
        )

    def recover_unresolved(
        self, coarse_solution: np.ndarray, unresolved_contribution: np.ndarray
    ) -> np.ndarray:
        residual = (
            self.fine_forcing
            - self._apply_fine_advection(self._prolong_to_fine(coarse_solution))
            - unresolved_contribution
        )
        return self.fine_scale_greens_function(residual)


def sharded_vms_steady_solve(
    system: KFormSystem,
    vms_settings: VMSSettings,
    disc: Discretization,
    device_mesh,
    *,
    boundary_conditions=(),
    constrained_forms=(),
    maximum_iterations: int = 40,
    relax: float = 1.0,
    absolute_tolerance: float = 1e-9,
    relative_tolerance: float = 0.0,
    cg_maximum_iterations: int = 4000,
    cg_tolerance: float = 1e-12,
    anderson_m: int = 0,
    initial_solution=None,
    initial_lagrange=None,
    initial_unresolved=None,
    newton: bool = False,
    checkpoint_cb=None,
):
    """Sharded VMS nonlinear steady solve.

    A Picard iteration does: the nonlinear advection rebuilt on each rank,
    the unresolved-scale GMRES (each matvec one sharded fine and one
    sharded coarse saddle solve and one advection GEMV), the sharded
    residual less the fine-scale forcing, and the frozen sharded Schur
    correction.  ``newton`` corrects with the exact element Jacobians at
    the iterate instead; as in the JAX package, its trace solve starts as
    CG whatever the caller's Krylov method (the curvature probe moves an
    indefinite trace operator to GMRES).  ``checkpoint_cb(it, flat_solution,
    lam, unresolved)`` and the ``initial_*`` warm starts serve checkpoints.

    Returns ``(solution_flat, lambda, residual_history, fine_scales)`` with
    the recovered unresolved-scale fine DoFs.
    """
    comm = trace_comm(device_mesh)
    compiled, forcing, _, _, msys, bases, us, lam, c_vec = _steady_setup(
        system, disc, comm, boundary_conditions, constrained_forms, initial_solution,
        initial_lagrange,
    )
    runner = _trace_krylov(msys, "cg", cg_maximum_iterations)
    with tracer.stage("vms-init"):
        sg = ShardedSuyashGreen(system, vms_settings, disc, comm, constrained_forms,
                                boundary_conditions, inner_max_iterations=cg_maximum_iterations)
    us, lam, residuals, unresolved = _sharded_nonlinear_iterate(
        msys, compiled.lhs_blocks, compiled.rhs_blocks, bases, c_vec, us, lam, runner,
        maximum_iterations=maximum_iterations, relax=relax,
        absolute_tolerance=absolute_tolerance, relative_tolerance=relative_tolerance,
        # The JAX package scales the relative tolerance by the forcing alone.
        max_mag=float(np.abs(forcing).max(initial=0.0)), cg_tolerance=cg_tolerance,
        anderson_m=anderson_m,
        newton_ctx=_newton_ctx(msys, compiled, "cg", cg_maximum_iterations) if newton else None,
        sg=sg, unresolved=initial_unresolved, checkpoint_cb=checkpoint_cb,
    )
    out = msys.unshard_dofs(us)
    return out, lam.cpu().numpy(), np.asarray(residuals), sg.recover_unresolved(out, unresolved)
