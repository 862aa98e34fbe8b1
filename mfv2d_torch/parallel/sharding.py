"""Element-sharded steady solve over ``torch.distributed``.

The hybridized system is the distributed seam the reference was designed
around (docs/modules/solving.rst:10-13): the element blocks are independent,
and the only coupling is the trace (constraint) vector.  Every rank of a
one-dimensional ``DeviceMesh`` calls the same functions with the same
arguments (SPMD, as under ``torchrun``).  The elements of each order bucket
are block-distributed over the ranks; each rank assembles, inverts (the
``gj_inverse`` kernel) and applies its own blocks.  The trace vector lambda
is replicated, and a trace Schur matvec does

    1. local ``G^T lambda`` (a gather from the replicated lambda),
    2. local batched block GEMVs against the explicit f64 inverses,
    3. a local partial ``G x`` (an ``index_add_``),
    4. one ``all_reduce`` (SUM) of the ``n_lagrange`` partials,

for all buckets together.  The Krylov loops run replicated on every rank
(:mod:`mfv2d_torch.solver.krylov`) and add no collective of their own.  A
Picard iteration adds one reduce of the trace residual, one (MAX) of the
residual norm and one of the Schur right-hand side; the DoF vector is
gathered once at the end (and per iteration when checkpointing, and twice
per iteration with Anderson acceleration).

Host work (the mesh, forcing, constraint rows, reconstruction) is
replicated on every rank.  Ranks work on ``cuda:(LOCAL_RANK % device
count)`` (the rank in the mesh where ``LOCAL_RANK`` is unset), or on the CPU
when the mesh's device type is ``"cpu"``.

The port of the f64 path of the JAX package's ``mfv2d_tpu/parallel/
sharding.py`` (``ShardedBlockSystem``, ``MultiBucketShardedSystem``,
``sharded_schur_solve``, ``_sharded_nonlinear_iterate``,
``sharded_steady_solve``).  Left out, as they serve only the TPU: the f32,
f32x2 and condensed-c32/c64 tables and their applies, the mixed
f32-inner Krylov (``_fused_mixed_factory``), the chunked CG dispatches and
the identity-block padding to equal shards (``shard_map`` needs equal
shards; ``torch.distributed`` does not).

Beside the steady Picard solve: the exact-Newton steady solve
(``sharded_newton_steady_solve``: each rank's element Jacobians by forward
mode, its blocks inverted anew each Newton step) and the three trapezoidal
marches of the JAX package (``sharded_time_march``,
``sharded_nonlinear_time_march``, ``sharded_host_time_march``), which share
one Python step loop over per-step data computed up front (the JAX package
fuses each into one ``lax.scan``).  The VMS operator and solve are in
:mod:`mfv2d_torch.parallel.vms`.
"""

from __future__ import annotations

import copy
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from mfv2d_torch.ops.kernels.gj_inverse import gj_inverse
from mfv2d_torch.ops.precision import choose_refine_rounds
from mfv2d_torch.solver import krylov
from mfv2d_torch.solver.discretization import Discretization, OrderBucket
from mfv2d_torch.solver.solve import anderson_step
from mfv2d_torch.tracing import tracer
from mfv2d_torch.utils.lazy import lazy_module

sp = lazy_module("scipy.sparse")


class TraceComm:
    """One rank's view of a one-dimensional device mesh.

    Holds the process group, the rank and the rank's device, with what a
    run can read back: the ``all_reduce`` calls by tag (``counts``), the
    trace Schur matvecs (``matvecs``) and each trace Krylov solve's method
    and iterations (``krylov``).  Pass it as ``SolverSettings.device_mesh``
    in place of its mesh to read them after a solve.
    """

    def __init__(self, device_mesh) -> None:
        if device_mesh.ndim != 1:
            raise ValueError("The sharded solve takes a one-dimensional DeviceMesh.")
        self.group = device_mesh.get_group()
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))
        if device_mesh.device_type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            self.device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        elif device_mesh.device_type == "cpu":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"Unsupported device type {device_mesh.device_type!r}.")
        self.counts: dict[str, int] = {}
        self.matvecs = 0
        self.krylov: list[tuple[str, int]] = []

    def all_reduce(self, tensor: torch.Tensor, tag: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``tensor`` reduced over the ranks, in place."""
        self.counts[tag] = self.counts.get(tag, 0) + 1
        dist.all_reduce(tensor, op=op, group=self.group)
        return tensor

    def max(self, value: float, tag: str) -> float:
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        return float(self.all_reduce(t, tag, dist.ReduceOp.MAX))

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def trace_comm(mesh) -> TraceComm:
    """The TraceComm of a one-dimensional DeviceMesh (a TraceComm as it is)."""
    return mesh if isinstance(mesh, TraceComm) else TraceComm(mesh)


def shard_range(n_elements: int, world: int, rank: int) -> tuple[int, int]:
    """The contiguous elements ``[lo, hi)`` that ``rank`` owns: the first
    ``n_elements % world`` ranks own one more."""
    base, extra = divmod(n_elements, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def _gemv(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("eij,ej->ei", mats, vecs)


class ShardedBlockSystem:
    """One order bucket's saddle system, its elements sharded over the ranks.

    Parameters
    ----------
    disc : Discretization
        Single-bucket discretization (for hp meshes use
        :class:`MultiBucketShardedSystem`).
    element_matrices : [E, n, n] array or tensor
        The bucket's element matrices, all of them; with ``_local`` only the
        rank's own ``[E_rank, n, n]`` on its device.
    lagrange_mat : scipy sparse or None
        Constraint matrix G over the bucket's flat DoF vector.
    mesh : DeviceMesh or TraceComm
        One-dimensional device mesh.
    """

    def __init__(self, disc: Discretization, element_matrices, lagrange_mat, mesh, *,
                 _local: bool = False) -> None:
        if len(disc.buckets) != 1:
            raise NotImplementedError(
                "ShardedBlockSystem expects a uniform-order mesh; use"
                " MultiBucketShardedSystem for hp meshes."
            )
        comm = self.comm = trace_comm(mesh)
        self.device = comm.device
        bucket = disc.buckets[0]
        self.e_real = bucket.batch.n_elements
        self.lo, self.hi = shard_range(self.e_real, comm.world, comm.rank)
        self.n_dofs_per_element = n = int(np.asarray(bucket.gather).shape[1])
        blocks = element_matrices if _local else element_matrices[self.lo : self.hi]
        self.blocks = torch.as_tensor(blocks, dtype=torch.float64, device=self.device)
        self.blocks = self.blocks.reshape(self.hi - self.lo, n, n).contiguous()
        self._invert()

        self.n_lagrange = 0 if lagrange_mat is None else int(lagrange_mat.shape[0])
        if lagrange_mat is None:
            coo_row = coo_col = np.zeros(0, np.int64)
            coo_val = np.zeros(0)
        else:
            coo = sp.coo_array(lagrange_mat)
            keep = (coo.col >= self.lo * n) & (coo.col < self.hi * n)
            coo_row = np.asarray(coo.row[keep], np.int64)
            coo_col = np.asarray(coo.col[keep], np.int64) - self.lo * n
            coo_val = np.asarray(coo.data[keep], np.float64)
        # G x: the rank's entries, summed into the trace by index_add_.
        self._g_rows = torch.as_tensor(coo_row, device=self.device)
        self._g_cols = torch.as_tensor(coo_col, device=self.device)
        self._g_vals = torch.as_tensor(coo_val, dtype=torch.float64, device=self.device)
        # G^T lambda: for each local DoF, its constraint rows as a padded gather.
        n_local = (self.hi - self.lo) * n
        order = np.argsort(coo_col, kind="stable")
        counts = np.bincount(coo_col, minlength=n_local)
        k = max(1, int(counts.max()) if counts.size else 1)
        slot = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts, counts)
        t_rows = np.zeros((n_local, k), np.int64)
        t_vals = np.zeros((n_local, k))
        t_rows[coo_col[order], slot] = coo_row[order]
        t_vals[coo_col[order], slot] = coo_val[order]
        self._t_rows = torch.as_tensor(t_rows, device=self.device)
        self._t_vals = torch.as_tensor(t_vals, dtype=torch.float64, device=self.device)

    def _invert(self) -> None:
        """Explicit f64 inverses of the rank's blocks from the kernel, with the
        refinement rounds that the ones probe asks for.  Singular blocks on
        any rank fail on every rank (one MAX reduce of the probe error)."""
        self.refine_rounds = 0
        err = 0.0
        if self.blocks.shape[0]:
            try:
                self.inverse = gj_inverse(self.blocks)
                self.refine_rounds, err = choose_refine_rounds(self.blocks, self.inverse)
            except torch.linalg.LinAlgError:
                err = float("inf")
        else:
            self.inverse = self.blocks
        err = self.comm.max(err if np.isfinite(err) else 1e300, "setup")
        if not err <= 1e-6:
            raise ValueError(
                f"Element blocks are numerically singular (solve probe error {err:.2e});"
                " the sharded trace/Schur path needs invertible element operators — use"
                " a mixed formulation or the single-device saddle solvers."
            )

    def with_blocks(self, blocks: torch.Tensor) -> "ShardedBlockSystem":
        """The same system with the rank's blocks replaced by ``blocks``
        (``[E_rank, n, n]`` on its device) and inverted anew; the trace
        tables, which depend only on the constraints, are shared."""
        other = copy.copy(self)
        other.blocks = blocks.contiguous()
        other._trace_indef = None
        other._invert()
        return other

    # -- element-local operators ---------------------------------------

    def block_solve_sharded(self, rhs: torch.Tensor) -> torch.Tensor:
        """The rank's ``A^{-1} rhs``, ``[E_rank, n]`` in and out."""
        x = _gemv(self.inverse, rhs)
        for _ in range(self.refine_rounds):
            x = x + _gemv(self.inverse, rhs - _gemv(self.blocks, x))
        return x

    def trace_partial(self, dofs: torch.Tensor) -> torch.Tensor:
        """The rank's part of ``G x``: its entries, summed by index_add_."""
        out = torch.zeros(self.n_lagrange, dtype=torch.float64, device=self.device)
        return out.index_add_(0, self._g_rows, self._g_vals * dofs.reshape(-1)[self._g_cols])

    def trace_of(self, dofs: torch.Tensor) -> torch.Tensor:
        """``G x`` over all ranks, replicated (one all_reduce)."""
        return self.comm.all_reduce(self.trace_partial(dofs), "trace")

    def trace_t_of(self, lam: torch.Tensor) -> torch.Tensor:
        """The rank's ``G^T lambda`` from the replicated lambda (no collective)."""
        shape = (self.hi - self.lo, self.n_dofs_per_element)
        if self.n_lagrange == 0:
            return torch.zeros(shape, dtype=torch.float64, device=self.device)
        return torch.sum(self._t_vals * lam[self._t_rows], dim=1).reshape(shape)

    def schur_partial(self, lam: torch.Tensor) -> torch.Tensor:
        """The rank's part of ``G A^{-1} G^T lambda``."""
        return self.trace_partial(self.block_solve_sharded(self.trace_t_of(lam)))

    def make_schur_matvec(self):
        """``S lambda = G A^{-1} G^T lambda``, replicated: one all_reduce."""
        return _matvec(self.comm, [self])

    def make_residual_step(self):
        """``(u, lambda) -> (A u + G^T lambda, G u)``: the element part local,
        the trace part one all_reduce."""

        def apply_saddle(dofs, lam):
            return _gemv(self.blocks, dofs) + self.trace_t_of(lam), self.trace_of(dofs)

        return apply_saddle

    # -- assembly and residuals ------------------------------------------

    @classmethod
    def from_assembly(cls, disc: Discretization, blocks_ir, lagrange_mat, mesh):
        """Build the system with each rank assembling its own elements.

        The rank's elements become a batch of their own on its device; its
        matrices go through the element engine (the M1 kernel on CUDA
        tensors), and the batch and its static fields serve the residuals.
        """
        from mfv2d_torch.compiler import collect_fields
        from mfv2d_torch.evaluation import (
            ElementBatch,
            compute_element_matrices,
            evaluate_static_fields,
        )

        if len(disc.buckets) != 1:
            raise NotImplementedError("from_assembly expects a single bucket.")
        comm = trace_comm(mesh)
        bucket = disc.buckets[0]
        lo, hi = shard_range(bucket.batch.n_elements, comm.world, comm.rank)
        n = int(np.asarray(bucket.gather).shape[1])
        batch = ElementBatch(bucket.batch.basis, bucket.batch.corners_np[lo:hi], comm.device)
        static = evaluate_static_fields(batch, collect_fields(blocks_ir)) if hi > lo else {}
        if hi > lo:
            blocks = compute_element_matrices(disc.form_spec, blocks_ir, batch,
                                              static_fields=static)
        else:
            blocks = torch.zeros((0, n, n), dtype=torch.float64, device=comm.device)
        obj = cls(disc, blocks, lagrange_mat, comm, _local=True)
        obj.batch = batch
        obj.form_spec = disc.form_spec
        obj._static = static
        return obj

    def residual_partial(self, lhs_blocks, rhs_blocks, dofs, lam, b):
        """``(r_elem, G u partial)``: the rank's defect-correction residual
        ``b - (LHS(u) - RHS(u)) - G^T lambda`` and its part of the trace
        value, both without a collective."""
        from mfv2d_torch.evaluation import compute_element_vectors

        if self.hi == self.lo:
            return b, self.trace_partial(dofs)
        val = compute_element_vectors(self.form_spec, lhs_blocks, self.batch, dofs,
                                      static_fields=self._static)
        if rhs_blocks is not None:
            val = val - compute_element_vectors(self.form_spec, rhs_blocks, self.batch, dofs,
                                                static_fields=self._static)
        return b - val - self.trace_t_of(lam), self.trace_partial(dofs)

    def make_newton_jacobian(self, lhs_blocks, rhs_blocks=None):
        """``dofs -> [E_rank, n, n]``: the exact element Jacobians of
        ``LHS(u) - RHS(u)`` at the rank's DoFs, by forward mode over the
        rank's batch (no collective).  The masses are computed before the
        transform, so no kernel runs inside it."""
        from mfv2d_torch.evaluation import compute_element_vectors
        from mfv2d_torch.solver.solve import forward_jacobians, warm_masses

        def value(dofs):
            val = compute_element_vectors(self.form_spec, lhs_blocks, self.batch, dofs,
                                          static_fields=self._static)
            if rhs_blocks is not None:
                val = val - compute_element_vectors(self.form_spec, rhs_blocks, self.batch, dofs,
                                                    static_fields=self._static)
            return val

        def jacobian(dofs: torch.Tensor) -> torch.Tensor:
            if self.hi == self.lo:
                return torch.zeros_like(self.blocks)
            warm_masses(self.batch, lhs_blocks, rhs_blocks)
            return forward_jacobians(value, dofs)

        return jacobian

    def make_picard_residual(self, lhs_blocks, rhs_blocks=None):
        """``(dofs, lam, b) -> (r_elem, G u)``: the element residual stays on
        the rank, the trace value is replicated (one all_reduce)."""

        def residual(dofs, lam, b):
            r_elem, g_u = self.residual_partial(lhs_blocks, rhs_blocks, dofs, lam, b)
            return r_elem, self.comm.all_reduce(g_u, "residual")

        return residual

    # -- Krylov ----------------------------------------------------------

    def trace_indefinite(self) -> bool:
        """Whether the trace Schur complement mixes curvature signs (a short
        f64 CG probe, cached); indefinite systems go to GMRES."""
        if getattr(self, "_trace_indef", None) is None:
            self._trace_indef = krylov.trace_indefinite_probe(
                self.make_schur_matvec(), self.n_lagrange, self.device
            )
        return self._trace_indef

    def make_fused_cg(self, maximum_iterations: int):
        """CG on the replicated trace: ``run(rhs, tol) -> (lambda, |r|^2, iters)``."""
        return _runner(self, "cg", maximum_iterations)

    def make_fused_gmres(self, maximum_iterations: int):
        """Restarted GMRES on the replicated trace, its restart length from
        :func:`krylov.auto_restart`."""
        return _runner(self, "gmres", maximum_iterations)

    # -- data movement ---------------------------------------------------

    def shard_dofs(self, flat) -> torch.Tensor:
        """The bucket's flat DoF vector -> the rank's ``[E_rank, n]`` part."""
        arr = np.asarray(flat).reshape(self.e_real, self.n_dofs_per_element)
        return torch.as_tensor(arr[self.lo : self.hi], dtype=torch.float64, device=self.device)

    def unshard_dofs(self, dofs: torch.Tensor) -> np.ndarray:
        """The ranks' parts -> the bucket's flat DoF vector (one all_reduce)."""
        out = torch.zeros((self.e_real, self.n_dofs_per_element), dtype=torch.float64,
                          device=self.device)
        out[self.lo : self.hi] = dofs
        return self.comm.all_reduce(out, "gather").reshape(-1).cpu().numpy()


def _matvec(comm: TraceComm, subs):
    """The summed ``G A^{-1} G^T lambda`` of ``subs``: one all_reduce."""

    def matvec(lam):
        comm.matvecs += 1
        partial = subs[0].schur_partial(lam)
        for sub in subs[1:]:
            partial = partial + sub.schur_partial(lam)
        return comm.all_reduce(partial, "schur")

    return matvec


def _runner(system, method: str, maximum_iterations: int):
    """``run(rhs, tol) -> (lambda, |r|^2, iterations)`` by CG or GMRES on the
    replicated trace; each solve is logged in ``system.comm.krylov``."""
    matvec = system.make_schur_matvec()
    m = krylov.auto_restart(max(system.n_lagrange, 1), maximum_iterations, dtype_bytes=8)

    def run(trace_rhs, tolerance: float):
        with tracer.stage("trace-krylov"):
            if method == "cg":
                out = krylov.cg_loop(matvec, trace_rhs, float(tolerance), maximum_iterations)
            else:
                out = krylov.gmres_loop(
                    matvec, trace_rhs, float(tolerance), maximum_iterations, m
                )
        system.comm.krylov.append((method, out[2]))
        return out

    return run


def _trace_krylov(system, method: str, maximum_iterations: int):
    """The trace Krylov runner for ``system``: ``method="cg"`` moves to GMRES
    when the curvature probe finds the trace operator indefinite (saddle
    formulations, where the CG recurrence is only semiconvergent)."""
    if method == "cg" and system.n_lagrange and system.trace_indefinite():
        method = "gmres"
    if method == "gmres":
        return system.make_fused_gmres(maximum_iterations)
    return system.make_fused_cg(maximum_iterations)


def sharded_schur_solve(
    system: ShardedBlockSystem,
    rhs_flat: np.ndarray,
    constraints: np.ndarray,
    maximum_iterations: int,
    tolerance: float,
    method: str = "cg",
):
    """Krylov solve on the sharded Schur complement, element work sharded.

    Returns ``(u_flat, lambda, |r|, iterations)`` on every rank.  Use
    ``method="gmres"`` for a nonsymmetric trace Schur complement.
    """
    b = system.shard_dofs(rhs_flat)
    c = torch.as_tensor(np.asarray(constraints), dtype=torch.float64, device=system.device)
    trace_rhs = system.trace_of(system.block_solve_sharded(b)) - c
    lam, rs, iters = _trace_krylov(system, method, maximum_iterations)(trace_rhs, tolerance)
    u = system.block_solve_sharded(b - system.trace_t_of(lam))
    return system.unshard_dofs(u), lam.cpu().numpy(), float(np.sqrt(rs)), int(iters)


class MultiBucketShardedSystem:
    """hp meshes: one element-sharded block system per order bucket.

    Every bucket shards over the same ranks.  A Schur matvec adds the
    buckets' partials on the rank and reduces them with one all_reduce.
    """

    @staticmethod
    def _bucket_view(disc: Discretization, bucket: OrderBucket, lagrange_mat, n_lag: int):
        """A single-bucket discretization of ``bucket`` (its elements packed
        in order) and the constraint columns on it; the rows keep their
        global numbering so the buckets' traces add into one lambda."""
        e, n = np.asarray(bucket.gather).shape
        local = OrderBucket(
            orders=bucket.orders,
            leaf_ranks=np.arange(e),
            batch=bucket.batch,
            gather=np.arange(e * n, dtype=np.int64).reshape(e, n),
        )
        sub_disc = replace(
            disc,
            leaf_indices=tuple(disc.leaf_indices[int(r)] for r in bucket.leaf_ranks),
            element_orders=disc.element_orders[bucket.leaf_ranks],
            element_sizes=np.full(e, n, np.int64),
            element_offsets=np.arange(e + 1, dtype=np.int64) * n,
            buckets=[local],
        )
        if lagrange_mat is None:
            return sub_disc, None
        coo = sp.coo_array(lagrange_mat)
        col_map = np.full(disc.n_dofs, -1, np.int64)
        flat = np.asarray(bucket.gather).reshape(-1)
        col_map[flat] = np.arange(flat.size)
        sel = col_map[coo.col] >= 0
        sub_g = sp.csr_array(
            (coo.data[sel], (coo.row[sel], col_map[coo.col[sel]])), shape=(n_lag, e * n)
        )
        return sub_disc, sub_g

    def __init__(self, disc: Discretization, element_matrices, lagrange_mat, mesh, *,
                 _local: bool = False) -> None:
        self.comm = trace_comm(mesh)
        self.disc = disc
        self.n_lagrange = 0 if lagrange_mat is None else int(lagrange_mat.shape[0])
        self.subsystems = []
        for bucket, mats in zip(disc.buckets, element_matrices, strict=True):
            sub_disc, sub_g = self._bucket_view(disc, bucket, lagrange_mat, self.n_lagrange)
            self.subsystems.append(
                (bucket, ShardedBlockSystem(sub_disc, mats, sub_g, self.comm, _local=_local))
            )

    @classmethod
    def from_assembly(cls, disc: Discretization, blocks_ir, lagrange_mat, mesh):
        """Every rank assembles its own elements of every bucket."""
        obj = cls.__new__(cls)
        obj.comm = trace_comm(mesh)
        obj.disc = disc
        obj.n_lagrange = 0 if lagrange_mat is None else int(lagrange_mat.shape[0])
        obj.subsystems = []
        for bucket in disc.buckets:
            sub_disc, sub_g = cls._bucket_view(disc, bucket, lagrange_mat, obj.n_lagrange)
            obj.subsystems.append(
                (bucket, ShardedBlockSystem.from_assembly(sub_disc, blocks_ir, sub_g, obj.comm))
            )
        return obj

    @property
    def device(self) -> torch.device:
        return self.comm.device

    def with_blocks(self, blocks) -> "MultiBucketShardedSystem":
        """The same system with each bucket's rank-local blocks replaced and
        inverted anew (a Newton step's Jacobians); the trace tables are
        shared."""
        other = copy.copy(self)
        other._trace_indef = None
        other.subsystems = [
            (bucket, sub.with_blocks(b)) for (bucket, sub), b in zip(self.subsystems, blocks)
        ]
        return other

    def make_schur_matvec(self):
        """Summed per-bucket ``G A^{-1} G^T lambda``: one all_reduce."""
        return _matvec(self.comm, [sub for _, sub in self.subsystems])

    def trace_indefinite(self) -> bool:
        """The curvature probe over the summed multi-bucket operator."""
        if getattr(self, "_trace_indef", None) is None:
            self._trace_indef = krylov.trace_indefinite_probe(
                self.make_schur_matvec(), self.n_lagrange, self.device
            )
        return self._trace_indef

    def make_fused_cg(self, maximum_iterations: int):
        return _runner(self, "cg", maximum_iterations)

    def make_fused_gmres(self, maximum_iterations: int):
        return _runner(self, "gmres", maximum_iterations)

    def trace_rhs(self, parts, constraints: torch.Tensor) -> torch.Tensor:
        """``sum_b G_b A_b^{-1} r_b - c`` over the buckets' local parts (one
        all_reduce)."""
        partial = torch.zeros(self.n_lagrange, dtype=torch.float64, device=self.device)
        for (_, sub), r in zip(self.subsystems, parts):
            partial = partial + sub.trace_partial(sub.block_solve_sharded(r))
        return self.comm.all_reduce(partial, "rhs") - constraints

    def shard_dofs(self, flat) -> list[torch.Tensor]:
        flat = np.asarray(flat)
        return [sub.shard_dofs(flat[bucket.gather].reshape(-1)) for bucket, sub in self.subsystems]

    def unshard_dofs(self, parts) -> np.ndarray:
        """The ranks' parts of every bucket -> the global flat DoF vector
        (one all_reduce for all buckets)."""
        out = torch.zeros(self.disc.n_dofs, dtype=torch.float64, device=self.device)
        for (bucket, sub), u in zip(self.subsystems, parts):
            if sub.hi > sub.lo:
                gather = torch.as_tensor(np.asarray(bucket.gather)[sub.lo : sub.hi],
                                         device=self.device)
                out[gather.reshape(-1)] = u.reshape(-1)
        return self.comm.all_reduce(out, "gather").cpu().numpy()

    def solve_schur(self, rhs_flat, constraints, maximum_iterations: int, tolerance: float,
                    krylov_runner=None):
        """CG (or the runner given) on the multi-bucket Schur complement.

        Returns ``(u_flat, lambda, |r|, iterations)`` on every rank.
        """
        bs = self.shard_dofs(rhs_flat)
        c = torch.as_tensor(np.asarray(constraints), dtype=torch.float64, device=self.device)
        trace_rhs = self.trace_rhs(bs, c)
        if krylov_runner is None:
            krylov_runner = _trace_krylov(self, "cg", maximum_iterations)
        lam, rs, iters = krylov_runner(trace_rhs, tolerance)
        us = [sub.block_solve_sharded(b - sub.trace_t_of(lam))
              for (_, sub), b in zip(self.subsystems, bs)]
        return self.unshard_dofs(us), lam.cpu().numpy(), float(np.sqrt(rs)), int(iters)




def _sharded_nonlinear_iterate(
    msys: MultiBucketShardedSystem,
    lhs_blocks,
    rhs_blocks,
    bases,
    c_t: torch.Tensor,
    us,
    lam: torch.Tensor,
    krylov_runner,
    *,
    maximum_iterations: int,
    relax: float,
    absolute_tolerance: float,
    relative_tolerance: float,
    max_mag: float,
    cg_tolerance: float,
    anderson_m: int = 0,
    newton_ctx: dict | None = None,
    sg=None,
    unresolved=None,
    checkpoint_cb=None,
):
    """One nonlinear solve over the sharded saddle system.

    The inner loop of every sharded nonlinear entry point: steady Picard,
    exact Newton, VMS, and the per-step solves of the host march.  Mirrors
    the single-device ``non_linear_solve_run``: the residual of the iterate
    (less the VMS fine-scale forcing when ``sg`` is given), its correction
    through the frozen trace Schur solve (with ``newton_ctx``, from the
    second iteration on, through the system of the exact element Jacobians
    at the iterate, inverted anew), and an optional guarded Anderson
    extrapolation (not with Newton).  Every stop decision reads a reduced
    value, so the ranks leave together.  ``newton_ctx`` holds
    ``jacobians`` (one ``make_newton_jacobian`` a bucket),
    ``krylov_method`` and ``cg_max``.  ``checkpoint_cb`` is called after
    each update as ``cb(iterations, flat_solution, lambda, unresolved)`` on
    every rank.

    Returns ``(us, lam, residuals, unresolved)``.
    """
    comm = msys.comm
    subs = [sub for _, sub in msys.subsystems]
    n_lag = msys.n_lagrange
    newton = newton_ctx is not None
    residuals: list[float] = []
    aa_x: list[np.ndarray] = []
    aa_f: list[np.ndarray] = []
    for it in range(maximum_iterations):
        vms_parts = None
        if sg is not None:
            u_global = msys.unshard_dofs(us)
            with tracer.stage("svms-advection-update"):
                sg.update_nonlinear_advection(u_global)
            with tracer.stage("svms-unresolved"):
                unresolved = sg.compute_unresolved_contributions(u_global, unresolved)
            vms_parts = msys.shard_dofs(sg._project_to_coarse(unresolved))
        with tracer.stage("picard-residual"):
            r_elems = []
            g_u = torch.zeros(n_lag, dtype=torch.float64, device=comm.device)
            local_max = 0.0
            for i, (sub, u, b) in enumerate(zip(subs, us, bases)):
                r_elem, g = sub.residual_partial(lhs_blocks, rhs_blocks, u, lam, b)
                if vms_parts is not None:
                    r_elem = r_elem - vms_parts[i]
                r_elems.append(r_elem)
                g_u = g_u + g
                if r_elem.numel():
                    local_max = max(local_max, float(r_elem.abs().max()))
            max_res = comm.max(local_max, "norm")
            if n_lag:
                r_trace = c_t - comm.all_reduce(g_u, "residual")
                max_res = max(max_res, float(r_trace.abs().max()))
        residuals.append(max_res)
        if max_res <= absolute_tolerance or max_res <= max_mag * relative_tolerance:
            break

        step_sys, runner = msys, krylov_runner
        if newton and it > 0:
            with tracer.stage("newton-jacobian+inverse"):
                step_sys = msys.with_blocks(
                    [jac(u) for jac, u in zip(newton_ctx["jacobians"], us)]
                )
                runner = _trace_krylov(step_sys, newton_ctx["krylov_method"],
                                       newton_ctx["cg_max"])
        step_subs = [sub for _, sub in step_sys.subsystems]
        with tracer.stage("picard-solve"):
            dlam = lam
            if n_lag:
                dlam, _, _ = runner(step_sys.trace_rhs(r_elems, r_trace), cg_tolerance)
            dus = [sub.block_solve_sharded(r - sub.trace_t_of(dlam))
                   for sub, r in zip(step_subs, r_elems)]
        if anderson_m > 0 and not newton:
            # The single-device loop's extrapolation, on the gathered
            # (u, lambda): every rank holds the same vectors and so makes the
            # same choices.
            x_k = np.concatenate([msys.unshard_dofs(us), lam.cpu().numpy()])
            f_k = relax * np.concatenate([msys.unshard_dofs(dus), dlam.cpu().numpy()])
            grew = len(residuals) >= 2 and residuals[-1] > residuals[-2]
            x_new = anderson_step(aa_x, aa_f, x_k, f_k, anderson_m, grew)
            n_dofs = msys.disc.n_dofs
            us = msys.shard_dofs(x_new[:n_dofs])
            lam = torch.as_tensor(x_new[n_dofs:], dtype=torch.float64, device=comm.device)
        else:
            us = [u + relax * du for u, du in zip(us, dus)]
            lam = lam + relax * dlam
        if checkpoint_cb is not None:
            checkpoint_cb(it + 1, msys.unshard_dofs(us), lam.cpu().numpy(), unresolved)
    return us, lam, residuals, unresolved


def _steady_setup(system, disc: Discretization, comm, boundary_conditions, constrained_forms,
                  initial_solution, initial_lagrange):
    """What every sharded steady entry builds first: the compiled system,
    the forcing and constraints (host, replicated), the sharded frozen
    operator, and the rank's forcing, iterate and multipliers."""
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.continuity import add_system_constraints
    from mfv2d_torch.solver.solve import compute_forcing_vector

    compiled = CompiledSystem(system)
    with tracer.stage("assembly+constraints"):
        forcing = compute_forcing_vector(disc, system)
        linear_vectors = [
            forcing[disc.element_offsets[i] : disc.element_offsets[i + 1]]
            for i in range(disc.n_leaves)
        ]
        lagrange_mat, lagrange_vec = add_system_constraints(
            system, disc.mesh, disc.basis_cache, list(constrained_forms),
            list(boundary_conditions), disc.leaf_indices, disc.element_offsets,
            linear_vectors,
        )
    with tracer.stage("sharded-assembly+inverse"):
        msys = MultiBucketShardedSystem.from_assembly(
            disc, compiled.linear_blocks, lagrange_mat, comm
        )
    bases = msys.shard_dofs(forcing)
    us = (
        [torch.zeros_like(b) for b in bases]
        if initial_solution is None
        else msys.shard_dofs(initial_solution)
    )
    lam = torch.as_tensor(
        np.zeros(msys.n_lagrange) if initial_lagrange is None else np.asarray(initial_lagrange),
        dtype=torch.float64, device=comm.device,
    )
    c_vec = torch.as_tensor(lagrange_vec, dtype=torch.float64, device=comm.device)
    return compiled, forcing, lagrange_mat, lagrange_vec, msys, bases, us, lam, c_vec


def _newton_ctx(msys: MultiBucketShardedSystem, compiled, krylov_method: str, cg_max: int):
    return {
        "jacobians": [
            sub.make_newton_jacobian(compiled.lhs_blocks, compiled.rhs_blocks)
            for _, sub in msys.subsystems
        ],
        "krylov_method": krylov_method,
        "cg_max": cg_max,
    }


def _steady_solve(system, disc: Discretization, device_mesh, newton: bool, *,
                  boundary_conditions=(), constrained_forms=(), maximum_iterations: int = 20,
                  relax: float = 1.0, absolute_tolerance: float = 1e-10,
                  relative_tolerance: float = 0.0, cg_maximum_iterations: int = 2000,
                  cg_tolerance: float = 1e-13, krylov_method: str = "cg",
                  initial_solution=None, initial_lagrange=None, checkpoint_cb=None):
    comm = trace_comm(device_mesh)
    compiled, forcing, _, lagrange_vec, msys, bases, us, lam, c_vec = _steady_setup(
        system, disc, comm, boundary_conditions, constrained_forms, initial_solution,
        initial_lagrange,
    )
    runner = _trace_krylov(msys, krylov_method, cg_maximum_iterations)
    # The forcing and constraint values are replicated on the host.
    max_mag = max(float(np.abs(forcing).max(initial=0.0)),
                  float(np.abs(lagrange_vec).max(initial=0.0)))
    us, lam, residuals, _ = _sharded_nonlinear_iterate(
        msys, compiled.lhs_blocks, compiled.rhs_blocks, bases, c_vec, us, lam, runner,
        maximum_iterations=maximum_iterations, relax=relax,
        absolute_tolerance=absolute_tolerance, relative_tolerance=relative_tolerance,
        max_mag=max_mag, cg_tolerance=cg_tolerance, checkpoint_cb=checkpoint_cb,
        newton_ctx=(
            _newton_ctx(msys, compiled, krylov_method, cg_maximum_iterations) if newton else None
        ),
    )
    return msys.unshard_dofs(us), lam.cpu().numpy(), np.asarray(residuals)


def sharded_steady_solve(system, disc: Discretization, device_mesh, **kwargs):
    """Sharded steady solve: assembly, Picard, trace Schur Krylov.

    Every element-sized object (matrices, inverses, DoFs, residuals) stays
    on its rank for the whole solve; only the trace vector is replicated.
    ``disc`` is the rank's replicated discretization.  Takes
    ``boundary_conditions``, ``constrained_forms``, ``maximum_iterations``,
    ``relax``, ``absolute_tolerance``, ``relative_tolerance``,
    ``cg_maximum_iterations``, ``cg_tolerance``, ``krylov_method``,
    ``initial_solution``, ``initial_lagrange`` and ``checkpoint_cb``.
    Returns ``(solution_flat, lambda, residual_history)`` on every rank.
    """
    return _steady_solve(system, disc, device_mesh, False, **kwargs)


def sharded_newton_steady_solve(system, disc: Discretization, device_mesh, **kwargs):
    """Sharded exact-Newton steady solve.

    Takes the arguments of :func:`sharded_steady_solve`, and matches the
    single-device ``non_linear_solve_run(newton=True)``: the first
    correction uses the assembled (frozen) operator, every later one the
    exact element Jacobians at the iterate (forward mode on each rank's
    elements), from which each bucket's sharded system is inverted anew
    (the ``gj_inverse`` kernel, once a bucket a Newton step on every rank)
    and solved by the trace Krylov method ``krylov_method`` names.  Returns
    ``(solution_flat, lambda, residual_history)``.
    """
    return _steady_solve(system, disc, device_mesh, True, **kwargs)


# -- time marches -----------------------------------------------------------------


def _dual_mass_blocks(sub: ShardedBlockSystem, form_spec) -> torch.Tensor:
    """The rank's block-diagonal element mass matrices ``[E_rank, n, n]``
    (the dual map of the march carry)."""
    n = sub.n_dofs_per_element
    out = torch.zeros((sub.hi - sub.lo, n, n), dtype=torch.float64, device=sub.device)
    if sub.hi > sub.lo:
        offsets = form_spec.form_offsets(*sub.batch.orders)
        for i in range(len(form_spec)):
            lo, hi = offsets[i], offsets[i + 1]
            out[:, lo:hi, lo:hi] = sub.batch.mass(form_spec[i][1], False)
    return out


def _march_prologue(system, disc: Discretization, comm: TraceComm, time_settings,
                    boundary_conditions, constrained_forms, unsteady_bcs=None,
                    has_td_rhs: bool = False) -> SimpleNamespace:
    """What every sharded march builds first: the marched system, its
    constraints, the sharded frozen operator, the carry columns and mass
    blocks, and the per-step data.

    With unsteady boundary conditions (``unsteady_bcs``, the list as the
    caller gave it) or ``TimeDependent`` forcing, the constraint values of
    every step (``c_steps [nt, n_lag]``) and, where the element forcing
    changes, the rank's forcing of every step (``b_steps``, per bucket a
    list over the steps) are computed up front, each level frozen as the
    single-device march freezes it; both are None for data that does not
    change.
    """
    from mfv2d_torch.boundary import freeze_unsteady_boundary_conditions
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.continuity import add_system_constraints
    from mfv2d_torch.kform import TimeDependent
    from mfv2d_torch.solve_system_2d import update_system_for_time_march
    from mfv2d_torch.solver.solve import (
        compute_forcing_vector,
        find_time_carry_indices,
        sampled_time_steps,
    )

    marched = update_system_for_time_march(time_settings, system)
    compiled = CompiledSystem(marched)
    # Time-dependent OPERATOR coefficients would need the sharded blocks
    # assembled and inverted anew every step; refuse them as the JAX
    # package does rather than freeze them.
    if any(isinstance(f, TimeDependent) for f in compiled.fields):
        raise NotImplementedError(
            "TimeDependent interior-product (operator) fields are not supported in"
            " sharded marches (they would re-assemble and re-invert the sharded blocks"
            " every step).  The single-device path supports them: drop device_mesh"
            " from SolverSettings."
        )
    dt, nt = time_settings.dt, time_settings.nt

    def constraints(forcing, bcs):
        views = [forcing[disc.element_offsets[i] : disc.element_offsets[i + 1]]
                 for i in range(disc.n_leaves)]
        return add_system_constraints(
            marched, disc.mesh, disc.basis_cache, list(constrained_forms), bcs,
            disc.leaf_indices, disc.element_offsets, views,
        )

    with tracer.stage("assembly+constraints"):
        # The carry seed is the t = 0 forcing; with TimeDependent forcing it
        # differs from the first step's, at t = dt.
        forcing0 = None
        if has_td_rhs:
            TimeDependent.current_time = 0.0
            forcing0 = compute_forcing_vector(disc, marched)
            TimeDependent.current_time = dt
        forcing = compute_forcing_vector(disc, marched)
        forcing_raw = forcing.copy()
        bcs0 = (
            freeze_unsteady_boundary_conditions(list(unsteady_bcs), dt)
            if unsteady_bcs
            else list(boundary_conditions)
        )
        lagrange_mat, lagrange_vec = constraints(forcing, bcs0)
        # The weak boundary terms that the constraints added in place.
        forcing0 = forcing if forcing0 is None else forcing0 + (forcing - forcing_raw)
        c_steps = forcing_steps = None
        if unsteady_bcs or has_td_rhs:
            # Step i solves for t = (i + 1) dt.
            c_steps = np.empty((nt, lagrange_vec.size))
            c_steps[0] = lagrange_vec
            forcing_steps = [forcing]
            for ti in range(1, nt):
                t = (ti + 1) * dt
                if has_td_rhs:
                    TimeDependent.current_time = t
                    forcing_t = compute_forcing_vector(disc, marched)
                else:
                    forcing_t = forcing_raw.copy()
                _, c_steps[ti] = constraints(
                    forcing_t, freeze_unsteady_boundary_conditions(list(unsteady_bcs or ()), t)
                )
                forcing_steps.append(forcing_t)
            if all(np.array_equal(f, forcing_steps[0]) for f in forcing_steps[1:]):
                forcing_steps = None
            if np.ptp(c_steps, axis=0).max(initial=0.0) == 0.0:
                c_steps = None
    with tracer.stage("sharded-assembly+inverse"):
        msys = MultiBucketShardedSystem.from_assembly(
            disc, compiled.linear_blocks, lagrange_mat, comm
        )
    march_indices = tuple(sorted(
        marched.weight_forms.index(form) for form in time_settings.time_march_relations
    ))
    carry_cols = [
        torch.as_tensor(np.asarray(find_time_carry_indices(
            march_indices, marched.unknown_forms, *bucket.orders), np.int64), device=comm.device)
        for bucket, _ in msys.subsystems
    ]
    device = comm.device
    # The step's forcing and constraint values are replicated on the host,
    # and so is the scale of the relative tolerance taken from them.
    max_mag = max(float(np.abs(f).max(initial=0.0)) for f in (forcing_steps or [forcing]))
    max_mag = max(max_mag, float(np.abs(lagrange_vec if c_steps is None else c_steps)
                                 .max(initial=0.0)))
    return SimpleNamespace(
        compiled=compiled,
        marched=marched,
        march_indices=march_indices,
        msys=msys,
        b_elems=msys.shard_dofs(forcing),
        b0_elems=msys.shard_dofs(forcing0),
        c_vec=torch.as_tensor(lagrange_vec, dtype=torch.float64, device=device),
        c_steps=None if c_steps is None else torch.as_tensor(c_steps, device=device),
        b_steps=None if forcing_steps is None else [
            list(parts) for parts in zip(*(msys.shard_dofs(f) for f in forcing_steps))
        ],
        carry_cols=carry_cols,
        mass_blocks=[_dual_mass_blocks(sub, marched.unknown_forms) for _, sub in msys.subsystems],
        max_mag=max_mag,
        sample_steps=sampled_time_steps(nt, time_settings.sample_rate),
        two_over_dt=2.0 / dt,
        dt=dt,
        nt=nt,
    )


def _march_start(setup, us, lam0, residual_partial):
    """The consistent trapezoidal start from the state ``us``: the old
    carry is the dual of ``us`` on the carry rows and the carry term the
    spatial residual there plus ``2/dt`` the old carry (the seed forcing on
    the carry rows for a zero state)."""
    old, terms = [], []
    for (_, sub), u, b, cc, mb in zip(setup.msys.subsystems, us, setup.b0_elems,
                                      setup.carry_cols, setup.mass_blocks):
        oc = _gemv(mb, u)[:, cc]
        old.append(oc)
        terms.append(residual_partial(sub, u, lam0, b)[:, cc] + setup.two_over_dt * oc)
    return old, terms


def _march_gather_samples(msys: MultiBucketShardedSystem, samples) -> np.ndarray:
    """The rank's sampled states (per sample, one ``[E_rank, n]`` a bucket)
    -> the flat solutions ``[S, n_dofs]`` on every rank (one all_reduce)."""
    out = torch.zeros((len(samples), msys.disc.n_dofs), dtype=torch.float64, device=msys.device)
    for b, (bucket, sub) in enumerate(msys.subsystems):
        if sub.hi > sub.lo and samples:
            gather = torch.as_tensor(np.asarray(bucket.gather)[sub.lo : sub.hi],
                                     device=msys.device).reshape(-1)
            out[:, gather] = torch.stack([s[b].reshape(-1) for s in samples])
    return msys.comm.all_reduce(out, "gather").cpu().numpy()


def _march_loop(setup, solve_step, us, lam, old, terms, *, start: int = 0, on_step=None):
    """The trapezoidal step loop that the three sharded marches share.

    Step ``ti`` solves for ``t = (ti + 1) dt`` by ``solve_step(bases, c_t,
    us, lam) -> (us, lam, iterations, last residual)``, then advances the
    carry from the dual of the new state; the states of the sampled steps
    (``sampled_time_steps``, the host march's rule) are kept.  Returns
    ``(samples, sampled steps, lam, iterations [nt], residuals [nt])``.
    """
    iters = np.zeros(setup.nt, np.uint32)
    changes = np.zeros(setup.nt)
    sampled = set(setup.sample_steps.tolist())
    samples, kept = [], []
    for ti in range(start, setup.nt):
        c_t = setup.c_vec if setup.c_steps is None else setup.c_steps[ti]
        bs = setup.b_elems if setup.b_steps is None else [steps[ti] for steps in setup.b_steps]
        bases = [
            torch.index_add(b, 1, cc, setup.two_over_dt * oc + ct)
            for b, cc, oc, ct in zip(bs, setup.carry_cols, old, terms)
        ]
        us, lam, iters[ti], changes[ti] = solve_step(bases, c_t, us, lam)
        new = [_gemv(mb, u)[:, cc] for mb, u, cc in zip(setup.mass_blocks, us, setup.carry_cols)]
        terms = [setup.two_over_dt * (nc - oc) - ct for nc, oc, ct in zip(new, old, terms)]
        old = new
        if on_step is not None:
            on_step(ti, us, lam, old, terms)
        if ti in sampled:
            samples.append(us)
            kept.append(ti)
    return samples, np.asarray(kept, np.int64), lam, iters, changes


def _initial_state(setup, initial_solution):
    msys = setup.msys
    if initial_solution is None:
        return [torch.zeros_like(b) for b in setup.b_elems]
    return msys.shard_dofs(initial_solution)


def sharded_time_march(
    system,
    disc: Discretization,
    device_mesh,
    time_settings,
    *,
    boundary_conditions=(),
    constrained_forms=(),
    cg_maximum_iterations: int = 2000,
    cg_tolerance: float = 1e-12,
    krylov_method: str = "cg",
    unsteady_bcs=None,
    has_td_rhs: bool = False,
    initial_solution=None,
):
    """Sharded linear trapezoidal march: one saddle solve a step.

    Element data (DoFs, blocks, inverses, carry rows, masses) stays on its
    rank for the whole march; each step makes one reduce of the trace
    residual, one of the Schur right-hand side and one a Krylov matvec.
    Unsteady boundary values and ``TimeDependent`` forcing enter as
    per-step data; ``initial_solution`` (flat primal DoFs) seeds the march
    with the consistent trapezoidal carry.  The multipliers start at zero.

    Returns ``(solutions [S, n_dofs], sample_steps, lambda)``.
    """
    comm = trace_comm(device_mesh)
    setup = _march_prologue(system, disc, comm, time_settings, boundary_conditions,
                            constrained_forms, unsteady_bcs, has_td_rhs)
    compiled, msys = setup.compiled, setup.msys
    if compiled.nonlin_blocks is not None or compiled.rhs_blocks is not None:
        raise NotImplementedError(
            "sharded_time_march handles linear marches; nonlinear systems use"
            " sharded_nonlinear_time_march."
        )
    subs = [sub for _, sub in msys.subsystems]
    runner = _trace_krylov(msys, krylov_method, cg_maximum_iterations)

    def step(bases, c_t, us, lam):
        with tracer.stage("march-step"):
            r_elems = [b - _gemv(sub.blocks, u) - sub.trace_t_of(lam)
                       for b, sub, u in zip(bases, subs, us)]
            dlam = lam
            if msys.n_lagrange:
                g_u = sum(sub.trace_partial(u) for sub, u in zip(subs, us))
                r_trace = c_t - comm.all_reduce(g_u, "residual")
                dlam, _, _ = runner(msys.trace_rhs(r_elems, r_trace), cg_tolerance)
            us = [u + sub.block_solve_sharded(r - sub.trace_t_of(dlam))
                  for u, sub, r in zip(us, subs, r_elems)]
        return us, lam + dlam, 1, 0.0

    us = _initial_state(setup, initial_solution)
    lam = torch.zeros(msys.n_lagrange, dtype=torch.float64, device=comm.device)
    old, terms = _march_start(
        setup, us, lam, lambda sub, u, lam0, b: b - _gemv(sub.blocks, u)
    )
    samples, steps, lam, _, _ = _march_loop(setup, step, us, lam, old, terms)
    return _march_gather_samples(msys, samples), steps, lam.cpu().numpy()


def _picard_residual_partial(setup):
    compiled = setup.compiled
    return lambda sub, u, lam0, b: sub.residual_partial(
        compiled.lhs_blocks, compiled.rhs_blocks, u, lam0, b
    )[0]


def sharded_nonlinear_time_march(
    system,
    disc: Discretization,
    device_mesh,
    time_settings,
    *,
    boundary_conditions=(),
    constrained_forms=(),
    max_iterations: int = 20,
    relax: float = 1.0,
    absolute_tolerance: float = 1e-10,
    relative_tolerance: float = 0.0,
    cg_maximum_iterations: int = 2000,
    cg_tolerance: float = 1e-12,
    krylov_method: str = "cg",
    unsteady_bcs=None,
    has_td_rhs: bool = False,
    initial_solution=None,
):
    """Sharded nonlinear (Picard) trapezoidal march.

    Each step runs the Picard defect correction against the frozen
    operator: the residual on each rank's elements (the nonlinear fields
    rebuilt from the rank's own DoFs), the correction by the sharded trace
    Schur solve, then the carry update.  A step's iterations count its
    corrections, as the JAX package's fused march counts them; its
    residual is the last one evaluated.  Returns ``(solutions [S, n_dofs],
    sample_steps, lambda, iterations [nt], residuals [nt])``.
    """
    comm = trace_comm(device_mesh)
    setup = _march_prologue(system, disc, comm, time_settings, boundary_conditions,
                            constrained_forms, unsteady_bcs, has_td_rhs)
    msys, compiled = setup.msys, setup.compiled
    runner = _trace_krylov(msys, krylov_method, cg_maximum_iterations)

    def step(bases, c_t, us, lam):
        mag = _step_magnitude(comm, setup, bases)
        us, lam, res, _ = _sharded_nonlinear_iterate(
            msys, compiled.lhs_blocks, compiled.rhs_blocks, bases, c_t, us, lam, runner,
            maximum_iterations=max_iterations, relax=relax,
            absolute_tolerance=absolute_tolerance, relative_tolerance=relative_tolerance,
            max_mag=mag, cg_tolerance=cg_tolerance,
        )
        converged = res[-1] <= absolute_tolerance or res[-1] <= mag * relative_tolerance
        return us, lam, len(res) - converged, res[-1]

    us = _initial_state(setup, initial_solution)
    lam = torch.zeros(msys.n_lagrange, dtype=torch.float64, device=comm.device)
    if initial_solution is None:
        old = [torch.zeros_like(b[:, cc]) for b, cc in zip(setup.b0_elems, setup.carry_cols)]
        terms = [b[:, cc] for b, cc in zip(setup.b0_elems, setup.carry_cols)]
    else:
        old, terms = _march_start(setup, us, lam, _picard_residual_partial(setup))
    samples, steps, lam, iters, changes = _march_loop(setup, step, us, lam, old, terms)
    return _march_gather_samples(msys, samples), steps, lam.cpu().numpy(), iters, changes


def _step_magnitude(comm: TraceComm, setup, bases) -> float:
    """The scale of a step's relative tolerance: the replicated forcing and
    constraint values and the step's carried forcing (one MAX reduce)."""
    local = max((float(b.abs().max()) for b in bases if b.numel()), default=0.0)
    return max(setup.max_mag, comm.max(local, "magnitude"))


def _carry_flat_positions(disc: Discretization, msys: MultiBucketShardedSystem, march_indices):
    """Each bucket's positions ``[E, ncc]`` in the flat carry vector.

    The flat layout is the single-device ``time_carry_index_array`` order
    (the leaves' carry rows concatenated in leaf order), so the march files
    of the sharded host loop resume on the single-device path and the
    other way round.  Returns ``(positions, total)``.
    """
    from mfv2d_torch.solver.solve import find_time_carry_indices

    ncc_leaf = np.zeros(disc.n_leaves, np.int64)
    ncc_bucket = []
    for bucket, _ in msys.subsystems:
        ncc = len(find_time_carry_indices(march_indices, disc.form_spec, *bucket.orders))
        ncc_bucket.append(ncc)
        ncc_leaf[bucket.leaf_ranks] = ncc
    offs = np.concatenate([[0], np.cumsum(ncc_leaf)])
    positions = [
        offs[bucket.leaf_ranks][:, None] + np.arange(ncc, dtype=np.int64)[None, :]
        for (bucket, _), ncc in zip(msys.subsystems, ncc_bucket)
    ]
    return positions, int(offs[-1])


def _carries_to_flat(msys: MultiBucketShardedSystem, carries, positions, total: int) -> np.ndarray:
    """The ranks' carry rows -> the flat carry vector on every rank (one
    all_reduce)."""
    out = torch.zeros(total, dtype=torch.float64, device=msys.device)
    for (_, sub), c, pos in zip(msys.subsystems, carries, positions):
        if sub.hi > sub.lo:
            idx = torch.as_tensor(pos[sub.lo : sub.hi].reshape(-1), device=msys.device)
            out[idx] = c.reshape(-1)
    return msys.comm.all_reduce(out, "gather").cpu().numpy()


def _carries_from_flat(msys: MultiBucketShardedSystem, flat, positions) -> list[torch.Tensor]:
    flat = np.asarray(flat)
    return [
        torch.as_tensor(flat[pos[sub.lo : sub.hi]], dtype=torch.float64, device=msys.device)
        for (_, sub), pos in zip(msys.subsystems, positions)
    ]


def sharded_host_time_march(
    system,
    disc: Discretization,
    device_mesh,
    time_settings,
    *,
    boundary_conditions=(),
    constrained_forms=(),
    max_iterations: int = 20,
    relax: float = 1.0,
    absolute_tolerance: float = 1e-10,
    relative_tolerance: float = 0.0,
    cg_maximum_iterations: int = 2000,
    cg_tolerance: float = 1e-12,
    krylov_method: str = "cg",
    unsteady_bcs=None,
    has_td_rhs: bool = False,
    initial_solution=None,
    newton: bool = False,
    vms_settings=None,
    anderson_m: int = 0,
    checkpoint_settings=None,
    resume_state: dict | None = None,
):
    """The sharded trapezoidal march for Newton, VMS and checkpoints.

    The sharded per-step solve of :func:`sharded_nonlinear_time_march`,
    with what the JAX package's fused marches cannot hold: exact-Newton
    Jacobians inverted anew each iteration, the VMS unresolved-scale solve
    each iteration, Anderson extrapolation, and checkpoint writes.  A
    step's iterations count its residual evaluations.  ``resume_state`` (a
    :func:`mfv2d_torch.checkpoint.load_march_state` dict) restores the
    solution, multipliers and carries and skips the steps taken; the files
    (written by rank 0 behind a barrier) use the single-device flat carry
    layout, so they interchange with the single-device path's and the JAX
    package's.

    Returns ``(solutions [S, n_dofs], sample_steps, lambda, iterations
    [nt], residuals [nt], fine_scales)``; the fine scales are recovered for
    the final state of a VMS march, else None.
    """
    comm = trace_comm(device_mesh)
    setup = _march_prologue(system, disc, comm, time_settings, boundary_conditions,
                            constrained_forms, unsteady_bcs, has_td_rhs)
    msys, compiled = setup.msys, setup.compiled
    runner = _trace_krylov(msys, krylov_method, cg_maximum_iterations)
    newton_ctx = (
        _newton_ctx(msys, compiled, krylov_method, cg_maximum_iterations) if newton else None
    )
    sg = None
    if vms_settings is not None:
        from mfv2d_torch.boundary import freeze_unsteady_boundary_conditions
        from mfv2d_torch.parallel.vms import ShardedSuyashGreen

        # The fine-scale operator freezes its weak boundary forcing at the
        # first level, as the single-device march builds its operator once.
        bcs0 = (
            freeze_unsteady_boundary_conditions(list(unsteady_bcs), setup.dt)
            if unsteady_bcs
            else list(boundary_conditions)
        )
        with tracer.stage("vms-init"):
            sg = ShardedSuyashGreen(setup.marched, vms_settings, disc, comm, constrained_forms,
                                    bcs0, inner_max_iterations=cg_maximum_iterations)
    unresolved = None

    def step(bases, c_t, us, lam):
        nonlocal unresolved
        us, lam, res, unresolved = _sharded_nonlinear_iterate(
            msys, compiled.lhs_blocks, compiled.rhs_blocks, bases, c_t, us, lam, runner,
            maximum_iterations=max_iterations, relax=relax,
            absolute_tolerance=absolute_tolerance, relative_tolerance=relative_tolerance,
            max_mag=_step_magnitude(comm, setup, bases), cg_tolerance=cg_tolerance,
            anderson_m=anderson_m, newton_ctx=newton_ctx, sg=sg, unresolved=unresolved,
        )
        return us, lam, len(res), res[-1]

    positions, total = _carry_flat_positions(disc, msys, setup.march_indices)
    on_step = None
    if checkpoint_settings is not None:
        from mfv2d_torch.checkpoint import save_march_state

        every = max(1, checkpoint_settings.every)

        def on_step(ti, us, lam, old, terms):
            if (ti + 1) % every and ti + 1 != setup.nt:
                return
            flat = msys.unshard_dofs(us)
            old_flat = _carries_to_flat(msys, old, positions, total)
            terms_flat = _carries_to_flat(msys, terms, positions, total)
            if comm.rank == 0:
                save_march_state(checkpoint_settings.path, disc.mesh, flat, lam.cpu().numpy(),
                                 old_flat, terms_flat, ti + 1, setup.dt)
            comm.barrier()

    start = 0
    lam = torch.zeros(msys.n_lagrange, dtype=torch.float64, device=comm.device)
    if resume_state is not None:
        us = msys.shard_dofs(resume_state["solution"])
        lam = torch.as_tensor(resume_state["lagrange"], dtype=torch.float64, device=comm.device)
        old = _carries_from_flat(msys, resume_state["old_carry"], positions)
        terms = _carries_from_flat(msys, resume_state["carry_term"], positions)
        start = int(resume_state["time_index"])
    elif initial_solution is None:
        us = _initial_state(setup, None)
        old = [torch.zeros_like(b[:, cc]) for b, cc in zip(setup.b0_elems, setup.carry_cols)]
        terms = [b[:, cc] for b, cc in zip(setup.b0_elems, setup.carry_cols)]
    else:
        us = _initial_state(setup, initial_solution)
        old, terms = _march_start(setup, us, lam, _picard_residual_partial(setup))
    samples, steps, lam, iters, changes = _march_loop(
        setup, step, us, lam, old, terms, start=start, on_step=on_step
    )
    out = (
        _march_gather_samples(msys, samples)
        if samples
        else np.zeros((0, disc.n_dofs))
    )
    fine_scales = None
    if sg is not None:
        final = out[-1] if len(out) else msys.unshard_dofs(us)
        fine_scales = sg.recover_unresolved(final, unresolved)
    return out, steps, lam.cpu().numpy(), iters, changes, fine_scales
