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
shards; ``torch.distributed`` does not).  The sharded marches, Newton, VMS
and refinement are still to port (ROADMAP item 10).
"""

from __future__ import annotations

import os
from dataclasses import replace

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

    def __init__(self, disc: Discretization, element_matrices, lagrange_mat, mesh) -> None:
        self.comm = trace_comm(mesh)
        self.disc = disc
        self.n_lagrange = 0 if lagrange_mat is None else int(lagrange_mat.shape[0])
        self.subsystems = []
        for bucket, mats in zip(disc.buckets, element_matrices, strict=True):
            sub_disc, sub_g = self._bucket_view(disc, bucket, lagrange_mat, self.n_lagrange)
            self.subsystems.append(
                (bucket, ShardedBlockSystem(sub_disc, mats, sub_g, self.comm))
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
    checkpoint_cb=None,
):
    """The Picard (defect-correction) loop over the sharded saddle system.

    Mirrors the single-device ``non_linear_solve_run``: the residual of the
    iterate, its correction through the frozen trace Schur solve, and an
    optional guarded Anderson extrapolation.  Every stop decision reads a
    reduced value, so the ranks leave together.  ``checkpoint_cb`` is
    called after each update as ``cb(iterations, flat_solution, lambda,
    None)`` on every rank.

    Returns ``(us, lam, residuals)``.
    """
    comm = msys.comm
    subs = [sub for _, sub in msys.subsystems]
    n_lag = msys.n_lagrange
    residuals: list[float] = []
    aa_x: list[np.ndarray] = []
    aa_f: list[np.ndarray] = []
    for it in range(maximum_iterations):
        with tracer.stage("picard-residual"):
            r_elems = []
            g_u = torch.zeros(n_lag, dtype=torch.float64, device=comm.device)
            local_max = 0.0
            for sub, u, b in zip(subs, us, bases):
                r_elem, g = sub.residual_partial(lhs_blocks, rhs_blocks, u, lam, b)
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

        with tracer.stage("picard-solve"):
            dlam = lam
            if n_lag:
                dlam, _, _ = krylov_runner(msys.trace_rhs(r_elems, r_trace), cg_tolerance)
            dus = [sub.block_solve_sharded(r - sub.trace_t_of(dlam))
                   for sub, r in zip(subs, r_elems)]
        if anderson_m > 0:
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
            checkpoint_cb(it + 1, msys.unshard_dofs(us), lam.cpu().numpy(), None)
    return us, lam, residuals


def sharded_steady_solve(
    system,
    disc: Discretization,
    device_mesh,
    *,
    boundary_conditions=(),
    constrained_forms=(),
    maximum_iterations: int = 20,
    relax: float = 1.0,
    absolute_tolerance: float = 1e-10,
    relative_tolerance: float = 0.0,
    cg_maximum_iterations: int = 2000,
    cg_tolerance: float = 1e-13,
    krylov_method: str = "cg",
    initial_solution=None,
    initial_lagrange=None,
    checkpoint_cb=None,
):
    """Sharded steady solve: assembly, Picard, trace Schur Krylov.

    Every element-sized object (matrices, inverses, DoFs, residuals) stays
    on its rank for the whole solve; only the trace vector is replicated.
    ``disc`` is the rank's replicated discretization.  Returns
    ``(solution_flat, lambda, residual_history)`` on every rank.
    """
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.continuity import add_system_constraints
    from mfv2d_torch.solver.solve import compute_forcing_vector

    comm = trace_comm(device_mesh)
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
        runner = _trace_krylov(msys, krylov_method, cg_maximum_iterations)
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
    # The forcing and constraint values are replicated on the host.
    max_mag = max(float(np.abs(forcing).max(initial=0.0)),
                  float(np.abs(lagrange_vec).max(initial=0.0)))
    us, lam, residuals = _sharded_nonlinear_iterate(
        msys, compiled.lhs_blocks, compiled.rhs_blocks, bases, c_vec, us, lam, runner,
        maximum_iterations=maximum_iterations, relax=relax,
        absolute_tolerance=absolute_tolerance, relative_tolerance=relative_tolerance,
        max_mag=max_mag, cg_tolerance=cg_tolerance, checkpoint_cb=checkpoint_cb,
    )
    return msys.unshard_dofs(us), lam.cpu().numpy(), np.asarray(residuals)
