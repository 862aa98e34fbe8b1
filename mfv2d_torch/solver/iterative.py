"""Element-local solvers of the hybridized saddle system.

The hybridized system

    [[A, G^T], [G, 0]] [u, lambda] = [b, c]

has A block-diagonal over elements and G a sparse constraint (trace) matrix.
This is the reference's ``LinearSystem``/``DenseVector``/``TraceVector``
layer (src/algebra/system_objects.c, python/mfv2d/solving.py): per-bucket
batched dense blocks on the discretization's device replace per-element CRS
matrices, and the trace exchange G/G^T is a pair of padded gathers.

The element inverses ``A_e^{-1}`` are explicit, in f64, built once per
bucket by the pivoted Gauss-Jordan kernel (:mod:`mfv2d_torch.ops.kernels.
gj_inverse`) and applied as batched GEMVs, with the residual refinement
rounds that :func:`mfv2d_torch.ops.precision.choose_refine_rounds` probes
(normally none).  This is the explicit-inverse branch of the JAX package's
``BlockSaddleSystem`` (mfv2d_tpu/solver/iterative.py), with the kernel in
place of its f32 seed and Newton-Schulz repair.

Solvers: CG on the Schur complement S = G A^{-1} G^T, static condensation
(S assembled and factored once by host SuperLU), GMRES / block-Jacobi PCG
on the full saddle system, and a dense LU of the whole saddle matrix, all
matching the reference algorithms (solving.py:178-684).

Not ported from the JAX module, and the ROADMAP entry that covers each:

- ``DeviceSchurFactor`` (Newton-Schulz dense trace inverse; the TPU has no
  sparse factorization): "Do not port".
- The lean-blocks / slice-provider and device-Green's machinery
  (``_bucket_block_chunks`` providers, ``_lean_inverse_build``,
  ``refine_floor``, ``relax_refine_rounds``, ``_dev_greens_*``): "Do not
  port".  The VMS Green's operator (:mod:`mfv2d_torch.solver.vms`) keeps
  its saddle blocks on the device and needs none of it.
- The f32, f32x2 and condensed-c32/c64 operator tables and their applies,
  ``trace_indefinite`` and the mixed TPU ladder (``_mixed_sweep_factory``,
  ``_solve_schur_mixed_tpu``): "Do not port".  The f64 loops of the JAX
  package's ``solver/krylov.py`` serve the sharded trace solves
  (:mod:`mfv2d_torch.solver.krylov`).  ``cg_general`` and ``gmres_general``
  below are the reference's algorithms (a start vector, the min of the
  absolute and relative tolerances, the last iterate, modified
  Gram-Schmidt), as in the JAX module, and share no loop with it.
- ``MixedPrecisionLU`` (the TPU's refined f32 dense LU): "Do not port".
- The Ozaki arguments (``ozaki=`` GEMMs): "Do not port".
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from mfv2d_torch.ops.kernels.gj_inverse import gj_inverse
from mfv2d_torch.ops.precision import choose_refine_rounds
from mfv2d_torch.solver.discretization import Discretization
from mfv2d_torch.solver.solve import ConvergenceSettings
from mfv2d_torch.tracing import tracer
from mfv2d_torch.transfer import to_device, to_host
from mfv2d_torch.utils.lazy import lazy_module

sp = lazy_module("scipy.sparse")
sla = lazy_module("scipy.sparse.linalg")

ITERATIVE_METHODS = ("schur", "schur_direct", "gmres", "pcg")


def _gemv(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched ``[E, n, n] @ [E, n]``."""
    return torch.einsum("eij,ej->ei", mats, vecs)


def _schur_rhs_solve(inv, blocks, rhs, rounds: int) -> torch.Tensor:
    """Batched ``A^{-1} @ rhs`` via the explicit inverse + refine rounds."""
    x = inv @ rhs
    for _ in range(rounds):
        x = x + inv @ (rhs - blocks @ x)
    return x


class BlockSaddleSystem:
    """Element-blocked saddle system on the discretization's device.

    Parameters
    ----------
    disc : Discretization
        Bucketed mesh discretization, or any object with ``n_dofs`` and
        ``buckets`` whose entries carry a ``gather`` map (the VMS Green's
        operator passes such a stand-in for its fine space).
    element_matrices : list of [E, n, n] arrays or tensors
        Per-bucket element matrix batches; tensors already on ``device`` are
        used as they are, without a copy.
    lagrange_mat : scipy CSR or None
        Constraint matrix G over the global DoF vector.
    device : torch.device, optional
        Where the blocks live; by default the device of the first bucket's
        element batch.
    min_refine_rounds : int
        Residual refinement rounds every apply runs at least, whatever the
        probe chooses.
    """

    def __init__(
        self,
        disc: Discretization,
        element_matrices: list,
        lagrange_mat: sp.csr_array | None,
        device=None,
        min_refine_rounds: int = 0,
    ) -> None:
        self.disc = disc
        self.n_dofs = disc.n_dofs
        self.lagrange_mat = lagrange_mat
        self.device = (
            disc.buckets[0].batch.device if device is None else torch.device(device)
        )
        self.blocks = [self._tensor(m) for m in element_matrices]
        # Explicit f64 inverses from the pivoted kernel; the probe picks the
        # refinement rounds each apply runs (normally zero).  The probe reads
        # its error on the host, so the span closes once the inverses ran.
        self.inverses = []
        self._refine_rounds = []
        with tracer.stage("block-inverse"):
            for b in self.blocks:
                inv = gj_inverse(b)
                rounds, _ = choose_refine_rounds(b, inv)
                tracer.count("block_refine_rounds", rounds)
                self.inverses.append(inv)
                self._refine_rounds.append(max(rounds, min_refine_rounds))
        self.gathers = [to_device(b.gather, self.device) for b in disc.buckets]
        # Bucket gathers partition [0, n_dofs); the inverse permutation maps
        # each global DoF to its position in the bucket-concatenated flat
        # vector, so block results assemble with a gather.
        inv_perm = np.empty(disc.n_dofs, np.int64)
        off = 0
        for b in disc.buckets:
            g = np.asarray(b.gather).reshape(-1)
            inv_perm[g] = off + np.arange(g.size)
            off += g.size
        self._inv_perm = to_device(inv_perm, self.device)

        if lagrange_mat is not None:
            coo = lagrange_mat.tocoo()
            self.n_lagrange = lagrange_mat.shape[0]
            self.g_rows = to_device(coo.row.astype(np.int64), self.device)
            self.g_cols = to_device(coo.col.astype(np.int64), self.device)
            self.g_vals = self._tensor(coo.data)
            # Both trace products are stored as zero-padded gathers:
            # row-major ([n_lag, k1]: G x) and column-major ([n_dofs, k2]:
            # G^T lam).
            csr = lagrange_mat.tocsr()
            self._row_cols, self._row_vals = self._padded_table(
                csr.indptr, csr.indices, csr.data, self.n_lagrange
            )
            csc = lagrange_mat.tocsc()
            self._col_rows, self._col_vals = self._padded_table(
                csc.indptr, csc.indices, csc.data, self.n_dofs
            )
        else:
            self.n_lagrange = 0
            self.g_rows = torch.zeros(0, dtype=torch.int64, device=self.device)
            self.g_cols = torch.zeros(0, dtype=torch.int64, device=self.device)
            self.g_vals = self._tensor(np.zeros(0))

    def _tensor(self, values) -> torch.Tensor:
        """``values`` as a contiguous f64 tensor on the system's device."""
        return to_device(values, self.device, torch.float64).contiguous()

    def _padded_table(self, indptr, indices, data, n_rows):
        counts = np.diff(indptr)
        k = max(1, int(counts.max()) if counts.size else 1)
        row_ids = np.repeat(np.arange(n_rows), counts)
        slots = np.arange(indices.size) - np.repeat(indptr[:-1], counts)
        out_idx = np.zeros((n_rows, k), np.int64)
        out_val = np.zeros((n_rows, k))
        out_idx[row_ids, slots] = indices
        out_val[row_ids, slots] = data
        return to_device(out_idx, self.device), self._tensor(out_val)

    # -- block-diagonal operators --------------------------------------

    def _assemble(self, parts) -> torch.Tensor:
        """Bucket-flat results -> global DoF vector via the inverse perm."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        return flat[self._inv_perm]

    def apply_diagonal(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with A block-diagonal (batched GEMV per bucket)."""
        return self._assemble(
            [_gemv(b, x[g]) for b, g in zip(self.blocks, self.gathers)]
        )

    def apply_diagonal_inverse(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^{-1} x: one batched GEMV against the explicit f64 inverse
        per bucket, plus the probe-chosen refinement rounds."""
        parts = []
        for inv, blocks, g, rounds in zip(
            self.inverses, self.blocks, self.gathers, self._refine_rounds
        ):
            xe = x[g]
            ye = _gemv(inv, xe)
            for _ in range(rounds):
                ye = ye + _gemv(inv, xe - _gemv(blocks, ye))
            parts.append(ye)
        return self._assemble(parts)

    # -- trace (constraint) operator -----------------------------------

    def apply_trace(self, x: torch.Tensor) -> torch.Tensor:
        """G x as a padded row-major gather."""
        if self.n_lagrange == 0:
            return self._tensor(np.zeros(0))
        return torch.sum(self._row_vals * x[self._row_cols], dim=1)

    def apply_trace_transpose(self, lam: torch.Tensor) -> torch.Tensor:
        """G^T lambda as a padded column-major gather."""
        if self.n_lagrange == 0:
            return self._tensor(np.zeros(self.n_dofs))
        return torch.sum(self._col_vals * lam[self._col_rows], dim=1)

    # -- composite operators -------------------------------------------

    def apply_saddle(self, u: torch.Tensor, lam: torch.Tensor):
        """[[A, G^T], [G, 0]] applied to (u, lambda)."""
        return (
            self.apply_diagonal(u) + self.apply_trace_transpose(lam),
            self.apply_trace(u),
        )

    def apply_schur(self, lam: torch.Tensor) -> torch.Tensor:
        """S lambda = G A^{-1} G^T lambda."""
        return self.apply_trace(
            self.apply_diagonal_inverse(self.apply_trace_transpose(lam))
        )

    def _condensed_buckets(self):
        """Per-bucket condensed trace blocks (cached; static condensation).

        A is block-diagonal so S = sum_e G_e A_e^{-1} G_e^T with each term a
        small dense block over the c constraints touching element e.  Returns
        ``[(se, rows_pad, valid), ...]`` per bucket with ``se [n_e, c, c]``
        (f64 numpy), ``rows_pad [n_e, c]`` the constraint indices, and
        ``valid`` the slot mask.  Each block is two batched GEMMs against the
        explicit inverse on the device.
        """
        cached = getattr(self, "_condensed_cache", None)
        if cached is not None:
            return cached
        if self.n_lagrange == 0:
            raise ValueError("System has no constraints; Schur is empty.")
        g = sp.coo_array(self.lagrange_mat)
        n_lag = self.n_lagrange
        out: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for i_bucket, bucket in enumerate(self.disc.buckets):
            gather = np.asarray(bucket.gather)
            n_e, n = gather.shape
            # Constraint entries owned by this bucket, as (element, local
            # dof) pairs.
            col_map = np.full(self.disc.n_dofs, -1, np.int64)
            col_map[gather.ravel()] = np.arange(n_e * n)
            flat = col_map[g.col]
            sel = flat >= 0
            e_idx = flat[sel] // n
            d_idx = flat[sel] % n
            r_idx = np.asarray(g.row)[sel].astype(np.int64)
            v_ent = np.asarray(g.data)[sel]
            if e_idx.size == 0:
                out.append(
                    (
                        np.zeros((n_e, 1, 1)),
                        np.zeros((n_e, 1), np.int64),
                        np.zeros((n_e, 1), bool),
                    )
                )
                continue

            # Unique (element, row) pairs -> a padded slot table per element.
            pair_key = e_idx * n_lag + r_idx
            uniq, pair_inv = np.unique(pair_key, return_inverse=True)
            ue = uniq // n_lag
            ur = uniq % n_lag
            counts = np.bincount(ue, minlength=n_e)
            k_max = int(counts.max())
            slot_of_pair = (
                np.arange(uniq.size) - np.concatenate(([0], np.cumsum(counts)))[ue]
            )
            ge = np.zeros((n_e, k_max, n))
            np.add.at(ge, (e_idx, slot_of_pair[pair_inv], d_idx), v_ent)
            rows_pad = np.zeros((n_e, k_max), np.int64)
            rows_pad[ue, slot_of_pair] = ur
            valid = np.zeros((n_e, k_max), bool)
            valid[ue, slot_of_pair] = True

            # Batched S_e = G_e A_e^{-1} G_e^T, chunked to bound memory.
            rounds = self._refine_rounds[i_bucket]
            inv = self.inverses[i_bucket]
            blocks = self.blocks[i_bucket]
            ge_dev = self._tensor(ge)
            flops = 4.0 * n * n * k_max * (1 + 2 * rounds)
            chunk = max(1, min(n_e, int(3e10 / max(flops, 1.0))))
            se_full = np.zeros((n_e, k_max, k_max))
            for c0 in range(0, n_e, chunk):
                c1 = min(c0 + chunk, n_e)
                ge_c = ge_dev[c0:c1]
                sol = _schur_rhs_solve(
                    inv[c0:c1], blocks[c0:c1], ge_c.transpose(1, 2), rounds
                )
                se = to_host(ge_c @ sol)
                mask = valid[c0:c1, :, None] & valid[c0:c1, None, :]
                se_full[c0:c1] = np.where(mask, se, 0.0)
            out.append((se_full, rows_pad, valid))
        self._condensed_cache = out
        return out

    def assemble_schur_sparse(self) -> sp.csr_array:
        """Assemble S = G A^{-1} G^T explicitly (static condensation).

        Scatters the cached per-bucket condensed blocks
        (:meth:`_condensed_buckets`) into a sparse trace matrix (size
        n_lagrange) whose sparse factorization replaces the whole CG
        iteration: the classic hybridized-FEM direct trace solve.
        """
        rows_acc: list[np.ndarray] = []
        cols_acc: list[np.ndarray] = []
        vals_acc: list[np.ndarray] = []
        with tracer.stage("condense"):
            buckets = self._condensed_buckets()
        for se_full, rows_pad, valid in buckets:
            mask = valid[:, :, None] & valid[:, None, :]
            rows_full = np.broadcast_to(rows_pad[:, :, None], se_full.shape)
            cols_full = np.broadcast_to(rows_pad[:, None, :], se_full.shape)
            rows_acc.append(rows_full[mask])
            cols_acc.append(cols_full[mask])
            vals_acc.append(se_full[mask])
        s = sp.coo_array(
            (
                np.concatenate(vals_acc),
                (np.concatenate(rows_acc), np.concatenate(cols_acc)),
            ),
            shape=(self.n_lagrange, self.n_lagrange),
        )
        return sp.csr_array(s.tocsr())

    def schur_decomposition(self):
        """Cached host SuperLU factorization of the assembled Schur complement
        (traced: ``condense``, the sparse assembly, then ``superlu``, which
        counts the column ordering it took, :func:`trace_column_ordering`,
        and the entries its factors store, SuperLU's ``nnz``)."""
        decomp = getattr(self, "_schur_decomp", None)
        if decomp is None:
            schur = sp.csc_matrix(self.assemble_schur_sparse())
            with tracer.stage("superlu"):
                permc_spec = trace_column_ordering(schur)
                tracer.count(
                    "superlu_min_degree" if permc_spec == "MMD_AT_PLUS_A" else "superlu_colamd"
                )
                decomp = sla.splu(schur, permc_spec=permc_spec)
                tracer.count("trace_lu_nonzeros", decomp.nnz)
            self._schur_decomp = decomp
        return decomp

    def schur_jacobi_diagonal(self) -> torch.Tensor:
        """Cheap approximation of diag(S) for Jacobi preconditioning.

        Uses diag(A) in place of A: diag(S)[r] ~= sum_c G[r,c]^2 / diag(A)[c].
        Exact when A is diagonal; in practice a solid scaling for the
        interface-mass-like constraint rows.
        """
        diag_a = self._tensor(np.zeros(self.n_dofs))
        for b, g in zip(self.blocks, self.gathers):
            diag_a[g] = torch.diagonal(b, dim1=1, dim2=2)
        safe = torch.where(diag_a.abs() > 1e-300, diag_a, 1.0)
        contrib = self.g_vals * self.g_vals / safe[self.g_cols].abs()
        diag_s = self._tensor(np.zeros(self.n_lagrange)).index_add_(
            0, self.g_rows, contrib
        )
        return torch.where(diag_s > 0, diag_s, 1.0)


def trace_column_ordering(schur) -> str:
    """SuperLU's ``permc_spec`` for the assembled trace matrix S.

    S = sum_e G_e A_e^{-1} G_e^T scatters each element's dense block onto
    the same rows and columns, so its pattern is symmetric, and a minimum
    degree ordering of A^T + A fits it.  That ordering pays only while the
    row pivots stay on the diagonal, as they do where S is definite: 64x64
    p=8 mixed Poisson (S negative definite) leaves 24.3 M non-zeros in L + U
    against COLAMD's 65.9 M.  An indefinite S pivots off its diagonal, and
    there the minimum degree ordering fills more than COLAMD (16x16 p=8
    Stokes 18.1 M against 7.6 M, 12x12 p=5 Navier-Stokes 5.1 M against
    1.5 M).  So S takes it only where its diagonal, read in O(n), has one
    strict sign, as a definite matrix's has; a zero or both signs there
    (Stokes, Navier-Stokes, a saddle block) keep SciPy's default, COLAMD.
    Row pivoting stays at SciPy's default threshold either way.
    """
    diagonal = schur.diagonal()
    definite_sign = bool(np.all(diagonal > 0) or np.all(diagonal < 0))
    return "MMD_AT_PLUS_A" if definite_sign else "COLAMD"


# ---------------------------------------------------------------------------
# Generic Krylov methods (reference solving.py:178-436)
# ---------------------------------------------------------------------------


def _stopping_tolerance(rhs_norm: float, convergence: ConvergenceSettings) -> float:
    """Reference stopping rule: min of absolute and relative tolerances."""
    rel = rhs_norm * convergence.relative_tolerance
    if rel > convergence.absolute_tolerance:
        return convergence.absolute_tolerance
    return rel if rel > 0.0 else convergence.absolute_tolerance


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def cg_general(
    apply_system: Callable,
    rhs: torch.Tensor,
    initial_guess: torch.Tensor,
    convergence: ConvergenceSettings,
) -> tuple[torch.Tensor, float, int]:
    """Conjugate gradients on an SPD operator."""
    rhs_mag2 = _dot(rhs, rhs)
    tol = _stopping_tolerance(np.sqrt(rhs_mag2), convergence)
    x = initial_guess
    res = rhs - apply_system(x)
    p = res
    res_mag2 = _dot(res, res)
    iter_cnt = 0
    for iter_cnt in range(convergence.maximum_iterations):
        ap = apply_system(p)
        apa = _dot(ap, p)
        if apa == 0.0:
            break
        alpha = res_mag2 / apa
        x = x + alpha * p
        res = res - alpha * ap
        new_mag2 = _dot(res, res)
        if new_mag2 < tol * tol:
            res_mag2 = new_mag2
            break
        beta = new_mag2 / res_mag2
        res_mag2 = new_mag2
        p = res + beta * p
    return x, float(np.sqrt(res_mag2)), iter_cnt + 1


def pcg_general(
    apply_system: Callable,
    apply_preconditioner: Callable,
    rhs: torch.Tensor,
    initial_guess: torch.Tensor,
    convergence: ConvergenceSettings,
    degen_limit: float = 1e-12,
) -> tuple[torch.Tensor, float, int]:
    """Preconditioned CG (reference solving.py:280-347)."""
    rhs_mag2 = _dot(rhs, rhs)
    tol = _stopping_tolerance(np.sqrt(rhs_mag2), convergence)
    x = initial_guess
    res = rhs - apply_system(x)
    z = apply_preconditioner(res)
    p = z
    res_mag2 = _dot(res, res)
    rz = _dot(res, z)
    iter_cnt = 0
    if res_mag2 <= tol * tol:
        # Zero RHS / already-converged guess: the first alpha would be 0 / 0.
        return x, float(np.sqrt(res_mag2)), 0
    for iter_cnt in range(convergence.maximum_iterations):
        ap = apply_system(p)
        apa = _dot(ap, p)
        if res_mag2 > 0 and abs(apa) / res_mag2 < degen_limit:
            raise RuntimeError(
                "PCG breakdown: p'Ap was not positive - operator is not SPD."
            )
        if apa == 0.0:
            break
        alpha = rz / apa
        x = x + alpha * p
        res = res - alpha * ap
        res_mag2 = _dot(res, res)
        if res_mag2 < tol * tol:
            break
        z = apply_preconditioner(res)
        new_rz = _dot(res, z)
        beta = new_rz / rz
        rz = new_rz
        p = z + beta * p
    return x, float(np.sqrt(res_mag2)), iter_cnt + 1


def gmres_general(
    apply_system: Callable,
    rhs: torch.Tensor,
    initial_guess: torch.Tensor,
    convergence: ConvergenceSettings,
    restart: int | None = None,
) -> tuple[torch.Tensor, float, int]:
    """GMRES with Givens rotations (reference solving.py:178-277).

    ``maximum_iterations`` bounds the Krylov dimension; optional restarts.
    """
    m = convergence.maximum_iterations if restart is None else restart
    x = initial_guess
    total_iters = 0
    outer_max = (
        1 if restart is None else max(1, convergence.maximum_iterations // restart)
    )

    rhs_mag = float(torch.linalg.vector_norm(rhs))
    tol = _stopping_tolerance(rhs_mag, convergence)
    r_mag = np.inf
    for _ in range(outer_max):
        res = rhs - apply_system(x)
        r_mag = float(torch.linalg.vector_norm(res))
        if r_mag < tol or r_mag == 0.0:
            break
        g = np.zeros(m + 1)
        h = np.zeros((m + 1, m))
        ck = np.zeros(m)
        sk = np.zeros(m)
        vs = [res / r_mag]
        g[0] = r_mag
        k = 0
        for k in range(m):
            w = apply_system(vs[k])
            for i in range(k + 1):
                h[i, k] = _dot(w, vs[i])
                w = w - h[i, k] * vs[i]
            h[k + 1, k] = float(torch.linalg.vector_norm(w))
            if h[k + 1, k] > 1e-300:
                vs.append(w / h[k + 1, k])
            else:
                vs.append(w)
            # Apply stored Givens rotations.
            for i in range(k):
                tmp = ck[i] * h[i, k] + sk[i] * h[i + 1, k]
                h[i + 1, k] = -sk[i] * h[i, k] + ck[i] * h[i + 1, k]
                h[i, k] = tmp
            rho = np.hypot(h[k, k], h[k + 1, k])
            if rho == 0.0:
                k += 1
                break
            ck[k] = h[k, k] / rho
            sk[k] = h[k + 1, k] / rho
            h[k, k] = rho
            h[k + 1, k] = 0.0
            g[k + 1] = -sk[k] * g[k]
            g[k] = ck[k] * g[k]
            total_iters += 1
            if abs(g[k + 1]) < tol:
                k += 1
                break
        else:
            k = m
        # Solve the triangular system and update x.  A zero diagonal entry
        # (lucky/singular breakdown) would make the solve raise: shrink to
        # the leading nonsingular block and keep the best iterate.
        while k > 0 and h[k - 1, k - 1] == 0.0:
            k -= 1
        if k > 0:
            y = np.linalg.solve(h[:k, :k], g[:k])
            for i in range(k):
                x = x + y[i] * vs[i]
        r_mag = abs(g[k]) if k < len(g) else r_mag
        if r_mag < tol:
            break
    return x, float(r_mag), total_iters


# ---------------------------------------------------------------------------
# Saddle-system solvers
# ---------------------------------------------------------------------------


def solve_schur_iterative(
    system: BlockSaddleSystem,
    rhs,
    constraints,
    convergence: ConvergenceSettings,
    preconditioner: str | None = None,
    initial_lagrange=None,
) -> tuple[torch.Tensor, torch.Tensor, float, int]:
    """Solve via the trace Schur complement (reference solving.py:439-500).

    CG on S lambda = G A^{-1} b - c, then u = A^{-1}(b - G^T lambda).
    ``preconditioner="jacobi"`` scales by the diag(A)-approximate diag(S).
    """
    inv_a_b = system.apply_diagonal_inverse(system._tensor(rhs))
    trace_rhs = system.apply_trace(inv_a_b) - system._tensor(constraints)
    lam0 = system._tensor(
        np.zeros(system.n_lagrange) if initial_lagrange is None else initial_lagrange
    )
    if preconditioner == "jacobi" and system.n_lagrange > 0:
        inv_diag = 1.0 / system.schur_jacobi_diagonal()
        lam, residual, iters = pcg_general(
            system.apply_schur, lambda v: inv_diag * v, trace_rhs, lam0, convergence
        )
    else:
        lam, residual, iters = cg_general(
            system.apply_schur, trace_rhs, lam0, convergence
        )
    u = inv_a_b - system.apply_diagonal_inverse(system.apply_trace_transpose(lam))
    return u, lam, residual, iters


def solve_schur_direct(
    system: BlockSaddleSystem,
    rhs,
    constraints,
) -> tuple[torch.Tensor, torch.Tensor, float, int]:
    """Direct trace solve: factor the assembled S = G A^{-1} G^T once.

    No Krylov iterations: the (sparse, trace-sized) Schur matrix is LU-factored
    on the host and every subsequent solve is two triangular sweeps plus
    batched element inverse applies on the device.
    """
    with tracer.stage("schur-factor"):
        decomp = system.schur_decomposition()
    with tracer.stage("inv-apply"):
        inv_a_b = system.apply_diagonal_inverse(system._tensor(rhs))
        trace_rhs = system.apply_trace(inv_a_b) - system._tensor(constraints)
        trace_rhs = to_host(trace_rhs)
    with tracer.stage("trace-solve"):
        lam = system._tensor(decomp.solve(trace_rhs))
    with tracer.stage("inv-apply"):
        u = inv_a_b - system.apply_diagonal_inverse(system.apply_trace_transpose(lam))
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
    return u, lam, 0.0, 1


def _full_pack(system: BlockSaddleSystem, u, lam):
    return torch.cat([u, lam])


def _full_apply(system: BlockSaddleSystem, x):
    u = x[: system.n_dofs]
    lam = x[system.n_dofs :]
    yu, yl = system.apply_saddle(u, lam)
    return torch.cat([yu, yl])


def _full_rhs(system: BlockSaddleSystem, rhs, constraints) -> torch.Tensor:
    return _full_pack(system, system._tensor(rhs), system._tensor(constraints))


def solve_gmres_iterative(
    system: BlockSaddleSystem,
    rhs,
    constraints,
    convergence: ConvergenceSettings,
) -> tuple[torch.Tensor, torch.Tensor, float, int]:
    """GMRES on the full saddle system.

    Large systems default to restarted GMRES(200): an unbounded Krylov basis
    of n maximum_iterations vectors is O(n^2) memory, which dominates for
    n_dofs beyond ~10^4.
    """
    full_rhs = _full_rhs(system, rhs, constraints)
    restart = 200 if convergence.maximum_iterations > 500 else None
    x, residual, iters = gmres_general(
        lambda v: _full_apply(system, v),
        full_rhs,
        torch.zeros_like(full_rhs),
        convergence,
        restart=restart,
    )
    return x[: system.n_dofs], x[system.n_dofs :], residual, iters


def solve_cg_iterative(
    system: BlockSaddleSystem,
    rhs,
    constraints,
    convergence: ConvergenceSettings,
) -> tuple[torch.Tensor, torch.Tensor, float, int]:
    """CG on the full (symmetric, indefinite) saddle system.

    Matches reference solve_cg_iterative; like the reference it relies on the
    system behaving well enough for CG despite indefiniteness.
    """
    full_rhs = _full_rhs(system, rhs, constraints)
    x, residual, iters = cg_general(
        lambda v: _full_apply(system, v),
        full_rhs,
        torch.zeros_like(full_rhs),
        convergence,
    )
    return x[: system.n_dofs], x[system.n_dofs :], residual, iters


def solve_pcg_iterative(
    system: BlockSaddleSystem,
    rhs,
    constraints,
    convergence: ConvergenceSettings,
) -> tuple[torch.Tensor, torch.Tensor, float, int]:
    """Block-Jacobi preconditioned CG on the full saddle system."""
    full_rhs = _full_rhs(system, rhs, constraints)

    def precondition(v):
        u = system.apply_diagonal_inverse(v[: system.n_dofs])
        return torch.cat([u, v[system.n_dofs :]])

    x, residual, iters = pcg_general(
        lambda v: _full_apply(system, v),
        precondition,
        full_rhs,
        torch.zeros_like(full_rhs),
        convergence,
    )
    return x[: system.n_dofs], x[system.n_dofs :], residual, iters


def make_block_saddle_system(
    disc: Discretization,
    element_matrices: list,
    lagrange_mat: sp.csr_array | None,
    device=None,
    min_refine_rounds: int = 0,
) -> BlockSaddleSystem:
    """BlockSaddleSystem with the element blocks stored on the device."""
    return BlockSaddleSystem(disc, element_matrices, lagrange_mat, device, min_refine_rounds)


class IterativeSaddleSolver:
    """Drop-in alternative to FrozenSaddleSolver using the Schur/GMRES path.

    ``method`` is one of "schur", "schur_direct", "gmres" or "pcg".
    """

    def __init__(
        self,
        disc: Discretization,
        element_matrices: list[np.ndarray],
        lagrange_mat: sp.csr_array | None,
        convergence: ConvergenceSettings,
        method: str = "schur",
    ) -> None:
        if method not in ITERATIVE_METHODS:
            raise ValueError(f"Unknown iterative method {method!r}.")
        self.system = make_block_saddle_system(disc, element_matrices, lagrange_mat)
        self.convergence = convergence
        self.method = method
        self.n_lagrange = self.system.n_lagrange

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        b = rhs[: self.system.n_dofs]
        c = rhs[self.system.n_dofs :]
        if self.method == "schur_direct":
            u, lam, _, _ = solve_schur_direct(self.system, b, c)
        elif self.method == "schur":
            u, lam, _, _ = solve_schur_iterative(self.system, b, c, self.convergence)
        elif self.method == "gmres":
            u, lam, _, _ = solve_gmres_iterative(self.system, b, c, self.convergence)
        else:
            u, lam, _, _ = solve_pcg_iterative(self.system, b, c, self.convergence)
        return to_host(torch.cat([u, lam]))


def assemble_dense_saddle(
    disc: Discretization,
    element_matrices,
    lagrange_mat: sp.csr_array | None,
) -> tuple[np.ndarray, int]:
    """Dense [[A, G^T], [G, 0]] from per-bucket element blocks."""
    n = disc.n_dofs
    n_lag = 0 if lagrange_mat is None else lagrange_mat.shape[0]
    mat = np.zeros((n + n_lag, n + n_lag))
    for bucket, blocks in zip(disc.buckets, element_matrices):
        for j in range(blocks.shape[0]):
            idx = bucket.gather[j]
            mat[np.ix_(idx, idx)] = blocks[j]
    if lagrange_mat is not None:
        g = lagrange_mat.toarray()
        mat[:n, n:] = g.T
        mat[n:, :n] = g
    return mat, n_lag


class DenseSaddleSolver:
    """Dense LU of the full saddle matrix on the discretization's device.

    For the moderate system sizes of 2D spectral meshes (10^3..10^4 DoFs) a
    dense factorization on the device avoids the host sparse LU; the
    factorization is kept and every Picard step is a pair of triangular
    solves.
    """

    def __init__(
        self,
        disc: Discretization,
        element_matrices: list[np.ndarray],
        lagrange_mat: sp.csr_array | None,
    ) -> None:
        mat, self.n_lagrange = assemble_dense_saddle(
            disc, element_matrices, lagrange_mat
        )
        self.device = disc.buckets[0].batch.device
        self._lu, self._piv = torch.linalg.lu_factor(
            to_device(mat, self.device, torch.float64)
        )

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        b = to_device(rhs, self.device, torch.float64)
        x = torch.linalg.lu_solve(self._lu, self._piv, b[:, None])[:, 0]
        return to_host(x)
