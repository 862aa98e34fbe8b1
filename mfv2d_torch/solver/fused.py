"""Device-resident solve loops over a dense saddle factorization.

The steady Picard and exact-Newton iterations and the trapezoidal time
marches (linear, Picard, Newton) of the ``"dense"`` linear solver.  The JAX
package compiles each of them into one XLA program (``lax.scan`` over the
steps, ``lax.while_loop`` over the iterations).  Here they are Python loops
over device tensors: the iterate, multipliers, carry and factorization stay
on the device, and each iteration reads one number to the host, the residual
norm its exit test needs.  Semantics match the host loop
(``solver.solve.non_linear_solve_run`` per step, then the carry update).
"""

from __future__ import annotations

import numpy as np
import torch

from mfv2d_torch.solver.discretization import Discretization
from mfv2d_torch.utils.lazy import lazy_module

sp = lazy_module("scipy.sparse")


def _device_lu_solver(mat: torch.Tensor):
    """Dense f64 LU of ``mat``; returns ``solve(b)``."""
    lu, piv = torch.linalg.lu_factor(mat)

    def solve(b: torch.Tensor) -> torch.Tensor:
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]

    return solve


def _inverse_permutation(disc: Discretization, device) -> torch.Tensor:
    """global DoF -> position in the bucket-concatenated flat vector.

    Bucket gathers partition the DoF range, so per-bucket results assemble
    with one gather instead of a scatter per bucket.
    """
    inv = np.empty(disc.n_dofs, np.int64)
    off = 0
    for b in disc.buckets:
        g = np.asarray(b.gather).reshape(-1)
        inv[g] = off + np.arange(g.size, dtype=np.int64)
        off += g.size
    return torch.as_tensor(inv, device=device)


def _assemble_parts(parts, inv_perm: torch.Tensor) -> torch.Tensor:
    flat = torch.cat([p.reshape(-1) for p in parts])
    return flat[inv_perm]


def _dense_saddle(disc: Discretization, element_matrices, lagrange_mat, device):
    from mfv2d_torch.solver.iterative import assemble_dense_saddle

    mat, n_lag = assemble_dense_saddle(disc, element_matrices, lagrange_mat)
    return torch.as_tensor(mat, dtype=torch.float64, device=device), n_lag


def _sample_slots(nt: int, sample_rate: int) -> np.ndarray:
    """The sampled step indices: {0, s, 2s, ...} u {nt-1}, the host march's
    grid-sampling rule."""
    return np.asarray(
        sorted({i for i in range(nt) if i % sample_rate == 0} | {nt - 1}), np.int64
    )


class _SaddleOps:
    """Device operators of the saddle system ``[[A(u), G^T], [G, 0]]`` that
    every fused loop shares: the element residual, the constraint products
    and the per-form mass (dual) application for the march carry."""

    def __init__(self, disc: Discretization, evaluator, lagrange_mat) -> None:
        self.disc = disc
        self.evaluator = evaluator
        self.device = disc.buckets[0].batch.device
        self.n = disc.n_dofs
        self.n_lag = 0 if lagrange_mat is None else lagrange_mat.shape[0]
        self.gathers = [torch.as_tensor(b.gather, device=self.device) for b in disc.buckets]
        self.inv_perm = _inverse_permutation(disc, self.device)
        if lagrange_mat is not None:
            coo = lagrange_mat.tocoo()
            self.g_rows = torch.as_tensor(coo.row, dtype=torch.int64, device=self.device)
            self.g_cols = torch.as_tensor(coo.col, dtype=torch.int64, device=self.device)
            self.g_vals = torch.as_tensor(coo.data, dtype=torch.float64, device=self.device)

    def tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=torch.float64, device=self.device)

    def residual_value(self, u: torch.Tensor) -> torch.Tensor:
        parts = [self.evaluator.bucket_residual(i, u[g]) for i, g in enumerate(self.gathers)]
        return _assemble_parts(parts, self.inv_perm)

    def block_apply(self, blocks: list[torch.Tensor], u: torch.Tensor) -> torch.Tensor:
        parts = [torch.einsum("eij,ej->ei", b, u[g]) for b, g in zip(blocks, self.gathers)]
        return _assemble_parts(parts, self.inv_perm)

    def saddle_value(self, value: torch.Tensor, u, lam) -> torch.Tensor:
        """``[value + G^T lam, G u]``."""
        if self.n_lag == 0:
            return value
        value = value.index_add(0, self.g_cols, self.g_vals * lam[self.g_rows])
        trace = torch.zeros(self.n_lag, dtype=u.dtype, device=u.device).index_add_(
            0, self.g_rows, self.g_vals * u[self.g_cols]
        )
        return torch.cat([value, trace])

    def mass_blocks(self) -> list[torch.Tensor]:
        """Per-bucket block-diagonal mass matrices ``[E, N, N]`` (dual map)."""
        form_spec = self.disc.form_spec
        out = []
        for bucket in self.disc.buckets:
            p1, p2 = bucket.orders
            offsets = form_spec.form_offsets(p1, p2)
            n_e = form_spec.total_size(p1, p2)
            big = torch.zeros(
                (bucket.batch.n_elements, n_e, n_e), dtype=torch.float64, device=self.device
            )
            for i in range(len(form_spec)):
                big[:, offsets[i] : offsets[i + 1], offsets[i] : offsets[i + 1]] = (
                    bucket.batch.mass(form_spec[i][1], False)
                )
            out.append(big)
        return out


def _converged(mres: float, atol: float, rtol: float, max_mag: float) -> bool:
    return not (mres > atol and mres > max_mag * rtol)


class _TrapezoidalCarry:
    """The march state outside the solve: the dual of the marched forms at
    the last level (``old``) and the trapezoidal carry term."""

    def __init__(self, ops: _SaddleOps, explicit_vec, carry_indices, carry0, term0, dt):
        self.ops = ops
        self.idx = torch.as_tensor(np.asarray(carry_indices, np.int64), device=ops.device)
        self.explicit = ops.tensor(explicit_vec)
        self.old = ops.tensor(carry0)
        self.term = ops.tensor(term0)
        self.two_over_dt = 2.0 / dt
        self.masses = ops.mass_blocks()

    def base(self) -> torch.Tensor:
        base = self.explicit.clone()
        base[self.idx] += self.two_over_dt * self.old + self.term
        return base

    def advance(self, u: torch.Tensor) -> None:
        new = self.ops.block_apply(self.masses, u)[self.idx]
        self.term = self.two_over_dt * (new - self.old) - self.term
        self.old = new


def fused_linear_time_march(
    disc: Discretization,
    element_matrices: list[np.ndarray],
    lagrange_mat: sp.csr_array | None,
    explicit_vec: np.ndarray,
    carry_indices: np.ndarray,
    initial_solution: np.ndarray,
    initial_carry: np.ndarray,
    initial_carry_term: np.ndarray,
    dt: float,
    nt: int,
    sample_rate: int = 1,
):
    """The whole linear trapezoidal march on the device.

    One linear solve per step against the frozen dense LU, then the carry
    update 2/dt (dual_new - dual_old) - carry; only steps at the sample rate
    (and the final step) are kept.  Returns (sampled solutions
    [n_samples, n_dofs], sampled step indices, final lagrange multipliers).
    """
    ops = _SaddleOps(disc, None, lagrange_mat)
    mat, n_lag = _dense_saddle(disc, element_matrices, lagrange_mat, ops.device)
    lu_solve = _device_lu_solver(mat)
    del mat
    n = disc.n_dofs
    blocks = [ops.tensor(m) for m in element_matrices]
    carry = _TrapezoidalCarry(
        ops, explicit_vec, carry_indices, initial_carry, initial_carry_term, dt
    )
    sample_steps = _sample_slots(nt, sample_rate)
    u = ops.tensor(initial_solution)
    lam = torch.zeros(n_lag, dtype=torch.float64, device=ops.device)
    samples = []
    for step in range(nt):
        residual = carry.base() - ops.saddle_value(ops.block_apply(blocks, u), u, lam)
        d = lu_solve(residual)
        u = u + d[:n]
        lam = lam + d[n:]
        carry.advance(u)
        if step in sample_steps:
            samples.append(u)
    return torch.stack(samples).cpu().numpy(), sample_steps, lam.cpu().numpy()


def _anderson_init(m: int, n_tot: int, device):
    """Window buffers for Anderson extrapolation (None when m=0)."""
    if m <= 0:
        return None
    zeros = torch.zeros((m + 1, n_tot), dtype=torch.float64, device=device)
    return zeros, zeros.clone(), 0


def _anderson_step(x_k, f_k, bufs, m: int, grew: bool):
    """One guarded type-II Anderson step over the device window.

    Mirrors the host loop's policy (solver.solve.non_linear_solve_run):
    window restart when the residual grew, gamma-magnitude cap of 25, and
    the plain damped step until two pairs exist.  The small least-squares
    problem solves ridge-regularized normal equations over the pairs in the
    window.
    """
    xs, fs, count = bufs
    if grew:
        count = 0
    xs = torch.cat([xs[1:], x_k[None]])
    fs = torch.cat([fs[1:], f_k[None]])
    count = min(count + 1, m + 1)
    x_new = x_k + f_k
    if count >= 2:
        dx = (xs[1:] - xs[:-1])[m + 1 - count :]
        df = (fs[1:] - fs[:-1])[m + 1 - count :]
        gram = df @ df.T
        # Ridge scaled to the Gram diagonal keeps near-collinear
        # differences bounded.
        ridge = 1e-12 * max(float(gram.diagonal().max()), 1e-300)
        eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        gamma = torch.linalg.solve(gram + ridge * eye, df @ f_k)
        if float(gamma.abs().max()) <= 25.0:
            x_new = x_k + f_k - (dx + df).T @ gamma
    return x_new, (xs, fs, count)


def _picard_loop(ops: _SaddleOps, lu_solve, base, u, lam, max_iterations, relax,
                 atol, rtol, max_mag, anderson_m: int, residuals=None):
    """The Picard iteration of one solve; returns (u, lam, iterations, last
    residual norm)."""
    n = ops.n
    bufs = _anderson_init(anderson_m, n + ops.n_lag, ops.device)
    it, mres, prev = 0, float("inf"), float("inf")
    while it < max_iterations:
        res_vec = base - ops.saddle_value(ops.residual_value(u), u, lam)
        mres = float(res_vec.abs().max())
        if residuals is not None:
            residuals[it] = mres
        if _converged(mres, atol, rtol, max_mag):
            break
        d = lu_solve(res_vec)
        if bufs is not None:
            x_new, bufs = _anderson_step(
                torch.cat([u, lam]), relax * d, bufs, anderson_m, mres > prev
            )
            u, lam = x_new[:n], x_new[n:]
        else:
            u = u + relax * d[:n]
            lam = lam + relax * d[n:]
        prev = mres
        it += 1
    return u, lam, it, mres


def fused_picard_solve(
    disc: Discretization,
    evaluator,
    element_matrices: list[np.ndarray],
    lagrange_mat: sp.csr_array | None,
    explicit_vec: np.ndarray,
    solution0: np.ndarray,
    lagrange0: np.ndarray,
    max_iterations: int,
    relax: float,
    atol: float,
    rtol: float,
    max_mag: float,
    anderson_m: int = 0,
):
    """The steady Picard loop on the device with the frozen dense LU.

    Residual evaluation (including the nonlinear field reconstruction), the
    dense-LU solve and the update stay on the device; semantics match
    solver.solve.non_linear_solve_run, including the guarded type-II
    Anderson extrapolation when ``anderson_m > 0``.  Returns (solution,
    multipliers, iterations, residual norms [max_iterations], last norm).
    """
    ops = _SaddleOps(disc, evaluator, lagrange_mat)
    mat, _ = _dense_saddle(disc, element_matrices, lagrange_mat, ops.device)
    lu_solve = _device_lu_solver(mat)
    del mat
    residuals = np.zeros(max_iterations)
    u, lam, it, mres = _picard_loop(
        ops, lu_solve, ops.tensor(explicit_vec), ops.tensor(solution0),
        ops.tensor(lagrange0), max_iterations, relax, atol, rtol, max_mag,
        int(anderson_m), residuals,
    )
    return u.cpu().numpy(), lam.cpu().numpy(), it, residuals, mres


def fused_nonlinear_time_march(
    disc: Discretization,
    evaluator,
    element_matrices: list[np.ndarray],
    lagrange_mat: sp.csr_array | None,
    explicit_vec: np.ndarray,
    carry_indices: np.ndarray,
    initial_solution: np.ndarray,
    initial_carry: np.ndarray,
    initial_carry_term: np.ndarray,
    dt: float,
    nt: int,
    max_iterations: int,
    relax: float,
    atol: float,
    rtol: float,
    max_mag: float,
    sample_rate: int = 1,
    anderson_m: int = 0,
):
    """Nonlinear trapezoidal march on the device: per step the Picard loop
    with the frozen dense LU, then the carry update.  Returns (sampled
    solutions, sampled step indices, final multipliers, iterations [nt],
    last residual norms [nt])."""
    ops = _SaddleOps(disc, evaluator, lagrange_mat)
    mat, n_lag = _dense_saddle(disc, element_matrices, lagrange_mat, ops.device)
    lu_solve = _device_lu_solver(mat)
    del mat
    return _march(
        ops,
        lambda base, u, lam: _picard_loop(
            ops, lu_solve, base, u, lam, max_iterations, relax, atol, rtol,
            max_mag, int(anderson_m),
        ),
        explicit_vec, carry_indices, initial_solution, initial_carry,
        initial_carry_term, dt, nt, sample_rate,
    )


def _march(ops: _SaddleOps, solve_step, explicit_vec, carry_indices,
           initial_solution, initial_carry, initial_carry_term, dt, nt,
           sample_rate):
    carry = _TrapezoidalCarry(
        ops, explicit_vec, carry_indices, initial_carry, initial_carry_term, dt
    )
    sample_steps = _sample_slots(nt, sample_rate)
    u = ops.tensor(initial_solution)
    lam = torch.zeros(ops.n_lag, dtype=torch.float64, device=ops.device)
    iters = np.zeros(nt, np.uint32)
    last = np.zeros(nt)
    samples = []
    for step in range(nt):
        u, lam, iters[step], last[step] = solve_step(carry.base(), u, lam)
        carry.advance(u)
        if step in sample_steps:
            samples.append(u)
    return (
        torch.stack(samples).cpu().numpy(),
        sample_steps,
        lam.cpu().numpy(),
        iters,
        last,
    )


def _newton_machinery(disc: Discretization, evaluator, element_matrices, lagrange_mat):
    """The pieces the fused Newton loops share: the saddle operators, the
    LU of the frozen operator, and the dense exact-Jacobian saddle solve."""
    ops = _SaddleOps(disc, evaluator, lagrange_mat)
    mat0, _ = _dense_saddle(disc, element_matrices, lagrange_mat, ops.device)
    frozen_solve = _device_lu_solver(mat0)
    # The constant frame: G and G^T in place, the element blocks zeroed.
    frame = mat0
    for g in ops.gathers:
        frame[g[:, :, None], g[:, None, :]] = 0.0

    def jacobian_solve(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        mat = frame.clone()
        for i, g in enumerate(ops.gathers):
            mat[g[:, :, None], g[:, None, :]] = evaluator.bucket_jacobians(i, u[g])
        return _device_lu_solver(mat)(b)

    return ops, frozen_solve, jacobian_solve


def _newton_loop(ops: _SaddleOps, frozen_solve, jacobian_solve, base, u, lam,
                 max_iterations, relax, atol, rtol, max_mag, residuals=None):
    """Exact Newton for one solve: the first iteration solves with the frozen
    operator, every later one with the Jacobian at the iterate."""
    n = ops.n
    it, mres = 0, float("inf")
    while it < max_iterations:
        res_vec = base - ops.saddle_value(ops.residual_value(u), u, lam)
        mres = float(res_vec.abs().max())
        if residuals is not None:
            residuals[it] = mres
        if _converged(mres, atol, rtol, max_mag):
            break
        d = frozen_solve(res_vec) if it == 0 else jacobian_solve(u, res_vec)
        u = u + relax * d[:n]
        lam = lam + relax * d[n:]
        it += 1
    return u, lam, it, mres


def fused_newton_solve(
    disc: Discretization,
    evaluator,
    element_matrices: list[np.ndarray],
    lagrange_mat: sp.csr_array | None,
    explicit_vec: np.ndarray,
    solution0: np.ndarray,
    lagrange0: np.ndarray,
    max_iterations: int,
    relax: float,
    atol: float,
    rtol: float,
    max_mag: float,
):
    """Steady exact-Newton loop on the device.

    Semantics match solver.solve.non_linear_solve_run(newton=True): the
    first iteration uses the assembled (frozen) operator, later ones factor
    the dense saddle matrix of the exact element Jacobians at the iterate.
    """
    ops, frozen_solve, jacobian_solve = _newton_machinery(
        disc, evaluator, element_matrices, lagrange_mat
    )
    residuals = np.zeros(max_iterations)
    u, lam, it, mres = _newton_loop(
        ops, frozen_solve, jacobian_solve, ops.tensor(explicit_vec),
        ops.tensor(solution0), ops.tensor(lagrange0), max_iterations, relax,
        atol, rtol, max_mag, residuals,
    )
    return u.cpu().numpy(), lam.cpu().numpy(), it, residuals, mres


def fused_newton_time_march(
    disc: Discretization,
    evaluator,
    element_matrices: list[np.ndarray],
    lagrange_mat: sp.csr_array | None,
    explicit_vec: np.ndarray,
    carry_indices: np.ndarray,
    initial_solution: np.ndarray,
    initial_carry: np.ndarray,
    initial_carry_term: np.ndarray,
    dt: float,
    nt: int,
    max_iterations: int,
    relax: float,
    atol: float,
    rtol: float,
    max_mag: float,
    sample_rate: int = 1,
):
    """Exact-Newton trapezoidal march on the device (the first iteration of
    each step uses the frozen operator, as the host loop does)."""
    ops, frozen_solve, jacobian_solve = _newton_machinery(
        disc, evaluator, element_matrices, lagrange_mat
    )
    return _march(
        ops,
        lambda base, u, lam: _newton_loop(
            ops, frozen_solve, jacobian_solve, base, u, lam, max_iterations,
            relax, atol, rtol, max_mag,
        ),
        explicit_vec, carry_indices, initial_solution, initial_carry,
        initial_carry_term, dt, nt, sample_rate,
    )
