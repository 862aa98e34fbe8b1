"""Krylov loops of the trace solvers: CG, restarted GMRES and the curvature probe.

The f64 subset of the JAX package's ``mfv2d_tpu/solver/krylov.py``, as plain
host-driven loops over a ``matvec`` callable on torch tensors:

- CG from a zero start that keeps its best (least-residual) iterate: on the
  indefinite trace operators of saddle formulations the CG recurrence is
  only semiconvergent.
- GMRES(m) with classical Gram-Schmidt and one reorthogonalization (CGS2):
  two matrix-vector products against the stored basis an iteration, on the
  basis's device.  The Givens rotations of the small Hessenberg column run
  on the host as a log-depth scan (:func:`apply_rotations`).
- ``spd_probe``: the sign mix of the curvatures of a short CG run, which
  routes an indefinite trace operator from CG to GMRES with an
  un-truncated space (``auto_restart``).

Every stop decision reads values that are the same on every rank of a
sharded solve (the trace vector is replicated and its dots are local), so
the ranks leave each loop together; the loops themselves communicate only
through ``matvec``.

Not ported, as they serve only the TPU's f32 inner ladder: the chunked
``cg_chunk`` (watchdog chunking), ``mixed_outer_drive``, the recycle state
(``empty_recycle_state``, ``krylov_project``, ``gmres_loop_recycled``) and
the chunked allocation of the basis.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

# Rows of the JAX package's basis allocation; ``auto_restart`` aligns the
# restart length to it so that both packages take the same Krylov space.
_CGS_CHUNK = 256


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def cg_loop(
    matvec: Callable, b: torch.Tensor, tol: float, max_iter: int
) -> tuple[torch.Tensor, float, int]:
    """CG from a zero start; stops at ``|r| <= tol`` or after ``max_iter``.

    Returns ``(x_best, |r_best|^2, iterations)``.  A zero-curvature step
    (``p'Ap`` of 1e-300 or less) ends the loop with the best iterate.
    """
    rs = _dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    x_best, rs_best = x, rs
    k = 0
    while k < max_iter and rs > tol * tol:
        ap = matvec(p)
        pap = _dot(p, ap)
        k += 1
        if abs(pap) <= 1e-300:
            break
        alpha = rs / pap
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        if rs < rs_best:
            x_best, rs_best = x, rs
    return x_best, rs_best, k


def spd_probe(matvec: Callable, rhs: torch.Tensor, iters: int = 32) -> float:
    """Signed-curvature mixing ratio of ``A`` over a short CG run.

    Tracks the extreme Rayleigh quotients ``p'Ap / p'p`` of the CG search
    directions and returns ``min_c max_c / max(|min_c|, |max_c|)^2``: about
    +1 where all curvatures share a sign (a definite operator; the mixed
    Poisson trace Schur complement is negative definite), clearly negative
    where both signs appear (indefinite).  The run stops once the residual
    has contracted by 1e4 (1e-8 in the square), or both signs are seen.
    """

    def scale_of(lo: float, hi: float) -> float:
        return max(abs(lo), abs(hi), 1e-30)

    r = rhs.clone()
    p = rhs.clone()
    rs0 = rs = _dot(rhs, rhs)
    min_c, max_c = np.inf, -np.inf
    for _ in range(iters):
        s = scale_of(min_c, max_c)
        if not rs > 1e-8 * rs0 or (min_c < -1e-3 * s and max_c > 1e-3 * s):
            break
        ap = matvec(p)
        pap = _dot(p, ap)
        curv = pap / max(_dot(p, p), 1e-30)
        min_c, max_c = min(min_c, curv), max(max_c, curv)
        alpha = rs / (pap if pap != 0 else 1.0)
        r = r - alpha * ap
        rs_new = _dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    s = scale_of(min_c, max_c)
    return min_c * max_c / (s * s)


def trace_indefinite_probe(matvec: Callable, n_lagrange: int, device) -> bool:
    """Whether the trace operator ``matvec`` mixes curvature signs.

    The JAX package's routing policy (the seed, the probe length and the
    -1e-4 threshold), probed here in f64: an indefinite trace operator goes
    to GMRES.
    """
    if n_lagrange == 0:
        return False
    rhs = torch.as_tensor(
        np.random.default_rng(0).normal(size=n_lagrange), dtype=torch.float64, device=device
    )
    return spd_probe(matvec, rhs) <= -1e-4


def apply_rotations(cs: np.ndarray, sn: np.ndarray, hcol: np.ndarray, j: int) -> np.ndarray:
    """Apply the stored Givens rotations ``0..j-1`` to a Hessenberg column.

    The sequential sweep

        out_i   = cs_i t_i + sn_i h_{i+1}        (final row i, i < j)
        t_{i+1} = -sn_i t_i + cs_i h_{i+1},      t_0 = h_0

    reads each ``h_{i+1}`` unrotated, so its carry obeys a first-order
    affine recurrence.  As in the JAX package, the recurrence runs as a
    log-depth scan over the affine maps ``t -> a t + b`` (here NumPy
    vector steps), which keeps the host's part of a GMRES iteration short
    at restarts of thousands.  Returns the rotated column: ``out_i`` for
    i < j, the carry ``t_j`` at row j, and the entries above unchanged.
    """
    h = np.array(hcol, np.float64)
    if j == 0:
        return h
    a = -np.asarray(sn[:j], np.float64)
    b = np.asarray(cs[:j], np.float64) * h[1 : j + 1]
    shift = 1
    while shift < j:
        # Compose each map with the one ``shift`` before it (Hillis-Steele).
        a_prev, b_prev = a[:-shift], b[:-shift]
        b = np.concatenate((b[:shift], a[shift:] * b_prev + b[shift:]))
        a = np.concatenate((a[:shift], a[shift:] * a_prev))
        shift *= 2
    t = np.concatenate(([h[0]], a * h[0] + b))  # t_0 .. t_j
    h[:j] = cs[:j] * t[:j] + sn[:j] * h[1 : j + 1]
    h[j] = t[j]
    return h


def gmres_cycle(
    matvec: Callable, b: torch.Tensor, tol: float, x0: torch.Tensor, m: int
) -> tuple[torch.Tensor, float, int]:
    """One GMRES(m) cycle from ``x0``: Arnoldi with CGS2, Givens, update.

    Stops early once the rotated residual estimate is at most ``tol``.
    Returns ``(x_new, |r|_estimate, iterations)``.
    """
    n = b.shape[0]
    r0 = b - matvec(x0)
    beta = float(torch.linalg.vector_norm(r0))
    basis = b.new_zeros((m + 1, n))
    basis[0] = r0 / (beta if beta > 0 else 1.0)
    # The rotated Hessenberg, a column a row, so a step writes contiguously.
    r_cols = np.zeros((m, m + 1))
    cs = np.zeros(m)
    sn = np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta
    j = 0
    while j < m and abs(g[j]) > tol:
        w = matvec(basis[j])
        active = basis[: j + 1]
        h1 = active @ w
        w = w - h1 @ active
        h2 = active @ w
        w = w - h2 @ active
        h_next = torch.linalg.vector_norm(w)
        basis[j + 1] = w / torch.where(h_next > 0, h_next, 1.0)
        # The new Hessenberg column reaches the host in one copy.
        hcol = apply_rotations(cs, sn, torch.cat((h1 + h2, h_next[None])).cpu().numpy(), j)
        denom = float(np.hypot(hcol[j], hcol[j + 1]))
        c_new = hcol[j] / denom if denom > 0 else 1.0
        s_new = hcol[j + 1] / denom if denom > 0 else 0.0
        hcol[j] = c_new * hcol[j] + s_new * hcol[j + 1]
        hcol[j + 1] = 0.0
        g[j + 1] = -s_new * g[j]
        g[j] = c_new * g[j]
        r_cols[j, : j + 2] = hcol
        cs[j], sn[j] = c_new, s_new
        j += 1
    if j == 0:
        return x0, abs(g[0]), 0
    y = _solve_upper(r_cols[:j, :j].T, g[:j])
    coeffs = torch.as_tensor(y, dtype=b.dtype, device=b.device)
    return x0 + coeffs @ basis[:j], abs(g[j]), j


def _solve_upper(r: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Back substitution on an upper-triangular ``r`` (a zero pivot gives 0)."""
    y = np.zeros_like(rhs)
    for i in reversed(range(rhs.size)):
        acc = rhs[i] - r[i, i + 1 :] @ y[i + 1 :]
        y[i] = acc / r[i, i] if r[i, i] != 0 else 0.0
    return y


def gmres_loop(
    matvec: Callable, b: torch.Tensor, tol: float, max_iter: int, m: int
) -> tuple[torch.Tensor, float, int]:
    """Restarted GMRES(m) from a zero start; stops at ``|r| <= tol``.

    Returns ``(x, |r|^2, iterations)``, the residual the last cycle's
    rotated estimate; a cycle counts at least one iteration.
    """
    x = torch.zeros_like(b)
    res = float(torch.linalg.vector_norm(b))
    total = 0
    while total < max_iter and res > tol:
        x, res, j = gmres_cycle(matvec, b, tol, x, m)
        total += max(j, 1)
    return x, res * res, total


def auto_restart(
    n: int,
    maximum_iterations: int,
    *,
    dtype_bytes: int = 4,
    budget_bytes: int = 384 * 2**20,
    cap: int = 4096,
) -> int:
    """Restart length for an (effectively) un-truncated Krylov space.

    The largest m whose ``[m + 1, n]`` basis, in rows of ``_CGS_CHUNK``,
    fits the byte budget, bounded by the iteration cap, the problem size
    and a hard cap on the Hessenberg work; at least one chunk of rows.  The
    JAX package's rule, so both packages restart alike.
    """
    rows_budget = budget_bytes // (dtype_bytes * max(n, 1))
    by_memory = max(_CGS_CHUNK, (rows_budget // _CGS_CHUNK) * _CGS_CHUNK) - 1
    by_memory = max(64, by_memory)
    return max(1, min(n, maximum_iterations, cap, by_memory))
