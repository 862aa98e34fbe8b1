"""The port's Krylov loops against the JAX package's ``solver/krylov.py``.

Seeded matrices go through both packages' CG, GMRES, curvature probe and
restart rule; the probe routes the Stokes trace system to GMRES and the
mixed Poisson one to CG in both.  JAX runs on the CPU in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.solver import krylov as tk
from mfv2d_tpu.solver import krylov as jk

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _matrix(kind: str, n: int = 120, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "spd":
        q = rng.normal(size=(n, n))
        return q @ q.T / n + np.eye(n)
    a = rng.normal(size=(n, n)) + 6 * np.eye(n)
    if kind == "indefinite":
        a = 0.5 * (a + a.T)
        a[: n // 3] *= -1.0
        a = 0.5 * (a + a.T)
    return a


def test_rotation_sweep_matches_jax():
    rng = np.random.default_rng(0)
    for m, j in [(8, 0), (8, 1), (8, 5), (8, 8), (33, 17), (64, 63)]:
        th = rng.uniform(0, 2 * np.pi, m)
        cs, sn = np.cos(th), np.sin(th)
        h = rng.normal(size=m + 1)
        ref = np.asarray(jk._apply_rotations(jnp.asarray(cs), jnp.asarray(sn), jnp.asarray(h), j))
        assert np.abs(tk.apply_rotations(cs, sn, h, j) - ref).max() <= 1e-13


@pytest.mark.parametrize("max_iter", [7, 400])
def test_cg_loop_matches_jax(max_iter):
    """The best iterate, its residual and the iteration count, capped and
    converged."""
    a = _matrix("spd")
    b = np.random.default_rng(1).normal(size=a.shape[0])
    tol = 1e-10 * np.linalg.norm(b)
    x, rs, k = tk.cg_loop(lambda v: _t(a) @ v, _t(b), tol, max_iter)
    aj = jnp.asarray(a)
    xj, rsj, kj = jk.cg_loop(lambda v: aj @ v, jnp.asarray(b), tol, max_iter)
    assert k == int(kj)
    assert abs(rs - float(rsj)) <= 1e-10 * float(rsj) + 1e-30
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()
    if max_iter > 100:
        assert np.linalg.norm(b - a @ x.numpy()) <= 2 * tol


def test_cg_loop_zero_curvature_keeps_best():
    """A zero-curvature direction ends CG with the best iterate, as in JAX."""
    a = np.diag([1.0, -1.0, 2.0])
    b = np.array([1.0, 1.0, 0.0])
    x, rs, k = tk.cg_loop(lambda v: _t(a) @ v, _t(b), 1e-12, 10)
    xj, rsj, kj = jk.cg_loop(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), 1e-12, 10)
    assert k == int(kj) == 1
    assert np.array_equal(x.numpy(), np.asarray(xj)) and rs == float(rsj)


@pytest.mark.parametrize("kind", ["nonsymmetric", "indefinite"])
@pytest.mark.parametrize("restart", [20, 130])
def test_gmres_loop_matches_jax(kind, restart):
    """CGS2 GMRES, restarted and un-truncated, against the JAX package's."""
    a = _matrix(kind)
    b = np.random.default_rng(4).normal(size=a.shape[0])
    tol = 1e-11 * np.linalg.norm(b)
    x, rr, it = tk.gmres_loop(lambda v: _t(a) @ v, _t(b), tol, 600, restart)
    aj = jnp.asarray(a)
    xj, rrj, itj = jk.gmres_loop(lambda v: aj @ v, jnp.asarray(b), tol, 600, restart)
    assert it == int(itj)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-9 * np.abs(np.asarray(xj)).max()
    # GMRES(20) stalls on the indefinite matrix in both packages: the
    # estimates then agree relative to the stalled residual.
    assert abs(np.sqrt(rr) - np.sqrt(float(rrj))) <= 1e-9 * np.sqrt(float(rrj)) + 1e-3 * tol
    if restart > 100:
        assert np.linalg.norm(b - a @ x.numpy()) / np.linalg.norm(b) < 1e-10


def test_gmres_cycle_matches_jax_from_a_start():
    a = _matrix("nonsymmetric", n=60)
    rng = np.random.default_rng(6)
    b, x0 = rng.normal(size=60), rng.normal(size=60)
    x, res, j = tk.gmres_cycle(lambda v: _t(a) @ v, _t(b), 1e-30, _t(x0), 25)
    aj = jnp.asarray(a)
    xj, resj, jj = jk.gmres_cycle(lambda v: aj @ v, jnp.asarray(b), 1e-30, jnp.asarray(x0), 25)
    assert j == int(jj) == 25
    assert abs(res - float(resj)) <= 1e-9 * float(resj)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()


@pytest.mark.parametrize("kind", ["spd", "negative", "indefinite"])
def test_spd_probe_matches_jax(kind):
    a = _matrix("spd", n=80, seed=1)
    if kind == "negative":
        a = -a
    elif kind == "indefinite":
        a[:4, :4] *= -1.0
        a = 0.5 * (a + a.T)
    rhs = np.random.default_rng(1).normal(size=80)
    ratio = tk.spd_probe(lambda v: _t(a) @ v, _t(rhs))
    ref = float(jk.spd_probe(lambda v: jnp.asarray(a) @ v, jnp.asarray(rhs)))
    assert abs(ratio - ref) <= 1e-10
    assert (ratio <= -1e-4) == (kind == "indefinite")


def test_auto_restart_matches_jax():
    cases = [(100, 10_000), (100_000, 50), (5_000, 10_000), (100_000, 10_000),
             (4_000_000, 10_000), (64_512, 3_665_920), (1, 5)]
    for n, max_iter in cases:
        for dtype_bytes in (4, 8):
            assert tk.auto_restart(n, max_iter, dtype_bytes=dtype_bytes) == jk.auto_restart(
                n, max_iter, dtype_bytes=dtype_bytes
            ), (n, max_iter, dtype_bytes)


def _trace_system(mf, system, nh, p):
    """The port's or the JAX package's BlockSaddleSystem of a trace system."""
    from importlib import import_module

    pkg = mf.__name__
    compiled = import_module(f"{pkg}.compiler").CompiledSystem(system)
    discretize = import_module(f"{pkg}.solver.discretization").discretize_mesh
    FemCache = import_module(f"{pkg}.ops.basis").FemCache
    solve = import_module(f"{pkg}.solver.solve")
    kw = {"device": "cpu"} if mf is tf else {}
    disc = discretize(mf.examples.unit_square_mesh(nh, nh, p), system.unknown_forms,
                      FemCache(2), **kw)
    forcing = solve.compute_forcing_vector(disc, system)
    views = [forcing[disc.element_offsets[i] : disc.element_offsets[i + 1]]
             for i in range(disc.n_leaves)]
    lag, _ = import_module(f"{pkg}.continuity").add_system_constraints(
        system, disc.mesh, disc.basis_cache, [], [], disc.leaf_indices,
        disc.element_offsets, views,
    )
    evaluator = solve.SystemEvaluator(system.unknown_forms, compiled, disc)
    mats = [np.asarray(m) for m in evaluator.element_matrices(compiled.linear_blocks)]
    return import_module(f"{pkg}.solver.iterative").BlockSaddleSystem(disc, mats, lag)


def _poisson(mf):
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    return mf.KFormSystem(q.weight.derivative @ u - q.weight @ q == 0, u.weight @ q.derivative == 0)


@pytest.mark.parametrize("case", ["stokes", "poisson"])
def test_trace_probe_routes_like_jax(case):
    """The probe flags the Stokes trace system (4x4, p=3) indefinite and
    the mixed Poisson one (3x3, p=3) definite, as the JAX package does."""
    from importlib import import_module

    def system_of(mf):
        if case == "stokes":
            return import_module(f"{mf.__name__}.models.flow").stokes_flow().system
        return _poisson(mf)

    n = 4 if case == "stokes" else 3
    mine = _trace_system(tf, system_of(tf), n, 3)
    ref = _trace_system(jf, system_of(jf), n, 3)
    indefinite = tk.trace_indefinite_probe(mine.apply_schur, mine.n_lagrange, "cpu")
    assert indefinite == ref.trace_indefinite() == (case == "stokes")
    # The operators themselves agree.
    lam = np.random.default_rng(2).normal(size=mine.n_lagrange)
    got = mine.apply_schur(_t(lam)).numpy()
    want = np.asarray(ref.apply_schur(jnp.asarray(lam)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert tk.trace_indefinite_probe(mine.apply_schur, 0, "cpu") is False
