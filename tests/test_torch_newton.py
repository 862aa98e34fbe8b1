"""Exact-Jacobian Newton in the port against the JAX package.

The element Jacobians come from forward-mode differentiation over a whole
bucket in the port and from ``vmap(jacfwd)`` over single elements in the JAX
package; they must agree to 1e-12 relative.  Newton solves through the host
loop ("direct", "schur_direct", "dense", the Schur CG) agree to 1e-10 with
equal iteration histories.
"""

import importlib

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf

torch.set_num_threads(1)

jsolve_mod = importlib.import_module("mfv2d_tpu.solve_system_2d")
tsolve_mod = importlib.import_module("mfv2d_torch.solve_system_2d")


def rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / max(np.abs(ref).max(), 1e-300))


def _models(mf, name):
    return importlib.import_module(f"{mf.__name__}.models.{name}")


NU = -1.0


def _nl_u(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def _nl_q(x, y):
    return np.stack(
        (
            -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def _nl_source(x, y):
    return np.sum(_nl_q(x, y) ** 2, axis=-1) - NU * np.pi**2 * _nl_u(x, y) / 2


def _navier_stokes_system(mf):
    return _models(mf, "flow").navier_stokes(10.0).system


def _nonlinear_flow_system(mf):
    return _models(mf, "transport").nonlinear_flow(NU, _nl_u, _nl_source).system


def _evaluator(mf, system, n=3, p=3):
    compiler = importlib.import_module(f"{mf.__name__}.compiler")
    basis = importlib.import_module(f"{mf.__name__}.ops.basis")
    discretization = importlib.import_module(f"{mf.__name__}.solver.discretization")
    solve = importlib.import_module(f"{mf.__name__}.solver.solve")
    mesh = mf.examples.unit_square_mesh(n, n, p)
    on_cpu = {"device": "cpu"} if mf is tf else {}
    disc = discretization.discretize_mesh(
        mesh, system.unknown_forms, basis.FemCache(3), **on_cpu
    )
    return solve.SystemEvaluator(disc.form_spec, compiler.CompiledSystem(system), disc)


@pytest.mark.parametrize(
    "make", [_navier_stokes_system, _nonlinear_flow_system], ids=["navier_stokes", "nonlinear_flow"]
)
def test_element_jacobians_match_jax(make):
    jev = _evaluator(jf, make(jf))
    tev = _evaluator(tf, make(tf))
    u = np.random.default_rng(7).normal(size=jev.disc.n_dofs)
    jac_j = jev.element_jacobians(u)
    jac_t = tev.element_jacobians(u)
    assert len(jac_t) == len(jac_j)
    for mine, ref in zip(jac_t, jac_j):
        assert mine.shape == ref.shape
        assert rel(mine, ref) <= 1e-12


def test_jacobian_reads_the_mass_memo(monkeypatch):
    """The kernels run once, on plain tensors, before the transform; a
    Jacobian after that adds no mass computation."""
    from mfv2d_torch import evaluation

    calls = []
    mass_edge = evaluation.mass_edge_kernel.mass_edge

    def counting(tb, jac):
        assert not torch._C._functorch.is_functorch_wrapped_tensor(jac.det)
        calls.append(1)
        return mass_edge(tb, jac)

    monkeypatch.setattr(evaluation.mass_edge_kernel, "mass_edge", counting)
    tev = _evaluator(tf, _navier_stokes_system(tf))
    u = np.random.default_rng(3).normal(size=tev.disc.n_dofs)
    first = tev.element_jacobians(u)
    warm = len(calls)
    second = tev.element_jacobians(u)
    assert warm >= 1 and len(calls) == warm
    for a, b in zip(first, second):
        assert np.array_equal(a, b)


def _capture(mf, module, monkeypatch, make, linear_solver):
    captured = []
    original = module.reconstruct_mesh_from_solution

    def capture(disc, recon_order, solution, *args):
        captured.append(np.array(solution))
        return original(disc, recon_order, solution, *args)

    with monkeypatch.context() as m:
        m.setattr(module, "reconstruct_mesh_from_solution", capture)
        mesh, settings, solver = make(mf, linear_solver)
        on_cpu = {"device": "cpu"} if mf is tf else {}
        grids, stats, _ = mf.solve_system_2d(mesh, settings, solver, recon_order=6, **on_cpu)
    return captured, grids, stats


def _newton_high_re(mf, linear_solver):
    """The setup of the JAX package's test_newton_navier_stokes_high_re."""
    flow = _models(mf, "flow")
    model = flow.navier_stokes(50.0)
    mesh = mf.examples.unit_square_mesh(4, 4, 4)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    return (
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(10, 1e-11, 0),
            method="newton",
            linear_solver=linear_solver,
        ),
    )


def _nonlinear_flow_picard(mf, linear_solver):
    model = _models(mf, "transport").nonlinear_flow(NU, _nl_u, _nl_source)
    return (
        mf.examples.unit_square_mesh(4, 4, 3),
        mf.SystemSettings(model.system),
        mf.SolverSettings(
            mf.ConvergenceSettings(40, 1e-10, 0), linear_solver=linear_solver
        ),
    )


def _nonlinear_flow_newton(mf, linear_solver):
    """Newton through a trace solver: the frozen operator of the nonlinear
    flow is symmetric, so the Schur CG preconditions the Newton steps."""
    model = _models(mf, "transport").nonlinear_flow(NU, _nl_u, _nl_source)
    return (
        mf.examples.unit_square_mesh(3, 3, 3),
        mf.SystemSettings(model.system),
        mf.SolverSettings(
            mf.ConvergenceSettings(20, 1e-10, 0), linear_solver=linear_solver,
            method="newton",
        ),
    )


@pytest.mark.parametrize(
    "make, linear_solver",
    [
        (_newton_high_re, "direct"),
        (_newton_high_re, "schur_direct"),
        (_newton_high_re, "dense"),
        (_nonlinear_flow_picard, "direct"),
        (_nonlinear_flow_newton, "schur"),
    ],
    ids=[
        "newton_direct",
        "newton_schur_direct",
        "newton_dense",
        "nonlinear_flow_picard",
        "nonlinear_flow_newton_schur",
    ],
)
def test_solve_matches_jax(make, linear_solver, monkeypatch):
    jsol, jgrids, jstats = _capture(jf, jsolve_mod, monkeypatch, make, linear_solver)
    tsol, tgrids, tstats = _capture(tf, tsolve_mod, monkeypatch, make, linear_solver)
    assert len(tsol) == len(jsol) == len(tgrids) == len(jgrids) == 2
    for mine, ref in zip(tsol, jsol):
        assert rel(mine, ref) <= 1e-10
    assert np.array_equal(tstats.iter_history, jstats.iter_history)
    assert np.allclose(tstats.residual_history, jstats.residual_history, rtol=1e-6, atol=1e-13)
    for name, ref in jgrids[-1].point_data.items():
        assert rel(tgrids[-1].point_data[name], ref) <= 1e-10, name
    if make is _newton_high_re:
        assert int(tstats.iter_history[-1]) <= 4  # quadratic convergence
    elif make is _nonlinear_flow_newton:
        assert int(tstats.iter_history[-1]) <= 6
    else:
        grid = tgrids[-1]
        x, y = grid.points[:, 0], grid.points[:, 1]
        assert float(np.sqrt(np.mean((grid.point_data["u"] - _nl_u(x, y)) ** 2))) < 5e-3
