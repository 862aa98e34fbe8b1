"""The steady direct Picard slice of the port against the JAX package.

Both packages run the same problem through their public ``solve_system_2d``;
the final DoF vector each one reconstructs is captured and must agree to
1e-10 relative (BASELINE.md's parity target), with equal iteration counts.
"""

import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.models import flow as tflow
from mfv2d_torch.models import poisson as tpoisson
from mfv2d_tpu.models import flow as jflow
from mfv2d_tpu.models import poisson as jpoisson

torch.set_num_threads(1)

# The packages bind the name ``solve_system_2d`` to the function, which
# shadows the submodule for ``import ... as``.
jsolve_mod = importlib.import_module("mfv2d_tpu.solve_system_2d")
tsolve_mod = importlib.import_module("mfv2d_torch.solve_system_2d")

FIX = np.load(Path(__file__).parent / "golden" / "reference_fixtures.npz")


def rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / np.abs(ref).max())


def _golden_system(mf):
    def u_exact(x, y):
        return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def source_exact(x, y):
        return -(np.pi**2) / 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    pw = q.weight
    return mf.KFormSystem(
        pw.derivative @ u - pw @ q == pw ^ u_exact,
        v @ q.derivative == -(v @ source_exact),
    )


def test_full_solution_matches_golden_fixture():
    """4x4 p=3 mixed Poisson through the port's pipeline stages, against the
    solution assembled from independent masses and a SciPy saddle solve."""
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import (
        FrozenSaddleSolver,
        SystemEvaluator,
        compute_linear_system,
        non_linear_solve_run,
    )

    system = _golden_system(tf)
    mesh = tf.examples.unit_square_mesh(4, 4, 3)
    disc = discretize_mesh(mesh, system.unknown_forms, FemCache(2), device="cpu")
    evaluator = SystemEvaluator(disc.form_spec, CompiledSystem(system), disc)
    forcing, matrices, lagrange_mat, lagrange_vec = compute_linear_system(
        disc, system, evaluator, [], [], None
    )
    solver = FrozenSaddleSolver(evaluator.matrices_per_leaf(matrices), lagrange_mat)
    explicit_vec = np.concatenate((forcing, lagrange_vec))
    solution, _, _, _, _ = non_linear_solve_run(
        20, 1.0, 1e-12, 0.0, False, evaluator, explicit_vec,
        np.zeros(disc.n_dofs), np.zeros(lagrange_mat.shape[0]),
        float(np.abs(explicit_vec).max()), solver, lagrange_mat,
    )
    assert rel(solution, FIX["solution_mixed_poisson_4x4_p3"]) <= 1e-10


def _mixed_poisson(mf, poisson, n=4, p=3):
    model = poisson.mixed_poisson()
    return (
        mf.examples.unit_square_mesh(n, n, p),
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-12, 0.0)),
    )


def _mixed_poisson_p9(mf, poisson):
    """Above p=8 the 1-form mass matrices no longer fit a whole-table kernel
    layout (over-integration 3); the port must take these orders as the JAX
    package does."""
    return _mixed_poisson(mf, poisson, n=2, p=9)


def _mixed_poisson_p10(mf, poisson):
    return _mixed_poisson(mf, poisson, n=2, p=10)


def _direct_poisson(mf, poisson):
    model = poisson.direct_poisson()
    mesh = mf.examples.unit_square_mesh(3, 3, 4)
    bc = mf.BoundaryCondition2DSteady(model.u, mesh.boundary_indices, poisson.u_exact)
    return (
        mesh,
        mf.SystemSettings(model.system, boundary_conditions=[bc]),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0.0)),
    )


def _navier_stokes(mf, flow, **solver_kw):
    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(4, 4, 5)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    return mesh, model, bc, mf.SolverSettings(
        mf.ConvergenceSettings(80, 1e-8, 0.0), relaxation=0.7, **solver_kw
    )


def _ns_plain(mf, flow):
    mesh, model, bc, solver = _navier_stokes(mf, flow)
    return mesh, mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]), solver


def _ns_anderson_initial(mf, flow):
    mesh, model, bc, solver = _navier_stokes(mf, flow, anderson_m=3)

    def vel0(x, y):
        return 0.5 * flow.ns_velocity_exact(x, y)

    settings = mf.SystemSettings(
        model.system, [bc], [(0.0, model.pressure)], {model.velocity: vel0}
    )
    return mesh, settings, solver


CASES = {
    "mixed_poisson": (_mixed_poisson, (jpoisson, tpoisson)),
    "mixed_poisson_p9": (_mixed_poisson_p9, (jpoisson, tpoisson)),
    "mixed_poisson_p10": (_mixed_poisson_p10, (jpoisson, tpoisson)),
    "direct_poisson_strong_bc": (_direct_poisson, (jpoisson, tpoisson)),
    "navier_stokes": (_ns_plain, (jflow, tflow)),
    "navier_stokes_anderson_ic": (_ns_anderson_initial, (jflow, tflow)),
}


def _solve_capturing(mf, module, monkeypatch, make, model_mod):
    captured = []
    original = module.reconstruct_mesh_from_solution

    def capture(disc, recon_order, solution, *args):
        captured.append(np.array(solution))
        return original(disc, recon_order, solution, *args)

    monkeypatch.setattr(module, "reconstruct_mesh_from_solution", capture)
    mesh, settings, solver = make(mf, model_mod)
    on_cpu = {"device": "cpu"} if mf is tf else {}
    grids, stats, _ = mf.solve_system_2d(mesh, settings, solver, recon_order=6, **on_cpu)
    return captured[-1], grids, stats


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_system_2d_matches_jax(case, monkeypatch):
    make, (jmodel, tmodel) = CASES[case]
    jsol, jgrids, jstats = _solve_capturing(jf, jsolve_mod, monkeypatch, make, jmodel)
    tsol, tgrids, tstats = _solve_capturing(tf, tsolve_mod, monkeypatch, make, tmodel)
    assert rel(tsol, jsol) <= 1e-10
    assert np.array_equal(tstats.iter_history, jstats.iter_history)
    if "anderson" not in case:
        # Anderson's least-squares step is ill-conditioned near convergence
        # and amplifies round-off in the intermediate residuals (measured
        # 4e-5 relative at iteration 5); its end point is held above.
        assert np.allclose(
            tstats.residual_history, jstats.residual_history, rtol=1e-6, atol=1e-13
        )
    for field in ("n_total_dofs", "n_leaf_dofs", "n_lagrange", "n_elems", "n_leaves"):
        assert getattr(tstats, field) == getattr(jstats, field)
    assert tstats.element_orders == jstats.element_orders
    assert len(tgrids) == len(jgrids)
    for name, ref in jgrids[-1].point_data.items():
        assert rel(tgrids[-1].point_data[name], ref) <= 1e-10, name
    assert np.array_equal(tgrids[-1].points, jgrids[-1].points)
    assert np.array_equal(tgrids[-1].cells, jgrids[-1].cells)


def _stokes(p, linear_solver):
    """examples/steady/stokes_flow.py: the VVP Stokes system (BASELINE
    config 3) on 4x4 at order p."""

    def make(mf, flow):
        model = flow.stokes_flow()
        return (
            mf.examples.unit_square_mesh(4, 4, p),
            mf.SystemSettings(model.system),
            mf.SolverSettings(
                mf.ConvergenceSettings(absolute_tolerance=1e-10, relative_tolerance=0),
                linear_solver=linear_solver,
            ),
        )

    return make


@pytest.mark.parametrize("linear_solver", ["direct", "schur_direct", "dense"])
@pytest.mark.parametrize("p", [2, 4])
def test_stokes_flow_matches_jax(p, linear_solver, monkeypatch):
    """The DoF vectors agree to 1e-10 relative; the point data at the
    solution's scale, its largest field value: the exact pressure is zero
    (the computed one is discretization error, 1e-7 at p=4) and the
    divergence is round-off."""
    make = _stokes(p, linear_solver)
    jsol, jgrids, jstats = _solve_capturing(jf, jsolve_mod, monkeypatch, make, jflow)
    monkeypatch.undo()
    tsol, tgrids, tstats = _solve_capturing(tf, tsolve_mod, monkeypatch, make, tflow)
    assert rel(tsol, jsol) <= 1e-10
    assert np.array_equal(tstats.iter_history, jstats.iter_history)
    assert tstats.n_total_dofs == jstats.n_total_dofs
    scale = max(float(np.abs(ref).max()) for ref in jgrids[-1].point_data.values())
    for name, ref in jgrids[-1].point_data.items():
        assert np.abs(tgrids[-1].point_data[name] - ref).max() <= 1e-10 * scale, name
    vel = tgrids[-1].point_data["vel"]
    exact = tflow.stokes_velocity_exact(tgrids[-1].points[:, 0], tgrids[-1].points[:, 1])
    assert np.sqrt(np.mean(np.sum((vel - exact) ** 2, axis=-1))) < (1e-2 if p == 2 else 1e-4)


def test_unported_options_raise(tmp_path):
    mesh, settings, solver = _mixed_poisson(tf, tpoisson)
    # With device_mesh every option is ported; what still raises are the
    # reference's own guards: a TimeDependent operator field in a sharded
    # march, and TimeDependent operator fields with VMS.
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from mfv2d_torch.models import transport

    u = tpoisson.mixed_poisson().u
    wind = tf.TimeDependent(lambda x, y, t: np.stack((x + t, y), axis=-1))
    advection = transport.linear_advection_diffusion(
        0.1, wind, lambda x, y: 0.0 * x, lambda x, y: 0.0 * x
    )
    march = tf.TimeSettings(0.1, 2, {advection.u.weight: advection.u})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        one_rank = init_device_mesh("cpu", (1,))
        with pytest.raises(NotImplementedError, match="sharded marches"):
            tf.solve_system_2d(
                tf.examples.unit_square_mesh(2, 2, 2), tf.SystemSettings(advection.system),
                tf.SolverSettings(device_mesh=one_rank), time_settings=march, device="cpu",
            )
        # A sharded march and a sharded Newton solve, which raised before.
        grids, stats, _ = tf.solve_system_2d(
            mesh, settings, tf.SolverSettings(solver.convergence, device_mesh=one_rank),
            time_settings=tf.TimeSettings(0.1, 2, {u.weight: u}), device="cpu",
        )
        assert len(grids) == 3 and stats.iter_history.shape == (2,)
        grids, stats, _ = tf.solve_system_2d(
            mesh, settings,
            tf.SolverSettings(solver.convergence, method="newton", device_mesh=one_rank),
            device="cpu",
        )
        assert len(grids) == 1 and int(stats.iter_history[0]) >= 1
    finally:
        dist.destroy_process_group()
    sym = tf.KFormSystem(
        advection.q.weight.derivative @ advection.u - advection.q.weight @ advection.q
        == 0 * (advection.q.weight @ advection.q),
        0.1 * (advection.u.weight @ advection.q.derivative)
        == 0 * (advection.u.weight @ advection.u),
    )
    with pytest.raises(NotImplementedError, match="vms_settings"):
        tf.solve_system_2d(
            tf.examples.unit_square_mesh(2, 2, 2),
            tf.SystemSettings(advection.system, over_integration_order=2),
            time_settings=march,
            vms_settings=tf.VMSSettings(sym, advection.system, 2,
                                        tf.ConvergenceSettings(5, 1e-8, 1e-6)),
            device="cpu",
        )

    # Checkpoints are ported: a steady solve with checkpoint_settings solves
    # and writes its file.
    path = str(tmp_path / "steady.npz")
    grids, stats, _ = tf.solve_system_2d(
        mesh, settings, solver, checkpoint_settings=tf.CheckpointSettings(path), device="cpu"
    )
    assert len(grids) == 2
    from mfv2d_torch.checkpoint import load_steady_state

    assert load_steady_state(path)["iteration"] == int(stats.iter_history[0])
    with pytest.raises(ValueError, match="Unknown iterative method"):
        tf.solve_system_2d(
            mesh, settings, tf.SolverSettings(linear_solver="no-such-solver"), device="cpu"
        )

    # VMS settings whose systems do not match the solved one are refused, as
    # in the JAX package.
    model = tflow.navier_stokes(10.0)
    vms = tf.VMSSettings(model.system, model.system, 1, tf.ConvergenceSettings())
    with pytest.raises(ValueError, match="VMS symmetric system"):
        tf.solve_system_2d(mesh, settings, vms_settings=vms, device="cpu")

    # Newton and time marches are ported: they solve.
    u = tpoisson.mixed_poisson().u
    time_settings = tf.TimeSettings(0.1, 2, {u.weight: u})
    grids, stats, _ = tf.solve_system_2d(
        mesh, settings, solver, time_settings=time_settings, device="cpu"
    )
    assert len(grids) == 3 and stats.iter_history.shape == (2,)
    newton = tf.SolverSettings(solver.convergence, method="newton")
    grids, stats, _ = tf.solve_system_2d(mesh, settings, newton, device="cpu")
    assert len(grids) == 2 and int(stats.iter_history[0]) >= 1

    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator

    disc = discretize_mesh(mesh, settings.system.unknown_forms, FemCache(3), device="cpu")
    evaluator = SystemEvaluator(disc.form_spec, CompiledSystem(settings.system), disc)
    (jac,) = evaluator.element_jacobians(np.zeros(disc.n_dofs))
    n = disc.form_spec.total_size(3, 3)
    assert jac.shape == (16, n, n)


def test_entry_points_default_to_the_card(monkeypatch):
    """The entry points and the public constructors take the CUDA device
    unless the caller asks for the CPU, and without a CUDA device they raise
    instead of falling back."""
    from mfv2d_torch.evaluation import ElementBatch
    from mfv2d_torch.interop import jacobian_terms_from_numpy
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh

    for fn in (tf.solve_system_2d, discretize_mesh, ElementBatch, jacobian_terms_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    mesh, settings, _ = _mixed_poisson(tf, tpoisson)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.solve_system_2d(mesh, settings)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        discretize_mesh(mesh, settings.system.unknown_forms, FemCache(3))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ElementBatch(FemCache(3).get_basis2d(2, 2), np.eye(4, 2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        jacobian_terms_from_numpy(*np.ones((5, 1, 4)))
