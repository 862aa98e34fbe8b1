"""The port's time marches and its dense linear solver against the JAX package.

One parity case for each test of the JAX package's test_solve_unsteady.py, at
small sizes.  Both packages run the same problem through their public
``solve_system_2d``; every solution each one reconstructs (the initial state
and each sampled step) is captured, and the port's must agree with the JAX
package's to 1e-10 relative, with equal ``time`` values, grid counts and
per-step iteration histories.  The port's ``"dense"`` solves run the same
host loops as every other linear solver; they are held against the JAX
package's device loops and against the port's ``"direct"``.
"""

import importlib

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf

torch.set_num_threads(1)

SOLVE_MODULES = {
    jf: importlib.import_module("mfv2d_tpu.solve_system_2d"),
    tf: importlib.import_module("mfv2d_torch.solve_system_2d"),
}

ALPHA = 0.02
BETA = 1.0
RE = 10.0


def rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / max(np.abs(ref).max(), 1e-300))


def _models(mf, name):
    return importlib.import_module(f"{mf.__name__}.models.{name}")


def steady_u(x, y):
    return np.cos(np.pi * x / 2) * np.cos(np.pi * y / 2)


def exact_velocity(x, y):
    return np.stack((np.sin(y) + 0 * x, np.cos(x) + 0 * y), axis=-1)


def exact_forcing(x, y):
    return np.stack(
        (
            np.cos(x) * np.cos(y) + 1 / RE * np.sin(y),
            -np.sin(x) * np.sin(y) + 1 / RE * np.cos(x),
        ),
        axis=-1,
    )


def _run(mf, monkeypatch, build, **options):
    """Solve ``build(mf, **options)`` and capture every reconstructed solution."""
    module = SOLVE_MODULES[mf]
    captured = []
    original = module.reconstruct_mesh_from_solution

    def capture(disc, recon_order, solution, *args):
        captured.append(np.array(solution))
        return original(disc, recon_order, solution, *args)

    with monkeypatch.context() as m:
        m.setattr(module, "reconstruct_mesh_from_solution", capture)
        mesh, settings, solver, kw = build(mf, **options)
        if mf is tf:
            kw["device"] = "cpu"
        grids, stats, _ = mf.solve_system_2d(mesh, settings, solver, **kw)
    return captured, grids, stats


def _assert_same(mine, ref, iterations=True):
    (tsol, tgrids, tstats), (jsol, jgrids, jstats) = mine, ref
    assert len(tgrids) == len(jgrids) == len(tsol) == len(jsol)
    for a, b in zip(tsol, jsol):
        assert rel(a, b) <= 1e-10
    assert [list(g.field_data.get("time", ())) for g in tgrids] == [
        list(g.field_data.get("time", ())) for g in jgrids
    ]
    if iterations:
        assert np.array_equal(tstats.iter_history, jstats.iter_history)


def _check_parity(monkeypatch, build, iterations=True, **options):
    ref = _run(jf, monkeypatch, build, **options)
    mine = _run(tf, monkeypatch, build, **options)
    _assert_same(mine, ref, iterations)
    return mine


def _check_dense(monkeypatch, build, **options):
    """The dense solver's loop against the JAX package's, and against the
    port's loop through SuperLU."""
    dense = _check_parity(monkeypatch, build, linear_solver="dense", **options)
    direct = _run(tf, monkeypatch, build, linear_solver="direct", **options)
    _assert_same(dense, direct)
    return dense


def _heat(mf, nt=4, n=4, p=3):
    """Reaction-diffusion march whose exact solution is s(x,y)(1-e^{-bt})."""
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(
        ALPHA * (v.derivative @ u.derivative)
        == BETA * (v @ steady_u) - (BETA - ALPHA * np.pi**2 / 2) * (v @ u),
    )
    mesh = mf.examples.unit_square_mesh(n, n, p)
    return (
        mesh,
        mf.SystemSettings(
            system,
            boundary_conditions=[
                mf.BoundaryCondition2DSteady(u, mesh.boundary_indices, steady_u)
            ],
        ),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
        dict(time_settings=mf.TimeSettings(dt=1.0 / nt, nt=nt, time_march_relations={v: u}),
             recon_order=8),
    )


def test_heat_march(monkeypatch):
    tsol, tgrids, tstats = _check_parity(monkeypatch, _heat)
    assert len(tgrids) == 5
    assert float(tgrids[0].field_data["time"][0]) == 0.0
    assert np.isclose(float(tgrids[-1].field_data["time"][0]), 1.0)
    g = tgrids[-1]
    exact = steady_u(g.points[:, 0], g.points[:, 1]) * (1 - np.exp(-BETA))
    assert float(np.sqrt(np.mean((g.point_data["u"] - exact) ** 2))) < 1e-2


def _stationary_heat(mf, linear_solver="direct", n=4, p=4, nt=4, dt=0.1):
    """Start from the exact steady state of a linear heat equation."""
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(
        ALPHA * (v.derivative @ u.derivative)
        == (ALPHA * np.pi**2 / 2) * (v @ steady_u),
    )
    mesh = mf.examples.unit_square_mesh(n, n, p)
    return (
        mesh,
        mf.SystemSettings(
            system,
            boundary_conditions=[
                mf.BoundaryCondition2DSteady(u, mesh.boundary_indices, steady_u)
            ],
            initial_conditions={u: steady_u},
        ),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0), linear_solver=linear_solver),
        dict(time_settings=mf.TimeSettings(dt=dt, nt=nt, time_march_relations={v: u}),
             recon_order=8),
    )


def test_heat_march_initial_conditions(monkeypatch):
    _, tgrids, _ = _check_parity(monkeypatch, _stationary_heat)
    for g in tgrids:
        exact = steady_u(g.points[:, 0], g.points[:, 1])
        assert np.max(np.abs(g.point_data["u"] - exact)) < 2e-5


def _navier_stokes(mf, linear_solver="direct", method="picard", nt=None, dt=0.05,
                   n=3, p=3, max_iterations=30, atol=1e-9):
    pre = mf.KFormUnknown("pre", mf.UnknownFormOrder.FORM_ORDER_2)
    vel = mf.KFormUnknown("vel", mf.UnknownFormOrder.FORM_ORDER_1)
    vor = mf.KFormUnknown("vor", mf.UnknownFormOrder.FORM_ORDER_0)
    w_pre, w_vel, w_vor = pre.weight, vel.weight, vor.weight
    system = mf.KFormSystem(
        w_vor.derivative @ vel - w_vor @ vor == w_vor ^ exact_velocity,
        (1 / RE) * (w_vel @ vor.derivative) + w_vel.derivative @ pre
        == w_vel @ exact_forcing - (vel * w_vel @ vor),
        (w_pre @ vel.derivative) == 0,
    )
    mesh = mf.examples.unit_square_mesh(n, n, p)
    kw = dict(recon_order=5)
    if nt is not None:
        kw["time_settings"] = mf.TimeSettings(
            dt=dt, nt=nt, time_march_relations={w_vel: vel}
        )
    return (
        mesh,
        mf.SystemSettings(
            system,
            [mf.BoundaryCondition2DSteady(vel, mesh.boundary_indices, exact_velocity)],
            [(0.0, pre)],
        ),
        mf.SolverSettings(
            mf.ConvergenceSettings(max_iterations, atol, 0),
            relaxation=0.7 if nt is None and method == "picard" else 1.0,
            linear_solver=linear_solver,
            method=method,
        ),
        kw,
    )


def test_steady_navier_stokes(monkeypatch):
    _, tgrids, tstats = _check_parity(
        monkeypatch, _navier_stokes, n=4, p=4, max_iterations=80, atol=1e-7
    )
    assert 1 < int(tstats.iter_history[-1]) < 80


def test_dense_linear_march_matches_direct(monkeypatch):
    _check_dense(monkeypatch, _stationary_heat, n=3, p=3, nt=4, dt=0.05)


def _ns_re5(mf, linear_solver, method="picard", re=5.0, p=3, atol=1e-9, max_iterations=15):
    flow = _models(mf, "flow")
    model = flow.navier_stokes(re)
    mesh = mf.examples.unit_square_mesh(3, 3, p)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    return (
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(max_iterations, atol, 0),
            linear_solver=linear_solver,
            method=method,
        ),
        dict(recon_order=5),
    )


def test_dense_picard_matches_direct(monkeypatch):
    _, _, stats = _check_dense(monkeypatch, _ns_re5)
    assert int(stats.iter_history[-1]) > 1


def _unsteady_bc(mf, nt=4, t_end=0.5):
    """u = e^t cosh(x) solves u_t = lap(u): all dynamics enter through the
    boundary values."""

    def exact(x, y, t):
        return np.exp(t) * np.cosh(x)

    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(v.derivative @ u.derivative == 0 * (v @ u))
    mesh = mf.examples.unit_square_mesh(4, 4, 4)
    return (
        mesh,
        mf.SystemSettings(
            system,
            boundary_conditions=[
                mf.BoundaryCondition2DUnsteady(u, mesh.boundary_indices, exact)
            ],
            initial_conditions={u: lambda x, y: np.cosh(x)},
        ),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
        dict(time_settings=mf.TimeSettings(dt=t_end / nt, nt=nt, time_march_relations={v: u}),
             recon_order=6),
    )


def test_unsteady_boundary_conditions(monkeypatch):
    _, tgrids, _ = _check_parity(monkeypatch, _unsteady_bc)
    g = tgrids[-1]
    assert np.isclose(float(g.field_data["time"][0]), 0.5)
    exact = np.exp(0.5) * np.cosh(g.points[:, 0])
    assert np.max(np.abs(g.point_data["u"] - exact)) < 1e-3


def test_unsteady_bc_requires_time_settings():
    u = tf.KFormUnknown("u", tf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = tf.KFormSystem(v.derivative @ u.derivative == 0 * (v @ u))
    mesh = tf.examples.unit_square_mesh(2, 2, 2)
    bc = tf.BoundaryCondition2DUnsteady(u, mesh.boundary_indices, lambda x, y, t: x + t)
    with pytest.raises(ValueError, match="time_settings"):
        tf.solve_system_2d(mesh, tf.SystemSettings(system, boundary_conditions=[bc]), device="cpu")


def test_dense_nonlinear_march_matches_direct(monkeypatch):
    _, _, stats = _check_dense(monkeypatch, _navier_stokes, nt=4)
    assert int(stats.iter_history[-1]) > 1


def test_dense_newton_matches_direct(monkeypatch):
    _, _, stats = _check_dense(
        monkeypatch, _ns_re5, method="newton", re=50.0, p=4, atol=1e-11, max_iterations=10
    )
    assert int(stats.iter_history[-1]) <= 5


def test_dense_newton_march_matches_direct(monkeypatch):
    _, _, stats = _check_dense(
        monkeypatch, _navier_stokes, method="newton", nt=3, dt=0.1, max_iterations=15,
        atol=1e-10,
    )
    assert int(stats.iter_history[0]) > 1


def _td_source(mf, nt=4, alpha=0.7):
    """u = sin(t) phi with u_t = alpha lap(u) + f(t)."""

    def phi(x, y):
        return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def source(x, y, t):
        return (np.cos(t) + alpha * np.pi**2 / 2 * np.sin(t)) * phi(x, y)

    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(
        alpha * (v.derivative @ u.derivative) == v @ mf.TimeDependent(source),
    )
    mesh = mf.examples.unit_square_mesh(4, 4, 4)
    bc = mf.BoundaryCondition2DSteady(u, mesh.boundary_indices, lambda x, y: 0.0 * x)
    return (
        mesh,
        mf.SystemSettings(system, boundary_conditions=[bc]),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
        dict(time_settings=mf.TimeSettings(dt=1.0 / nt, nt=nt, time_march_relations={v: u}),
             recon_order=6),
    )


def test_time_dependent_forcing(monkeypatch):
    _, tgrids, _ = _check_parity(monkeypatch, _td_source)
    g = tgrids[-1]
    exact = np.sin(1.0) * np.cos(np.pi / 2 * g.points[:, 0]) * np.cos(np.pi / 2 * g.points[:, 1])
    assert np.max(np.abs(g.point_data["u"] - exact)) < 1e-2


def test_time_dependent_requires_time_settings():
    u = tf.KFormUnknown("u", tf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = tf.KFormSystem(
        v.derivative @ u.derivative == v @ tf.TimeDependent(lambda x, y, t: x + t),
    )
    mesh = tf.examples.unit_square_mesh(2, 2, 2)
    with pytest.raises(ValueError, match="TimeDependent"):
        tf.solve_system_2d(mesh, tf.SystemSettings(system), device="cpu")


def test_time_dependent_operator_field_guards():
    """A steady solve with a TD operator field raises; so does a march with
    VMS (not ported: it raises naming its ROADMAP item)."""
    from mfv2d_torch.models import transport

    wind = tf.TimeDependent(lambda x, y, t: np.stack((x + t, y), axis=-1))
    model = transport.linear_advection_diffusion(
        0.1, wind, lambda x, y: 0.0 * x, lambda x, y: 0.0 * x
    )
    mesh = tf.examples.unit_square_mesh(2, 2, 2)
    with pytest.raises(ValueError, match="require time_settings"):
        tf.solve_system_2d(mesh, tf.SystemSettings(model.system), device="cpu")
    u, q = model.u, model.q
    sym = tf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == 0 * (q.weight @ q),
        0.1 * (u.weight @ q.derivative) == 0 * (u.weight @ u),
    )
    with pytest.raises(NotImplementedError, match="vms"):
        tf.solve_system_2d(
            mesh,
            tf.SystemSettings(model.system, over_integration_order=2),
            time_settings=tf.TimeSettings(0.1, 2, {model.u.weight: model.u}),
            vms_settings=tf.VMSSettings(
                symmetric_system=sym,
                nonsymmetric_system=model.system,
                order_increase=2,
                fine_scale_convergence=tf.ConvergenceSettings(5, 1e-8, 1e-6),
            ),
            device="cpu",
        )


def _reaction(mf, sample_rate=1, nt=4):
    model = _models(mf, "transport").reaction(1.0, lambda x, y: 0 * x + 1.0)
    return (
        mf.examples.unit_square_mesh(2, 2, 2),
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0), linear_solver="dense"),
        dict(
            time_settings=mf.TimeSettings(
                dt=0.05, nt=nt, time_march_relations=model.time_march_relations,
                sample_rate=sample_rate,
            ),
            recon_order=3,
        ),
    )


def test_dense_march_sampling_matches_every_step(monkeypatch):
    tsol, tgrids, _ = _check_parity(monkeypatch, _reaction, sample_rate=3)
    assert [float(g.field_data["time"][0]) for g in tgrids] == [0.0, 0.05, 0.2]
    full, full_grids, _ = _run(tf, monkeypatch, _reaction)
    by_time = {float(g.field_data["time"][0]): s for g, s in zip(full_grids, full)}
    for g, s in zip(tgrids, tsol):
        assert np.array_equal(s, by_time[float(g.field_data["time"][0])])


@pytest.mark.parametrize("nt, sample_rate", [(1, 1), (4, 3), (9, 3), (16, 5), (7, 10)])
def test_sampled_steps_are_every_sth_and_the_last(nt, sample_rate):
    """The steps whose grids a march keeps: every ``sample_rate``-th and the last."""
    from mfv2d_torch.solver.solve import sampled_time_steps

    steps = sampled_time_steps(nt, sample_rate)
    assert steps.dtype == np.int64
    assert steps.tolist() == [i for i in range(nt) if i % sample_rate == 0 or i + 1 == nt]


def _cavity(mf, anderson_m=0, linear_solver="dense"):
    def lid(x, y):
        on = np.isclose(y, 1.0)
        return np.stack((np.where(on, 1.0, 0.0), np.zeros_like(y)), axis=-1)

    model = _models(mf, "flow").cavity_flow(10.0, lid)
    mesh = mf.examples.unit_square_mesh(2, 2, 3)
    bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, lid)
    return (
        mesh,
        mf.SystemSettings(
            model.system, boundary_conditions=[bc], constrained_forms=[(0.0, model.pressure)]
        ),
        mf.SolverSettings(
            mf.ConvergenceSettings(30, 1e-9, 0), linear_solver=linear_solver,
            anderson_m=anderson_m,
        ),
        dict(
            time_settings=mf.TimeSettings(
                dt=0.25, nt=3, time_march_relations=model.time_march_relations
            ),
            recon_order=4,
        ),
    )


def test_dense_march_anderson_converges_same(monkeypatch):
    """Anderson's least-squares step amplifies round-off, so the packages'
    iterates part in the last digits on the way: the end point is held."""
    plain = _run(tf, monkeypatch, _cavity)
    tsol, _, tstats = _check_parity(monkeypatch, _cavity, iterations=False, anderson_m=3)
    assert int(np.sum(tstats.iter_history)) <= int(np.sum(plain[2].iter_history))
    assert np.allclose(tsol[-1], plain[0][-1], atol=1e-8)


def _td_wind(mf, nt=4, nu=0.8, n=3, p=4):
    """Mixed advection-diffusion with the time-varying wind (cos t, 0);
    u = sin(t) phi."""

    def phi(x, y):
        return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def phi_x(x, y):
        return -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def wind(x, y, t):
        return np.stack((np.cos(t) * np.ones_like(x), np.zeros_like(y)), axis=-1)

    def source(x, y, t):
        return (
            np.sin(t) * (-nu * np.pi**2 / 2) * phi(x, y)
            + np.sin(t) * np.cos(t) * phi_x(x, y)
            - np.cos(t) * phi(x, y)
        )

    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    p_w = q.weight
    system = mf.KFormSystem(
        p_w.derivative @ u - p_w @ q == p_w ^ (lambda x, y: 0.0 * x),
        nu * (v @ q.derivative) - (mf.TimeDependent(wind) * v @ q)
        == -(v @ mf.TimeDependent(source)),
    )
    return (
        mf.examples.unit_square_mesh(n, n, p),
        mf.SystemSettings(system),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
        dict(time_settings=mf.TimeSettings(dt=1.0 / nt, nt=nt, time_march_relations={v: u}),
             recon_order=6),
    )


def test_time_dependent_operator_field_convergence(monkeypatch):
    """The march re-evaluates the wind, re-assembles and refactorizes at every
    level; the dt^2 check runs in the port alone, at two step counts."""
    errors = []
    for nt in (2, 4):
        _, tgrids, _ = (
            _check_parity(monkeypatch, _td_wind, nt=nt, n=4)
            if nt == 4
            else _run(tf, monkeypatch, _td_wind, nt=nt, n=4)
        )
        g = tgrids[-1]
        exact = np.sin(1.0) * np.cos(np.pi / 2 * g.points[:, 0]) * np.cos(np.pi / 2 * g.points[:, 1])
        errors.append(np.max(np.abs(g.point_data["u"] - exact)))
    assert errors[0] / errors[1] > 3.0, errors


def _wind_march(mf, time_dependent):
    def phi(x, y):
        return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def steady_wind(x, y):
        return np.stack((0.5 + 0.0 * x, -0.25 + 0.0 * y), axis=-1)

    wind = mf.TimeDependent(lambda x, y, t: steady_wind(x, y)) if time_dependent else steady_wind
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = mf.KFormSystem(
        p.derivative @ u - p @ q == p ^ (lambda x, y: 0.0 * x),
        0.7 * (v @ q.derivative) - (wind * v @ q) == -(v @ phi),
    )
    return (
        mf.examples.unit_square_mesh(3, 3, 3),
        mf.SystemSettings(system),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
        dict(time_settings=mf.TimeSettings(dt=0.25, nt=3, time_march_relations={v: u}),
             recon_order=4),
    )


def test_time_dependent_operator_field_constant_matches_steady(monkeypatch):
    steady = _check_parity(monkeypatch, _wind_march, time_dependent=False)
    varying = _check_parity(monkeypatch, _wind_march, time_dependent=True)
    for a, b in zip(varying[0], steady[0]):
        assert np.allclose(a, b, atol=1e-12)


def test_march_guards():
    """Bad time settings raise as in the JAX package."""
    mesh, settings, solver, kw = _heat(tf)
    ts = kw["time_settings"]
    bad = [
        tf.TimeSettings(ts.dt, ts.nt, ts.time_march_relations, sample_rate=0),
        tf.TimeSettings(ts.dt, ts.nt, {}),
    ]
    for time_settings in bad:
        with pytest.raises(ValueError):
            tf.solve_system_2d(mesh, settings, solver, time_settings, device="cpu")
