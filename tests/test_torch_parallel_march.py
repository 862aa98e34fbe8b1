"""The rest of the port's element-sharded solver against the JAX package's:
sharded Newton, the three marches and their checkpoints, and refinement.

The port's ranks are ``gloo`` processes on the CPU, spawned by
``test_torch_parallel.run_ranks``: every case of ``CASES`` at 2 ranks, and
the checkpointed march of 4 elements at 3 ranks (shards of 2, 1 and 1).
The marches and refinement are held to 1e-8 against the JAX package's
``sharded_*`` on the conftest's 8 virtual CPU devices (as
``tests/test_parallel.py`` holds those against the single-device path);
sharded Newton against the JAX package's single-device Newton; march
checkpoints resumed against the uninterrupted march, with the files read
across the packages in both directions.  Every rank must return the same
answer.

This module imports JAX and the JAX package inside its test functions and
fixtures only: the ranks import this module, and they stay JAX-free.
"""

import os
from dataclasses import replace

import numpy as np
import pytest

from test_torch_parallel import _same_on_every_rank, rel, run_ranks


def final_u(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def lid_velocity(x, y):
    on_lid = np.isclose(y, 1.0)
    return np.stack((np.where(on_lid, 1.0, 0.0), np.zeros_like(y)), axis=-1)


def heat_exact(x, y, t):
    return np.exp(t) * np.cosh(x)


def heat_initial(x, y):
    return np.cosh(x)


def td_source(x, y, t):
    return np.sin(t) * np.cos(np.pi / 2 * x)


def cavity_initial(x, y):
    return np.stack((0.1 * np.sin(np.pi * y), 0.0 * x), axis=-1)


def u_exact(x, y):
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y) + 5


def source_exact(x, y):
    return -(np.pi**2) * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


# -- the problems, built alike in either package --------------------------------


def _mixed(mf):
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    v, pw = u.weight, q.weight
    return mf.KFormSystem(
        pw.derivative @ u - pw @ q == pw ^ u_exact, v @ q.derivative == -(v @ source_exact)
    )


def _solver(mf, iters, atol, mesh=None, **kw):
    return mf.SolverSettings(mf.ConvergenceSettings(iters, atol, 0), device_mesh=mesh, **kw)


def _kw(mf):
    return {"device": "cpu"} if mf.__name__ == "mfv2d_torch" else {}


def _flow(mf):
    import importlib

    return importlib.import_module(f"{mf.__name__}.models.flow")


def _transport(mf):
    import importlib

    return importlib.import_module(f"{mf.__name__}.models.transport")


def _cavity_settings(mf, reynolds, mesh):
    model = _flow(mf).cavity_flow(reynolds, lid_velocity)
    bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, lid_velocity)
    return model, mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)])


def heat_problem(mf, dm):
    """Unsteady strong Dirichlet values and an initial state, through the
    entry point (tests/test_parallel.py:844)."""
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(v.derivative @ u.derivative == 0 * (v @ u))
    m = mf.examples.unit_square_mesh(3, 3, 3)
    sols, stats, _ = mf.solve_system_2d(
        m,
        mf.SystemSettings(
            system,
            boundary_conditions=[mf.BoundaryCondition2DUnsteady(u, m.boundary_indices,
                                                                heat_exact)],
            initial_conditions={u: heat_initial},
        ),
        _solver(mf, 20, 1e-11, dm, linear_solver="gmres"),
        time_settings=mf.TimeSettings(dt=0.05, nt=6, time_march_relations={v: u}),
        recon_order=4,
        **_kw(mf),
    )
    return {"u": sols[-1].point_data["u"], "time": float(sols[-1].field_data["time"][0]),
            "points": sols[-1].points, "iters": stats.iter_history}


def td_forcing_problem(mf, dm):
    """TimeDependent forcing through the entry point (tests/test_parallel.py:899)."""
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    v, pw = u.weight, q.weight
    system = mf.KFormSystem(
        pw.derivative @ u - pw @ q == 0, v @ q.derivative == v @ mf.TimeDependent(td_source)
    )
    sols, _, _ = mf.solve_system_2d(
        mf.examples.unit_square_mesh(3, 3, 3),
        mf.SystemSettings(system),
        _solver(mf, 20, 1e-11, dm, linear_solver="cg"),
        time_settings=mf.TimeSettings(dt=0.1, nt=5, time_march_relations={v: u}),
        recon_order=3,
        **_kw(mf),
    )
    return {"u": sols[-1].point_data["u"]}


def cavity_ics_problem(mf, dm):
    """The nonlinear march from an initial state through the entry point
    (tests/test_parallel.py:966)."""
    m = mf.examples.unit_square_mesh(3, 3, 2)
    model, settings = _cavity_settings(mf, 20.0, m)
    settings = replace(settings, initial_conditions={model.velocity: cavity_initial})
    sols, stats, _ = mf.solve_system_2d(
        m, settings, _solver(mf, 40, 1e-11, dm, linear_solver="gmres"),
        time_settings=mf.TimeSettings(dt=0.25, nt=3,
                                      time_march_relations=model.time_march_relations),
        recon_order=2,
        **_kw(mf),
    )
    return {"vel": sols[-1].point_data["vel"], "iters": stats.iter_history,
            "residuals": stats.residual_history}


def refinement_problem(mf, dm):
    """p-refinement through the entry point (tests/test_parallel.py:1052)."""
    u = _mixed(mf).unknown_forms.get_form(0)
    rs = mf.RefinementSettings(
        error_estimate=mf.ErrorEstimateL2OrderReduction(u, 1),
        h_refinement_ratio=0.0,
        refinement_limit=mf.RefinementLimitElementCount(0.5, 4),
    )
    sols, _, out_mesh = mf.solve_system_2d(
        mf.examples.unit_square_mesh(3, 3, 3), mf.SystemSettings(_mixed(mf)),
        _solver(mf, 20, 1e-10, dm), refinement_settings=rs, **_kw(mf),
    )
    orders = [tuple(int(o) for o in out_mesh.get_leaf_orders(int(i)))
              for i in out_mesh.get_leaf_indices()]
    return {"orders": np.array(orders), "estimate": sols[-1].cell_data["error_estimate"],
            "u": sols[-1].point_data["u"], "leaves": out_mesh.leaf_count}


def ns_newton_problem(mf, dm):
    """Steady Navier-Stokes Re=10 on 3x3 p=3 by exact Newton."""
    flow = _flow(mf)
    model = flow.navier_stokes(10.0)
    m = mf.examples.unit_square_mesh(3, 3, 3)
    bc = mf.BoundaryCondition2DSteady(model.velocity, m.boundary_indices,
                                      flow.ns_velocity_exact)
    sols, stats, _ = mf.solve_system_2d(
        m, mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        _solver(mf, 20, 1e-11, dm, method="newton",
                **({"linear_solver": "gmres"} if dm is not None else {})),
        recon_order=3, **_kw(mf),
    )
    return {"vel": sols[-1].point_data["vel"], "iters": int(stats.iter_history[0]),
            "residuals": stats.residual_history}


HP_ORDERS = [[2, 2], [3, 3], [3, 3], [2, 2]]


def newton_hp_problem(mf, dm):
    """The cavity at Re=15 on a 2x2 mesh of two orders by exact Newton
    (tests/test_parallel.py:1144)."""
    m = mf.examples.unit_square_mesh(2, 2, np.array(HP_ORDERS))
    _, settings = _cavity_settings(mf, 15.0, m)
    sols, stats, _ = mf.solve_system_2d(
        m, settings,
        _solver(mf, 20, 1e-11, dm, method="newton",
                **({"linear_solver": "gmres"} if dm is not None else {})),
        recon_order=2, **_kw(mf),
    )
    return {"vel": sols[-1].point_data["vel"], "iters": int(stats.iter_history[0])}


def newton_march_problem(mf, dm):
    """The cavity at Re=20 on 2x2 p=2, two steps by exact Newton
    (tests/test_parallel.py:1181)."""
    m = mf.examples.unit_square_mesh(2, 2, 2)
    model, settings = _cavity_settings(mf, 20.0, m)
    sols, stats, _ = mf.solve_system_2d(
        m, settings,
        _solver(mf, 20, 1e-11, dm, method="newton",
                **({"linear_solver": "gmres"} if dm is not None else {})),
        time_settings=mf.TimeSettings(dt=0.25, nt=2,
                                      time_march_relations=model.time_march_relations),
        recon_order=2, **_kw(mf),
    )
    return {"vel": sols[-1].point_data["vel"], "iters": stats.iter_history}


def reaction_march(mf, nt, dm=None, path=None, every=2, resume=None, mesh=None):
    """The reaction march of tests/test_parallel.py:1224 on 2x2 p=3 (dt =
    0.125), optionally checkpointed and resumed."""
    model = _transport(mf).reaction(1.5, final_u)
    kw = {}
    if path is not None:
        kw["checkpoint_settings"] = mf.CheckpointSettings(str(path), every=every,
                                                          resume_from=resume)
    sols, stats, _ = mf.solve_system_2d(
        mesh if mesh is not None else mf.examples.unit_square_mesh(2, 2, 3),
        mf.SystemSettings(model.system),
        _solver(mf, 20, 1e-11, dm, **({"linear_solver": "gmres"} if dm is not None else {})),
        time_settings=mf.TimeSettings(dt=0.125, nt=nt,
                                      time_march_relations=model.time_march_relations),
        recon_order=4, **kw, **_kw(mf),
    )
    return sols, stats


# -- the ranks' cases (JAX-free) ------------------------------------------------


def case_linear_march(mesh, tmp):
    """sharded_time_march on the mixed reaction model (tests/test_parallel.py:398)."""
    import mfv2d_torch as tf
    from mfv2d_torch.models import transport
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.parallel.sharding import TraceComm, sharded_time_march
    from mfv2d_torch.solver.discretization import discretize_mesh

    comm = TraceComm(mesh)
    model = transport.reaction_mixed(1.5, final_u)
    settings = tf.TimeSettings(dt=0.05, nt=6, time_march_relations=model.time_march_relations,
                               sample_rate=2)
    disc = discretize_mesh(tf.examples.unit_square_mesh(3, 3, 3), model.system.unknown_forms,
                           FemCache(3), device="cpu")
    us, steps, lam = sharded_time_march(model.system, disc, comm, settings, cg_tolerance=1e-13)
    return {"us": us, "steps": steps, "lam": lam, "counts": dict(comm.counts),
            "matvecs": comm.matvecs, "krylov": list(comm.krylov)}


def case_nonlinear_march(mesh, tmp):
    """sharded_nonlinear_time_march on the cavity (tests/test_parallel.py:519)."""
    import mfv2d_torch as tf
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.parallel.sharding import TraceComm, sharded_nonlinear_time_march
    from mfv2d_torch.solver.discretization import discretize_mesh

    comm = TraceComm(mesh)
    m = tf.examples.unit_square_mesh(3, 3, 2)
    model, settings = _cavity_settings(tf, 20.0, m)
    ts = tf.TimeSettings(dt=0.25, nt=4, time_march_relations=model.time_march_relations,
                         sample_rate=2)
    disc = discretize_mesh(m, model.system.unknown_forms, FemCache(3), device="cpu")
    us, steps, lam, iters, residuals = sharded_nonlinear_time_march(
        model.system, disc, comm, ts, boundary_conditions=settings.boundary_conditions,
        constrained_forms=settings.constrained_forms, max_iterations=40,
        absolute_tolerance=1e-11, cg_tolerance=1e-13, krylov_method="gmres",
    )
    return {"us": us, "steps": steps, "lam": lam, "iters": iters, "residuals": residuals,
            "counts": dict(comm.counts), "matvecs": comm.matvecs,
            "krylov": list(comm.krylov)}


def case_entry_marches(mesh, tmp):
    import mfv2d_torch as tf

    return {"heat": heat_problem(tf, mesh), "td": td_forcing_problem(tf, mesh),
            "cavity": cavity_ics_problem(tf, mesh)}


def case_refinement(mesh, tmp):
    import mfv2d_torch as tf

    return refinement_problem(tf, mesh)


def case_newton(mesh, tmp):
    import mfv2d_torch as tf
    from mfv2d_torch.parallel.sharding import TraceComm

    comm = TraceComm(mesh)
    out = {"steady": ns_newton_problem(tf, comm)}
    out["steady"].update(counts=dict(comm.counts), matvecs=comm.matvecs,
                         krylov=list(comm.krylov))
    out["hp"] = newton_hp_problem(tf, mesh)
    out["march"] = newton_march_problem(tf, mesh)
    return out


def case_march_checkpoint(mesh, tmp):
    """The reaction march, cut at 2 of 4 steps and resumed, beside the
    uninterrupted march; and the JAX package's cut file, resumed."""
    import mfv2d_torch as tf
    from mfv2d_torch.checkpoint import load_march_state

    path = os.path.join(tmp, "cut.npz")
    whole, _ = reaction_march(tf, 4, mesh)
    reaction_march(tf, 2, mesh, path=path)
    state = load_march_state(path)
    resumed, _ = reaction_march(tf, 4, mesh, path=os.path.join(tmp, "resumed.npz"),
                                resume=path, mesh=state["mesh"])
    out = {
        "whole": whole[-1].point_data["u"],
        "resumed": resumed[-1].point_data["u"],
        "time_index": state["time_index"],
        "first_time": float(resumed[0].field_data["time"][0]),
        "last_time": float(resumed[-1].field_data["time"][0]),
        "n_grids": len(resumed),
        "path": path,
    }
    jax_file = os.path.join(os.path.dirname(tmp), "jax-cut.npz")
    if os.path.exists(jax_file):
        from_jax, _ = reaction_march(tf, 4, mesh, path=os.path.join(tmp, "from-jax.npz"),
                                     resume=jax_file,
                                     mesh=load_march_state(jax_file)["mesh"])
        out["from_jax"] = from_jax[-1].point_data["u"]
    return out


CASES = {
    "linear_march": case_linear_march,
    "nonlinear_march": case_nonlinear_march,
    "entry_marches": case_entry_marches,
    "refinement": case_refinement,
    "newton": case_newton,
    "march_checkpoint": case_march_checkpoint,
}


def _jax_cut_file(tmp):
    """The JAX package's single-device reaction march cut at 2 of 4 steps,
    written where the ranks' checkpoint case reads it."""
    import mfv2d_tpu as jf

    reaction_march(jf, 2, path=os.path.join(tmp, "jax-cut.npz"))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("march2")
    _jax_cut_file(tmp)
    return run_ranks(2, CASES, tmp, CASES)


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("march3")
    _jax_cut_file(tmp)
    return run_ranks(3, ["march_checkpoint"], tmp, CASES)


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from jax.sharding import Mesh

    os.environ.pop("MFV2D_TPU_SHARDED_MIXED", None)
    return Mesh(np.array(jax.devices())[:8], axis_names=("e",))


# -- the tests ------------------------------------------------------------------


def test_linear_march_matches_jax(ranks2, jax_mesh):
    import mfv2d_tpu as jf
    from mfv2d_tpu.models import transport
    from mfv2d_tpu.ops.basis import FemCache
    from mfv2d_tpu.parallel.sharding import sharded_time_march
    from mfv2d_tpu.solver.discretization import discretize_mesh

    model = transport.reaction_mixed(1.5, final_u)
    settings = jf.TimeSettings(dt=0.05, nt=6, time_march_relations=model.time_march_relations,
                               sample_rate=2)
    disc = discretize_mesh(jf.examples.unit_square_mesh(3, 3, 3), model.system.unknown_forms,
                           FemCache(3))
    us_ref, steps_ref, lam_ref = sharded_time_march(model.system, disc, jax_mesh, settings,
                                                    cg_tolerance=1e-13)
    us = _same_on_every_rank(ranks2, "linear_march", "us")
    assert list(ranks2[0]["linear_march"]["steps"]) == list(steps_ref) == [0, 2, 4, 5]
    assert us.shape == np.asarray(us_ref).shape
    assert rel(us, us_ref) <= 1e-8
    assert rel(_same_on_every_rank(ranks2, "linear_march", "lam"), lam_ref) <= 1e-8


def test_linear_march_collectives(ranks2):
    """A linear step reduces the trace residual and the Schur right-hand
    side once each, and a Krylov matvec once; the samples are gathered
    once at the end."""
    for r in ranks2:
        out = r["linear_march"]
        steps = 6
        assert out["counts"] == {"setup": 1, "residual": steps, "rhs": steps,
                                 "schur": out["matvecs"], "gather": 1}
        assert len(out["krylov"]) == steps


def test_nonlinear_march_matches_jax(ranks2, jax_mesh):
    """The Picard march: states, per-step iterations and residuals."""
    import mfv2d_tpu as jf
    from mfv2d_tpu.ops.basis import FemCache
    from mfv2d_tpu.parallel.sharding import sharded_nonlinear_time_march
    from mfv2d_tpu.solver.discretization import discretize_mesh

    m = jf.examples.unit_square_mesh(3, 3, 2)
    model, settings = _cavity_settings(jf, 20.0, m)
    ts = jf.TimeSettings(dt=0.25, nt=4, time_march_relations=model.time_march_relations,
                         sample_rate=2)
    disc = discretize_mesh(m, model.system.unknown_forms, FemCache(3))
    us_ref, steps_ref, _, iters_ref, res_ref = sharded_nonlinear_time_march(
        model.system, disc, jax_mesh, ts, boundary_conditions=settings.boundary_conditions,
        constrained_forms=settings.constrained_forms, max_iterations=40,
        absolute_tolerance=1e-11, cg_tolerance=1e-13, krylov_method="gmres",
    )
    out = ranks2[0]["nonlinear_march"]
    assert list(out["steps"]) == list(steps_ref) == [0, 2, 3]
    assert rel(_same_on_every_rank(ranks2, "nonlinear_march", "us"), us_ref) <= 1e-8
    assert np.array_equal(out["iters"], np.asarray(iters_ref))
    assert np.all(out["residuals"] <= 1e-11)
    assert np.all(np.asarray(res_ref) <= 1e-11)
    assert {m for m, _ in out["krylov"]} == {"gmres"}


def test_nonlinear_march_collectives(ranks2):
    """Each Picard iteration of a step reduces its trace residual and norm,
    each correction its Schur right-hand side, each step its scale."""
    for r in ranks2:
        out = r["nonlinear_march"]
        corrections = int(out["iters"].sum())
        evaluations = corrections + len(out["iters"])  # every step converged
        assert out["counts"] == {"setup": 1, "magnitude": 4, "residual": evaluations,
                                 "norm": evaluations, "rhs": corrections,
                                 "schur": out["matvecs"], "gather": 1}


@pytest.fixture(scope="module")
def jax_entry(jax_mesh):
    import mfv2d_tpu as jf

    return {"heat": heat_problem(jf, jax_mesh), "td": td_forcing_problem(jf, jax_mesh),
            "cavity": cavity_ics_problem(jf, jax_mesh)}


def test_unsteady_bcs_and_ics_march_matches_jax(ranks2, jax_entry):
    """Unsteady strong boundary values frozen at every level, and the
    consistent start from an initial state (the constraint values of each
    step computed up front)."""
    ref = jax_entry["heat"]
    out = ranks2[0]["entry_marches"]["heat"]
    u = _same_on_every_rank(ranks2, "entry_marches", "u", "heat")
    assert out["time"] == pytest.approx(6 * 0.05)
    assert rel(u, ref["u"]) <= 1e-8
    err = np.abs(u - heat_exact(out["points"][:, 0], out["points"][:, 1], out["time"])).max()
    assert err < 5e-4


def test_td_forcing_march_matches_jax(ranks2, jax_entry):
    """TimeDependent forcing: the forcing of every step computed up front."""
    u = _same_on_every_rank(ranks2, "entry_marches", "u", "td")
    assert rel(u, jax_entry["td"]["u"]) <= 1e-8
    assert np.abs(u).max() > 1e-4


def test_nonlinear_march_with_ics_matches_jax(ranks2, jax_entry):
    out = ranks2[0]["entry_marches"]["cavity"]
    ref = jax_entry["cavity"]
    assert rel(_same_on_every_rank(ranks2, "entry_marches", "vel", "cavity"), ref["vel"]) <= 1e-8
    assert np.array_equal(out["iters"], np.asarray(ref["iters"]))


def test_refinement_matches_jax(ranks2, jax_mesh):
    """Every rank refines to the same mesh, the JAX package's."""
    import mfv2d_tpu as jf

    ref = refinement_problem(jf, jax_mesh)
    orders = _same_on_every_rank(ranks2, "refinement", "orders")
    out = ranks2[0]["refinement"]
    assert out["leaves"] == ref["leaves"]
    # The symmetric mesh has ties in the element errors, which the two
    # solutions (1e-10 apart) may break differently: compare the multisets.
    assert sorted(map(tuple, orders)) == sorted(map(tuple, ref["orders"]))
    assert rel(_same_on_every_rank(ranks2, "refinement", "estimate"), ref["estimate"]) <= 1e-8
    assert rel(out["u"], ref["u"]) <= 1e-8


@pytest.fixture(scope="module")
def jax_newton():
    import mfv2d_tpu as jf

    return {"steady": ns_newton_problem(jf, None),
            "hp": newton_hp_problem(jf, None),
            "march": newton_march_problem(jf, None)}


def test_newton_steady_matches_jax(ranks2, jax_newton):
    """Navier-Stokes by exact Newton through trace GMRES against the JAX
    package's single-device Newton: the same corrections (the sharded
    branch counts residual evaluations, one more), the same residuals
    until they reach round-off, quadratic convergence and the same
    velocity."""
    out = ranks2[0]["newton"]["steady"]
    ref = jax_newton["steady"]
    assert out["iters"] == ref["iters"] + 1 <= 7
    assert rel(_same_on_every_rank(ranks2, "newton", "vel", "steady"), ref["vel"]) <= 1e-8
    res = out["residuals"]
    assert np.abs(res[:2] - ref["residuals"][:2]).max() <= 1e-8 * res[0]
    assert res[-1] <= 1e-11 and res[2] <= 1e-2 * res[1]
    assert {m for m, _ in out["krylov"]} == {"gmres"}


def test_newton_rebuilds_inverses_every_step(ranks2):
    """One set-up reduce a bucket for the frozen operator and one for each
    Newton step's Jacobian system; a GMRES solve a correction."""
    for r in ranks2:
        out = r["newton"]["steady"]
        corrections = out["iters"] - 1
        assert out["counts"]["setup"] == 1 + (corrections - 1)
        assert len(out["krylov"]) == corrections
        assert out["counts"]["schur"] == out["matvecs"]


def test_newton_hp_matches_jax(ranks2, jax_newton):
    ref = jax_newton["hp"]
    assert rel(_same_on_every_rank(ranks2, "newton", "vel", "hp"), ref["vel"]) <= 1e-8
    assert ranks2[0]["newton"]["hp"]["iters"] == ref["iters"] + 1


def test_newton_march_matches_jax(ranks2, jax_newton):
    """The host march by Newton: per-step residual evaluations (the
    single-device march counts corrections, one fewer) and the final
    velocity."""
    ref = jax_newton["march"]
    out = ranks2[0]["newton"]["march"]
    assert rel(_same_on_every_rank(ranks2, "newton", "vel", "march"), ref["vel"]) <= 1e-8
    assert np.array_equal(out["iters"], np.asarray(ref["iters"]) + 1)
    assert np.all(out["iters"] <= 6)


@pytest.fixture(scope="module", params=[2, 3], ids=["2 ranks", "3 ranks"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


def test_march_checkpoint_resume(ranks):
    """Cut at 2 of 4 steps and resumed: the uninterrupted march's answer,
    the resumed grids starting at the cut."""
    out = ranks[0]["march_checkpoint"]
    resumed = _same_on_every_rank(ranks, "march_checkpoint", "resumed")
    assert out["time_index"] == 2 and out["n_grids"] == 3
    assert out["first_time"] == 2 * 0.125 and out["last_time"] == 4 * 0.125
    assert np.abs(resumed - out["whole"]).max() <= 1e-12 * np.abs(out["whole"]).max()


def test_march_checkpoint_resumes_jax(ranks, tmp_path):
    """The sharded march's file resumes the JAX package's single-device
    march, and the JAX package's file resumes the sharded march."""
    import mfv2d_tpu as jf
    from mfv2d_tpu.checkpoint import load_march_state

    whole, _ = reaction_march(jf, 4)
    ref = whole[-1].point_data["u"]
    out = ranks[0]["march_checkpoint"]
    sols, _ = reaction_march(jf, 4, path=tmp_path / "jax-resumed.npz", every=4,
                             resume=out["path"], mesh=load_march_state(out["path"])["mesh"])
    assert rel(sols[-1].point_data["u"], ref) <= 1e-10
    from_jax = _same_on_every_rank(ranks, "march_checkpoint", "from_jax")
    assert rel(from_jax, ref) <= 1e-10
    assert rel(out["resumed"], ref) <= 1e-10
