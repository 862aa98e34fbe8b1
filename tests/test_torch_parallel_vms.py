"""The port's element-sharded VMS against the JAX package's VMS.

The port's ranks are 2 ``gloo`` processes on the CPU, spawned by
``test_torch_parallel.run_ranks``.  ``ShardedSuyashGreen`` is held against
the JAX package's single-chip ``SuyashGreenOperator`` as
``tests/test_parallel_vms.py`` holds the JAX package's sharded operator
(G' x to 1e-8, the advection to 1e-10), on a mesh of one order and on one
of two; the sharded VMS solves through ``solve_system_2d(device_mesh=...)``
(steady, Newton, the march, and a checkpointed solve) against the JAX
package's single-device VMS solves of the same setups.  Every rank must
return the same answer.

This module imports JAX and the JAX package inside its test functions and
fixtures only: the ranks import this module, and they stay JAX-free.
"""

import os

import numpy as np
import pytest

from test_torch_parallel import _same_on_every_rank, rel, run_ranks

NU = -1.0


def u_exact(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def q_exact(x, y):
    return np.stack(
        (
            -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def source_exact(x, y):
    return np.sum(q_exact(x, y) ** 2, axis=-1) - NU * np.pi**2 * u_exact(x, y) / 2


def _model(mf):
    import importlib

    transport = importlib.import_module(f"{mf.__name__}.models.transport")
    model = transport.nonlinear_flow(NU, u_exact, source_exact)
    u, q = model.u, model.q
    v, pw = u.weight, q.weight
    symmetric = mf.KFormSystem(
        pw.derivative @ u - pw @ q == pw ^ u_exact,
        NU * (v @ q.derivative) == -(v @ source_exact),
    )
    return model, symmetric


def _vms(mf, model, symmetric, atol=1e-10, rtol=1e-8):
    return mf.VMSSettings(
        symmetric_system=symmetric,
        nonsymmetric_system=model.system,
        order_increase=2,
        fine_scale_convergence=mf.ConvergenceSettings(10, atol, rtol),
        matrix_free=True,
    )


def _kw(mf):
    return {"device": "cpu"} if mf.__name__ == "mfv2d_torch" else {}


# The JAX package's sharded steady VMS solve of vms_solve(jf, "3x3", mesh)
# on 8 virtual CPU devices (tools/parallel_vms_reference.py, too slow to run
# here): its residual evaluations and max |vms-u|.
JAX_SHARDED_VMS = {"iterations": 24, "max_vms": 6.837139904175438e-06}

HP_ORDERS = [[3 + ((i + j) % 2)] * 2 for j in range(3) for i in range(3)]


def _mesh(mf, case):
    if case == "hp":
        return mf.examples.unit_square_mesh(3, 3, np.array(HP_ORDERS))
    n = {"3x3": 3, "2x2": 2}[case]
    return mf.examples.unit_square_mesh(n, n, 3)


def greens_inputs(n_fine: int, n_coarse: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, n_fine), rng.uniform(-1, 1, n_coarse)


def vms_solve(mf, case, dm, *, newton=False, march=False, checkpoint=None, iters=40,
              atol=1e-9):
    """A VMS solve through the entry point: 3x3 p=3 steady (as
    tests/test_parallel_vms.py's entry-point test), or 2x2 p=3 with Newton,
    a one-step march or a checkpoint."""
    model, symmetric = _model(mf)
    kw = {}
    if march:
        kw["time_settings"] = mf.TimeSettings(dt=0.05, nt=1,
                                              time_march_relations={model.u.weight: model.u})
    if checkpoint is not None:
        path, resume = checkpoint
        kw["checkpoint_settings"] = mf.CheckpointSettings(path, every=1, resume_from=resume)
    sols, stats, _ = mf.solve_system_2d(
        _mesh(mf, case),
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(iters, atol, 0), device_mesh=dm,
                          method="newton" if newton else "picard"),
        vms_settings=_vms(mf, model, symmetric),
        recon_order=4,
        **kw,
        **_kw(mf),
    )
    grid = sols[-1]
    return {"u": grid.point_data["u"], "vms": grid.point_data.get("vms-u"),
            "points": grid.points, "iters": np.asarray(stats.iter_history),
            "residuals": np.asarray(stats.residual_history), "n_grids": len(sols)}


# -- the ranks' cases (JAX-free) ------------------------------------------------


def _greens(mesh, case, fine_tol):
    import mfv2d_torch as tf
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.parallel.sharding import TraceComm
    from mfv2d_torch.parallel.vms import ShardedSuyashGreen
    from mfv2d_torch.solver.discretization import discretize_mesh

    comm = TraceComm(mesh)
    model, symmetric = _model(tf)
    disc = discretize_mesh(_mesh(tf, case), model.system.unknown_forms, FemCache(2),
                           device="cpu")
    sg = ShardedSuyashGreen(model.system, _vms(tf, model, symmetric, *fine_tol), disc, comm)
    x, u_c = greens_inputs(sg.fine_disc.n_dofs, disc.n_dofs, 0 if case == "3x3" else 1)
    out = {"buckets": len(disc.buckets), "n_fine": sg.fine_disc.n_dofs,
           "g": sg.fine_scale_greens_function(x), "f": sg._apply_fine_advection(x),
           "prolong": sg._prolong_to_fine(u_c), "project": sg._project_to_coarse(x)}
    sg.update_nonlinear_advection(u_c)
    out["f_nonlinear"] = sg._apply_fine_advection(x)
    out["counts"] = dict(comm.counts)
    out["matvecs"] = comm.matvecs
    out["krylov"] = list(comm.krylov)
    return out


def case_greens(mesh, tmp):
    return {"3x3": _greens(mesh, "3x3", (1e-11, 1e-9)), "hp": _greens(mesh, "hp", (1e-11, 1e-9))}


def case_solves(mesh, tmp):
    import mfv2d_torch as tf

    path = os.path.join(tmp, "vms.npz")
    first = vms_solve(tf, "2x2", mesh, checkpoint=(path, None), iters=30, atol=1e-8)
    from mfv2d_torch.checkpoint import load_steady_state

    state = load_steady_state(path)
    resumed = vms_solve(tf, "2x2", mesh, checkpoint=(path, path), iters=30, atol=1e-8)
    return {
        "steady": vms_solve(tf, "3x3", mesh),
        "newton": vms_solve(tf, "2x2", mesh, newton=True, iters=30),
        "march": vms_solve(tf, "2x2", mesh, march=True),
        "first": first,
        "resumed": resumed,
        "ckpt_iteration": state["iteration"],
        "ckpt_has_fine": state["fine_scales"] is not None,
    }


CASES = {"greens": case_greens, "solves": case_solves}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return run_ranks(2, CASES, tmp_path_factory.mktemp("vms2"), CASES)


def _jax_greens(case):
    import mfv2d_tpu as jf
    from mfv2d_tpu.compiler import CompiledSystem
    from mfv2d_tpu.ops.basis import FemCache
    from mfv2d_tpu.solver.discretization import discretize_mesh
    from mfv2d_tpu.solver.solve import SystemEvaluator
    from mfv2d_tpu.solver.vms import SuyashGreenOperator

    model, symmetric = _model(jf)
    disc = discretize_mesh(_mesh(jf, case), model.system.unknown_forms, FemCache(2))
    evaluator = SystemEvaluator(model.system.unknown_forms, CompiledSystem(model.system), disc)
    single = SuyashGreenOperator(model.system, _vms(jf, model, symmetric, 1e-11, 1e-9), disc,
                                 evaluator, [], [])
    x, u_c = greens_inputs(int(single.fine_offsets[-1]), disc.n_dofs, 0 if case == "3x3" else 1)
    out = {"n_fine": int(single.fine_offsets[-1]), "g": single.fine_scale_greens_function(x),
           "f": single._apply_fine_advection(x), "prolong": single._prolong_to_fine(u_c),
           "project": single._project_to_coarse(x)}
    single.update_nonlinear_advection(u_c)
    out["f_nonlinear"] = single._apply_fine_advection(x)
    return out


@pytest.fixture(scope="module", params=["3x3", "hp"])
def greens(request, ranks2):
    return request.param, _jax_greens(request.param)


def _scale(ref) -> float:
    return max(float(np.abs(ref).max()), 1.0)


def test_sharded_greens_matches_single_chip(ranks2, greens):
    """G' x by the two sharded saddles' trace Krylov against the JAX
    package's single-chip operator (tests/test_parallel_vms.py:62)."""
    case, ref = greens
    out = ranks2[0]["greens"][case]
    assert out["buckets"] == (2 if case == "hp" else 1)
    assert out["n_fine"] == ref["n_fine"]
    g = _same_on_every_rank(ranks2, "greens", "g", case)
    assert np.abs(g - ref["g"]).max() < 1e-8 * _scale(ref["g"])


def test_sharded_advection_matches_single_chip(ranks2, greens):
    """The fine advection, linear and rebuilt at a coarse state."""
    case, ref = greens
    for key in ("f", "f_nonlinear"):
        f = _same_on_every_rank(ranks2, "greens", key, case)
        assert np.abs(f - ref[key]).max() < 1e-10 * _scale(ref[key]), key


def test_sharded_transfers_match_single_chip(ranks2, greens):
    case, ref = greens
    for key in ("prolong", "project"):
        assert np.abs(ranks2[0]["greens"][case][key] - ref[key]).max() < 1e-12, key


def test_greens_collectives(ranks2):
    """Every reduce of the operator is tagged, and the trace matvecs of
    both saddles make one each; the saddles solve by CG."""
    for r in ranks2:
        for case in ("3x3", "hp"):
            out = r["greens"][case]
            assert out["counts"]["schur"] == out["matvecs"] > 0
            assert {m for m, _ in out["krylov"]} == {"cg"}


@pytest.fixture(scope="module")
def jax_solves():
    import mfv2d_tpu as jf

    return {
        "steady": vms_solve(jf, "3x3", None),
        "newton": vms_solve(jf, "2x2", None, newton=True, iters=30),
        "march": vms_solve(jf, "2x2", None, march=True),
    }


def test_sharded_vms_solve_matches_jax(ranks2, jax_solves):
    """The steady VMS solve through solve_system_2d(device_mesh=...)
    against the JAX package's single-device VMS solve: u to 1e-8, the
    iterations (the sharded branch counts residual evaluations, one more
    than the single-device corrections), and the recovered fine scales."""
    out = ranks2[0]["solves"]["steady"]
    ref = jax_solves["steady"]
    u = _same_on_every_rank(ranks2, "solves", "u", "steady")
    assert rel(u, ref["u"]) <= 1e-8
    assert out["residuals"][-1] <= 1e-9
    assert abs(int(out["iters"][0]) - (int(ref["iters"][0]) + 1)) <= 1
    vms = _same_on_every_rank(ranks2, "solves", "vms", "steady")
    # The sharded branch's vms-u projects the recovered fine scales, the
    # single-device branch's the unresolved-scale forcing (in both
    # packages): it is held against the JAX package's sharded solve.
    assert int(out["iters"][0]) == JAX_SHARDED_VMS["iterations"]
    assert np.abs(np.abs(vms).max() / JAX_SHARDED_VMS["max_vms"] - 1) <= 1e-8
    x, y = out["points"][:, 0], out["points"][:, 1]
    assert np.sqrt(np.mean((u - u_exact(x, y)) ** 2)) < 5e-3


def test_sharded_newton_vms_matches_jax(ranks2, jax_solves):
    """Newton with VMS (its trace solve starts as CG, as the JAX package's
    does) against the single-device Newton VMS solve."""
    u = _same_on_every_rank(ranks2, "solves", "u", "newton")
    assert rel(u, jax_solves["newton"]["u"]) <= 1e-8
    assert ranks2[0]["solves"]["newton"]["residuals"][-1] <= 1e-9


def test_sharded_vms_march_matches_jax(ranks2, jax_solves):
    """The VMS march (the host march) against the single-device VMS march:
    one step of dt = 0.05, which converges in both packages (with the
    JAX package's own dt = 0.2 neither package converges in 40 iterations
    a step, and at dt = 0.05 its second step turns to NaN), with the
    recovered fine scales on the final grid."""
    out = ranks2[0]["solves"]["march"]
    ref = jax_solves["march"]
    u = _same_on_every_rank(ranks2, "solves", "u", "march")
    assert out["n_grids"] == ref["n_grids"] == 2
    assert out["residuals"][-1] <= 1e-9 and int(out["iters"][0]) == int(ref["iters"][0]) + 1
    assert rel(u, ref["u"]) <= 1e-8
    vms = _same_on_every_rank(ranks2, "solves", "vms", "march")
    assert np.all(np.isfinite(vms)) and np.abs(vms).max() > 0


def test_sharded_vms_checkpoint_resume(ranks2):
    """A checkpointed sharded VMS solve writes its fine scales, and resuming
    from the converged file finishes at once with the same answer."""
    out = ranks2[0]["solves"]
    assert out["ckpt_iteration"] == int(out["first"]["iters"][0]) >= 1
    assert out["ckpt_has_fine"]
    assert int(out["resumed"]["iters"][0]) <= 2
    assert np.abs(out["resumed"]["u"] - out["first"]["u"]).max() <= 1e-8
