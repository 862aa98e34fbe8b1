"""The element-sharded steady solve of the port against the JAX package's.

The port's ranks are processes (``torch.multiprocessing``, start method
``spawn``) in one ``gloo`` process group on the CPU, at 2 and 3 ranks; each
rank runs every case of ``CASES`` and sends its results back.  The JAX
package's ``sharded_*`` functions run in this process on the conftest's 8
virtual CPU devices, on its f64 path (``MFV2D_TPU_SHARDED_MIXED`` unset),
and the port's answers must agree with them to 1e-8.  Every rank must
return the same answer, and the counts of each rank's collectives show one
``all_reduce`` per trace matvec.

This module imports JAX and the JAX package inside its test functions
only: the ranks import it, and they stay JAX-free.
"""

import contextlib
import functools
import importlib
import os
import queue as queue_module
import shutil
import socket
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

SPAWN_TIMEOUT_S = 300
PG_TIMEOUT_S = 120


def u_exact(x, y):
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y) + 5


def source_exact(x, y):
    return -(np.pi**2) * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def a_field(x, y):
    return np.stack((1.5 + 0 * x, -0.8 + 0 * y), axis=-1)


def _mixed(mf, advection=False):
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    pw = q.weight
    lhs = v @ q.derivative
    if advection:
        lhs = lhs - ((a_field * v) @ q)
    return mf.KFormSystem(pw.derivative @ u - pw @ q == pw ^ u_exact, lhs == -(v @ source_exact))


HP_ORDERS = [[2, 2], [3, 3], [2, 2], [3, 3], [2, 2], [3, 3], [2, 2], [3, 3], [2, 2]]
NS = dict(absolute_tolerance=1e-8, relax=0.5, krylov_method="gmres",
          cg_maximum_iterations=4000, cg_tolerance=1e-11)
# The JAX package takes about 1.3 s a Picard iteration of the sharded
# Navier-Stokes GMRES solve on the CPU: it is held against the port over
# the first NS_CAP iterations, and the port runs on to convergence.
NS_CAP = 8


def _mesh(mf, case):
    if case == "hp":
        return mf.examples.unit_square_mesh(3, 3, np.array(HP_ORDERS))
    n, p = {"3x3p3": (3, 3), "4x4p3": (4, 3), "4x4p4": (4, 4)}[case]
    return mf.examples.unit_square_mesh(n, n, p)


def _pkg(mf, name):
    return importlib.import_module(f"{mf.__name__}.{name}")


def _linear_system(mf, system, mesh):
    """(disc, forcing, matrices, lagrange_mat, lagrange_vec) of a steady system."""
    kw = {"device": "cpu"} if mf.__name__ == "mfv2d_torch" else {}
    disc = _pkg(mf, "solver.discretization").discretize_mesh(
        mesh, system.unknown_forms, _pkg(mf, "ops.basis").FemCache(3), **kw
    )
    solve = _pkg(mf, "solver.solve")
    compiled = _pkg(mf, "compiler").CompiledSystem(system)
    evaluator = solve.SystemEvaluator(system.unknown_forms, compiled, disc)
    forcing, matrices, lag, lag_vec = solve.compute_linear_system(
        disc, system, evaluator, [], [], None
    )
    return disc, forcing, [np.asarray(m) for m in matrices], lag, lag_vec, evaluator


@contextlib.contextmanager
def _anderson(sharding, anderson_m=3):
    """Anderson acceleration in ``sharding``'s sharded steady solve.  Its
    entry point takes no ``anderson_m`` (in either package), so the Picard
    loop it calls is given one."""
    loop = sharding._sharded_nonlinear_iterate
    sharding._sharded_nonlinear_iterate = functools.partial(loop, anderson_m=anderson_m)
    try:
        yield
    finally:
        sharding._sharded_nonlinear_iterate = loop


def _ns(mf, mesh):
    flow = _pkg(mf, "models.flow")
    model = flow.navier_stokes(10.0)
    bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices,
                                      flow.ns_velocity_exact)
    return model, bc


# -- the ranks' cases (JAX-free) ------------------------------------------------


def case_operators(mesh, tmp):
    """Schur matvec, saddle step and Picard residual on 16 elements, with
    the collectives each makes."""
    import mfv2d_torch as tf
    from mfv2d_torch.parallel.sharding import ShardedBlockSystem

    disc, forcing, mats, lag, _, evaluator = _linear_system(tf, _mixed(tf), _mesh(tf, "4x4p3"))
    sharded = ShardedBlockSystem(disc, mats[0], lag, mesh)
    comm = sharded.comm
    rng = np.random.default_rng(0)
    lam = torch.as_tensor(rng.normal(size=lag.shape[0]))
    x = rng.normal(size=disc.n_dofs)
    before = sum(comm.counts.values())
    schur = sharded.make_schur_matvec()(lam)
    per_matvec = sum(comm.counts.values()) - before
    au, gu = sharded.make_residual_step()(sharded.shard_dofs(x), lam)

    compiled = _pkg(tf, "compiler").CompiledSystem(_mixed(tf))
    assembled = ShardedBlockSystem.from_assembly(disc, compiled.linear_blocks, lag, comm)
    residual = assembled.make_picard_residual(compiled.lhs_blocks, compiled.rhs_blocks)
    before = sum(comm.counts.values())
    r_elem, g_u = residual(assembled.shard_dofs(x), lam, assembled.shard_dofs(forcing))
    per_residual = sum(comm.counts.values()) - before
    return {
        "schur": schur.numpy(),
        "per_matvec": per_matvec,
        "au": sharded.unshard_dofs(au),
        "gu": gu.numpy(),
        "r_elem": assembled.unshard_dofs(r_elem),
        "g_u": g_u.numpy(),
        "per_residual": per_residual,
        "host_residual": forcing - evaluator.residual_value(x) - lag.T @ lam.numpy(),
        "host_trace": lag @ x,
        "assembled_blocks_equal": bool(
            torch.equal(assembled.blocks, sharded.blocks)
        ),
        "rows": (sharded.lo, sharded.hi),
    }


def case_schur_solve(mesh, tmp):
    import mfv2d_torch as tf
    from mfv2d_torch.parallel.sharding import ShardedBlockSystem, sharded_schur_solve

    disc, forcing, mats, lag, lag_vec, _ = _linear_system(tf, _mixed(tf), _mesh(tf, "3x3p3"))
    sharded = ShardedBlockSystem(disc, mats[0], lag, mesh)
    matvecs = sharded.comm.matvecs
    u, lam, res, iters = sharded_schur_solve(sharded, forcing, lag_vec, 3000, 1e-11)
    return {"u": u, "lam": lam, "res": res, "iters": iters,
            "matvecs": sharded.comm.matvecs - matvecs}


def _steady(mesh, case, **kw):
    import mfv2d_torch as tf
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.parallel.sharding import TraceComm, sharded_steady_solve
    from mfv2d_torch.solver.discretization import discretize_mesh

    comm = TraceComm(mesh)
    if case.startswith("ns"):
        m = _mesh(tf, "4x4p3")
        model, bc = _ns(tf, m)
        system = model.system
        kw.update(boundary_conditions=[bc], constrained_forms=[(0.0, model.pressure)])
    else:
        m = _mesh(tf, case)
        system = _mixed(tf, advection=kw.pop("advection", False))
    disc = discretize_mesh(m, system.unknown_forms, FemCache(3), device="cpu")
    u, lam, residuals = sharded_steady_solve(system, disc, comm, **kw)
    return {"u": u, "lam": lam, "residuals": residuals, "counts": dict(comm.counts),
            "matvecs": comm.matvecs, "krylov": list(comm.krylov),
            "buckets": len(disc.buckets)}


def case_steady(mesh, tmp):
    return _steady(mesh, "4x4p3", absolute_tolerance=1e-10)


def case_hp(mesh, tmp):
    """hp mesh: the multi-bucket operator beside the port's single-device
    one, and the sharded steady solve."""
    import mfv2d_torch as tf
    from mfv2d_torch.parallel.sharding import MultiBucketShardedSystem
    from mfv2d_torch.solver.iterative import BlockSaddleSystem

    disc, forcing, mats, lag, lag_vec, _ = _linear_system(tf, _mixed(tf), _mesh(tf, "hp"))
    msys = MultiBucketShardedSystem(disc, mats, lag, mesh)
    lam = torch.as_tensor(np.random.default_rng(2).normal(size=lag.shape[0]))
    before = sum(msys.comm.counts.values())
    schur = msys.make_schur_matvec()(lam)
    per_matvec = sum(msys.comm.counts.values()) - before
    single = BlockSaddleSystem(disc, mats, lag, device="cpu")
    u, _, _, _ = msys.solve_schur(forcing, lag_vec, 3000, 1e-11)
    out = _steady(mesh, "hp", absolute_tolerance=1e-10)
    out.update(schur=schur.numpy(), single=single.apply_schur(lam).numpy(),
               per_matvec=per_matvec, solve_schur=u, n_buckets=len(msys.subsystems))
    return out


def case_advection_gmres(mesh, tmp):
    return _steady(mesh, "3x3p3", absolute_tolerance=1e-9, krylov_method="gmres",
                   advection=True)


def case_ns_gmres(mesh, tmp):
    from mfv2d_torch.parallel import sharding

    out = {
        "capped": _steady(mesh, "ns", maximum_iterations=NS_CAP, **NS),
        "converged": _steady(mesh, "ns", maximum_iterations=80, **NS),
    }
    with _anderson(sharding):
        out["anderson capped"] = _steady(mesh, "ns", maximum_iterations=NS_CAP, **NS)
        out["anderson"] = _steady(mesh, "ns", maximum_iterations=80, **NS)
    return out


def case_entry(mesh, tmp):
    """solve_system_2d with device_mesh, and its checkpoint resume."""
    import mfv2d_torch as tf

    def run(resume, path=None, mesh_size="4x4p3", max_iters=20):
        kw = {}
        if path is not None:
            kw["checkpoint_settings"] = tf.CheckpointSettings(
                path, every=1, resume_from=path if resume else None
            )
        sols, stats, _ = tf.solve_system_2d(
            _mesh(tf, mesh_size),
            tf.SystemSettings(_mixed(tf)),
            tf.SolverSettings(tf.ConvergenceSettings(max_iters, 1e-10, 0), device_mesh=mesh),
            device="cpu",
            **kw,
        )
        return sols, stats

    sols, stats = run(False)
    path = os.path.join(tmp, "steady.npz")
    first, stats1 = run(False, path, "3x3p3")
    from mfv2d_torch.checkpoint import load_steady_state

    state = load_steady_state(path)
    second, stats2 = run(True, path, "3x3p3")
    return {
        "u": sols[-1].point_data["u"], "n_grids": len(sols),
        "iters": int(stats.iter_history[0]), "n_total_dofs": stats.n_total_dofs,
        "ckpt_iteration": state["iteration"], "ckpt_first_iters": int(stats1.iter_history[0]),
        "resumed_iters": int(stats2.iter_history[0]),
        "resumed_gap": float(np.abs(second[-1].point_data["u"] - first[-1].point_data["u"]).max()),
        "ckpt_u": first[-1].point_data["u"],
        "tmp": tmp,
    }


def case_refuses(mesh, tmp):
    """Singular element blocks fail on every rank with a ValueError."""
    import mfv2d_torch as tf
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.parallel.sharding import sharded_steady_solve
    from mfv2d_torch.solver.discretization import discretize_mesh

    def ua(x, y):
        return x + 2 * y

    u = tf.KFormUnknown("u", tf.UnknownFormOrder.FORM_ORDER_0)
    q = tf.KFormUnknown("q", tf.UnknownFormOrder.FORM_ORDER_1)
    system = tf.KFormSystem(
        u.weight.derivative @ u.derivative == 0 * (u.weight @ ua),
        q.weight @ u.derivative - q.weight @ q == 0,
        sorting=lambda f: f.order,
    )
    m = tf.examples.unit_square_mesh(3, 3, 2)
    bc = tf.BoundaryCondition2DSteady(u, m.boundary_indices, ua)
    disc = discretize_mesh(m, system.unknown_forms, FemCache(3), device="cpu")
    out = {}
    try:
        sharded_steady_solve(system, disc, mesh, boundary_conditions=[bc], krylov_method="gmres")
    except ValueError as exc:
        out["singular"] = str(exc)
    return out


CASES = {
    "operators": case_operators,
    "schur_solve": case_schur_solve,
    "steady": case_steady,
    "hp": case_hp,
    "advection_gmres": case_advection_gmres,
    "ns_gmres": case_ns_gmres,
    "entry": case_entry,
    "refuses": case_refuses,
}


def _rank_main(rank, world, port, cases, tmp, queue):
    """One rank: join the gloo group, run ``cases`` (name -> function) in
    order, send the results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
            timeout=timedelta(seconds=PG_TIMEOUT_S),
        )
        mesh = init_device_mesh("cpu", (world,))
        results = {}
        for name, case in cases.items():
            case_tmp = os.path.join(tmp, f"{name}-{world}")
            os.makedirs(case_tmp, exist_ok=True)
            results[name] = case(mesh, case_tmp)
        queue.put((rank, results))
        dist.destroy_process_group()
    except BaseException as exc:  # reported to the parent, which fails the test
        import traceback

        queue.put((rank, traceback.format_exc()))
        raise exc


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, names, tmp, table=None) -> list[dict]:
    """Run the named cases of ``table`` (name -> module-level function of
    ``(mesh, tmp)``; this module's ``CASES`` by default) on ``world``
    spawned gloo ranks; results by rank."""
    import torch.multiprocessing as mp

    table = CASES if table is None else table
    cases = {name: table[name] for name in names}
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, port, cases, str(tmp), queue))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < world:
            try:
                rank, res = queue.get(timeout=2)
            except queue_module.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                assert not dead and time.monotonic() < deadline, (
                    f"ranks hung or died: exit codes {[p.exitcode for p in procs]}"
                )
                continue
            if isinstance(res, str):
                raise AssertionError(f"rank {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [results[r] for r in range(world)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return run_ranks(2, CASES, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return run_ranks(3, ["operators", "steady", "hp"], tmp_path_factory.mktemp("ranks3"))


@pytest.fixture(scope="module", params=[2, 3], ids=["2 ranks", "3 ranks"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from jax.sharding import Mesh

    os.environ.pop("MFV2D_TPU_SHARDED_MIXED", None)
    return Mesh(np.array(jax.devices())[:8], axis_names=("e",))


def _same_on_every_rank(ranks, case, key, sub=None):
    def get(r):
        out = r[case] if sub is None else r[case][sub]
        return np.asarray(out[key])

    first = get(ranks[0])
    for other in ranks[1:]:
        assert np.array_equal(get(other), first), (case, sub, key)
    return first


def rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / np.abs(ref).max())


# -- the tests ------------------------------------------------------------------


def test_sharded_operators_match_single_device(ranks, jax_mesh):
    """The sharded Schur operator equals the port's BlockSaddleSystem (and
    the JAX package's sharded one); the saddle step equals the host's."""
    import jax.numpy as jnp

    import mfv2d_torch as tf
    import mfv2d_tpu as jf
    from mfv2d_torch.solver.iterative import BlockSaddleSystem
    from mfv2d_tpu.parallel.sharding import ShardedBlockSystem as JaxSharded

    disc, forcing, mats, lag, _, _ = _linear_system(tf, _mixed(tf), _mesh(tf, "4x4p3"))
    single = BlockSaddleSystem(disc, mats, lag, device="cpu")
    rng = np.random.default_rng(0)
    lam = rng.normal(size=lag.shape[0])
    x = rng.normal(size=disc.n_dofs)
    want = single.apply_schur(torch.as_tensor(lam)).numpy()
    schur = _same_on_every_rank(ranks, "operators", "schur")
    assert rel(schur, want) <= 1e-12
    jdisc, _, jmats, jlag, _, _ = _linear_system(jf, _mixed(jf), _mesh(jf, "4x4p3"))
    jschur = np.asarray(JaxSharded(jdisc, jmats[0], jlag, jax_mesh).make_schur_matvec()(
        jnp.asarray(lam)))
    assert rel(schur, jschur) <= 1e-8
    au = _same_on_every_rank(ranks, "operators", "au")
    gu = _same_on_every_rank(ranks, "operators", "gu")
    assert rel(au, (single.apply_diagonal(torch.as_tensor(x))
                    + single.apply_trace_transpose(torch.as_tensor(lam))).numpy()) <= 1e-12
    assert rel(gu, lag @ x) <= 1e-12
    # Uneven shards: 16 elements as 8+8 or 6+5+5.
    rows = [r["operators"]["rows"] for r in ranks]
    assert rows[0][0] == 0 and rows[-1][1] == 16
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


def test_one_all_reduce_per_matvec(ranks):
    """A trace Schur matvec makes one all_reduce on every rank; so does the
    Picard residual (its trace value), and a Krylov solve makes one per
    matvec and no other."""
    for r in ranks:
        assert r["operators"]["per_matvec"] == 1
        assert r["operators"]["per_residual"] == 1
        counts = r["steady"]["counts"]
        assert counts["schur"] == r["steady"]["matvecs"] > 0
        n_res = len(r["steady"]["residuals"])
        # Each Picard iteration: the residual's trace and norm; each update:
        # the Schur right-hand side; once: the singular probe per bucket and
        # the DoF gather.
        assert counts == {"setup": 1, "residual": n_res, "norm": n_res, "rhs": n_res - 1,
                          "schur": r["steady"]["matvecs"], "gather": 1}
        hp = r["hp"]
        assert hp["per_matvec"] == 1 and hp["counts"]["schur"] == hp["matvecs"]


def test_picard_residual_matches_host(ranks):
    for r in ranks:
        op = r["operators"]
        assert op["assembled_blocks_equal"]
        assert rel(op["r_elem"], op["host_residual"]) <= 1e-12
        assert rel(op["g_u"], op["host_trace"]) <= 1e-12


def test_sharded_schur_solve_matches_jax(ranks2, jax_mesh):
    import mfv2d_tpu as jf
    from mfv2d_tpu.parallel.sharding import ShardedBlockSystem, sharded_schur_solve

    disc, forcing, mats, lag, lag_vec, _ = _linear_system(jf, _mixed(jf), _mesh(jf, "3x3p3"))
    sharded = ShardedBlockSystem(disc, mats[0], lag, jax_mesh)
    u_ref, _, _, _ = sharded_schur_solve(sharded, forcing, lag_vec, 3000, 1e-11)
    u = _same_on_every_rank(ranks2, "schur_solve", "u")
    out = ranks2[0]["schur_solve"]
    assert out["res"] <= 1e-11 and out["iters"] > 1 and out["matvecs"] >= out["iters"]
    assert rel(u, u_ref) <= 1e-8


def _jax_steady(jax_mesh, case, **kw):
    import mfv2d_tpu as jf
    from mfv2d_tpu.ops.basis import FemCache
    from mfv2d_tpu.parallel.sharding import sharded_steady_solve
    from mfv2d_tpu.solver.discretization import discretize_mesh

    if case.startswith("ns"):
        m = _mesh(jf, "4x4p3")
        model, bc = _ns(jf, m)
        system = model.system
        kw.update(boundary_conditions=[bc], constrained_forms=[(0.0, model.pressure)])
    else:
        m = _mesh(jf, case)
        system = _mixed(jf, advection=kw.pop("advection", False))
    disc = discretize_mesh(m, system.unknown_forms, FemCache(3))
    return sharded_steady_solve(system, disc, jax_mesh, **kw)


@pytest.fixture(scope="module")
def jax_steady(jax_mesh):
    """The JAX package's sharded steady solves, each run once."""
    return {
        "steady": _jax_steady(jax_mesh, "4x4p3", absolute_tolerance=1e-10),
        "hp": _jax_steady(jax_mesh, "hp", absolute_tolerance=1e-10),
    }


def test_sharded_steady_solve_matches_jax(ranks, jax_steady):
    """4x4 p=3 mixed Poisson: assembly, Picard and trace CG on the ranks."""
    u_ref, lam_ref, res_ref = jax_steady["steady"]
    u = _same_on_every_rank(ranks, "steady", "u")
    assert rel(u, u_ref) <= 1e-8
    assert rel(_same_on_every_rank(ranks, "steady", "lam"), lam_ref) <= 1e-8
    assert len(ranks[0]["steady"]["residuals"]) == len(res_ref)
    assert ranks[0]["steady"]["residuals"][-1] <= 1e-10
    assert all(method == "cg" for method, _ in ranks[0]["steady"]["krylov"])


@pytest.fixture(scope="module")
def jax_hp_schur(jax_mesh):
    import mfv2d_tpu as jf
    from mfv2d_tpu.parallel.sharding import MultiBucketShardedSystem

    disc, forcing, mats, lag, lag_vec, _ = _linear_system(jf, _mixed(jf), _mesh(jf, "hp"))
    jsys = MultiBucketShardedSystem(disc, mats, lag, jax_mesh)
    return jsys.solve_schur(forcing, lag_vec, 3000, 1e-11)[0]


def test_sharded_hp_matches_jax(ranks, jax_hp_schur, jax_steady):
    """hp mesh of two order buckets, 4 and 5 elements: the summed operator,
    the Schur solve and the steady solve."""
    for r in ranks:
        assert r["hp"]["n_buckets"] == 2
        assert rel(r["hp"]["schur"], r["hp"]["single"]) <= 1e-12
    assert rel(_same_on_every_rank(ranks, "hp", "solve_schur"), jax_hp_schur) <= 1e-8
    u_ref, _, res_ref = jax_steady["hp"]
    assert rel(_same_on_every_rank(ranks, "hp", "u"), u_ref) <= 1e-8
    assert len(ranks[0]["hp"]["residuals"]) == len(res_ref)


def test_sharded_gmres_nonsymmetric_matches_jax(ranks2, jax_mesh):
    """Advection makes the trace Schur complement nonsymmetric: GMRES."""
    u_ref, _, res_ref = _jax_steady(jax_mesh, "3x3p3", absolute_tolerance=1e-9,
                                    krylov_method="gmres", advection=True)
    out = ranks2[0]["advection_gmres"]
    assert rel(_same_on_every_rank(ranks2, "advection_gmres", "u"), u_ref) <= 1e-8
    assert out["residuals"][-1] <= 1e-9 and len(out["residuals"]) == len(res_ref)
    assert {m for m, _ in out["krylov"]} == {"gmres"}


def test_sharded_navier_stokes_gmres_matches_jax(ranks2, jax_mesh):
    """Navier-Stokes Re=10, 4x4 p=3, Picard (relaxation 0.5) through trace
    GMRES: the first NS_CAP iterates against the JAX package's, then on to
    convergence, with and without Anderson acceleration."""
    u_ref, _, res_ref = _jax_steady(jax_mesh, "ns", maximum_iterations=NS_CAP, **NS)
    capped = ranks2[0]["ns_gmres"]["capped"]
    assert rel(_same_on_every_rank(ranks2, "ns_gmres", "u", "capped"), u_ref) <= 1e-8
    assert np.abs(capped["residuals"] - res_ref).max() <= 1e-8 * res_ref.max()
    assert {m for m, _ in capped["krylov"]} == {"gmres"}
    converged = ranks2[0]["ns_gmres"]["converged"]
    assert converged["residuals"][-1] <= 1e-8 and len(converged["residuals"]) < 80
    u = _same_on_every_rank(ranks2, "ns_gmres", "u", "converged")
    # Anderson (an option of the sharded loop) reaches the same answer in
    # fewer iterations.
    anderson = ranks2[0]["ns_gmres"]["anderson"]
    assert len(anderson["residuals"]) < len(converged["residuals"])
    assert rel(_same_on_every_rank(ranks2, "ns_gmres", "u", "anderson"), u) <= 1e-7


def test_sharded_anderson_matches_jax(ranks2, jax_mesh):
    """The Picard loop's Anderson extrapolation (anderson_m=3) against the
    JAX package's over the first NS_CAP iterations of the Navier-Stokes
    solve, where it takes the extrapolated step."""
    from mfv2d_tpu.parallel import sharding

    with _anderson(sharding):
        u_ref, _, res_ref = _jax_steady(jax_mesh, "ns", maximum_iterations=NS_CAP, **NS)
    out = ranks2[0]["ns_gmres"]["anderson capped"]
    u = _same_on_every_rank(ranks2, "ns_gmres", "u", "anderson capped")
    assert rel(u, u_ref) <= 1e-8
    assert np.abs(out["residuals"] - res_ref).max() <= 1e-8 * res_ref.max()
    # The extrapolation moved the iterate off the plain Picard one.
    plain = _same_on_every_rank(ranks2, "ns_gmres", "u", "capped")
    assert rel(u, plain) > 1e-6
    # Two DoF gathers an update beside the final one.
    assert out["counts"]["gather"] == 2 * len(out["krylov"]) + 1


def test_solve_system_2d_device_mesh_matches_jax(ranks2, jax_mesh):
    """The entry point with SolverSettings(device_mesh=...) against the JAX
    package's sharded entry point, and its checkpoint resume."""
    import mfv2d_tpu as jf

    sols, stats, _ = jf.solve_system_2d(
        _mesh(jf, "4x4p3"), jf.SystemSettings(_mixed(jf)),
        jf.SolverSettings(jf.ConvergenceSettings(20, 1e-10, 0), device_mesh=jax_mesh),
    )
    out = ranks2[0]["entry"]
    assert out["n_grids"] == len(sols) and out["iters"] == int(stats.iter_history[0])
    assert out["n_total_dofs"] == stats.n_total_dofs
    assert rel(_same_on_every_rank(ranks2, "entry", "u"), sols[-1].point_data["u"]) <= 1e-8


def test_sharded_steady_checkpoint_resume(ranks2, jax_mesh, tmp_path):
    """Per-iteration checkpoints of the sharded solve; resuming from the
    converged file finishes at once with the same answer, and the file
    resumes the JAX package's sharded solve too."""
    import mfv2d_tpu as jf
    from mfv2d_tpu.checkpoint import CheckpointSettings

    out = ranks2[0]["entry"]
    assert out["ckpt_iteration"] == out["ckpt_first_iters"] >= 1
    assert out["resumed_iters"] <= 1 and out["resumed_gap"] <= 1e-10
    path = str(tmp_path / "from-port.npz")
    shutil.copy(os.path.join(out["tmp"], "steady.npz"), path)
    sols, stats, _ = jf.solve_system_2d(
        _mesh(jf, "3x3p3"), jf.SystemSettings(_mixed(jf)),
        jf.SolverSettings(jf.ConvergenceSettings(20, 1e-10, 0), device_mesh=jax_mesh),
        checkpoint_settings=CheckpointSettings(path, every=1, resume_from=path),
    )
    assert int(stats.iter_history[0]) <= 1
    assert np.abs(sols[-1].point_data["u"] - out["ckpt_u"]).max() <= 1e-10


def test_sharded_refuses(ranks2):
    """Singular element blocks raise on every rank, naming them."""
    for r in ranks2:
        assert "singular" in r["refuses"]["singular"]
