"""Checkpoints of the port against the JAX package's.

The five cases of the JAX package's test_checkpoint.py, each run through both
packages on the same inputs, and the interchange of files between them: the
two packages write the same keys, so a mesh, march or steady file written by
either one loads and resumes in the other.
"""

import importlib

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch import checkpoint as tck
from mfv2d_tpu import checkpoint as jck

torch.set_num_threads(1)


def _kw(mf, **kw):
    if mf is tf:
        kw["device"] = "cpu"
    return kw


def _transport(mf):
    return importlib.import_module(f"{mf.__name__}.models.transport")


def _refined_mesh(mf):
    """A 3x2 mesh with a split element, a split child and mixed orders."""
    mesh = mf.examples.unit_square_mesh(3, 2, 2)
    mesh.split_element(1, (1, 1), (2, 1), (1, 2), (2, 2))
    mesh.split_element(7, (3, 3), (2, 2), (3, 2), (2, 3))
    mesh.set_leaf_orders(4, 4, 3)
    return mesh


def _same_mesh(back, mesh):
    assert back.element_count == mesh.element_count
    assert back.leaf_count == mesh.leaf_count
    assert np.array_equal(back.boundary_indices, mesh.boundary_indices)
    assert np.array_equal(back.get_leaf_indices(), mesh.get_leaf_indices())
    for idx in mesh.get_leaf_indices():
        idx = int(idx)
        assert np.array_equal(back.get_leaf_corners(idx), mesh.get_leaf_corners(idx))
        assert back.get_leaf_orders(idx) == mesh.get_leaf_orders(idx)
        assert back.get_element_parent(idx) == mesh.get_element_parent(idx)
    for i in range(mesh.element_count):
        assert back.get_element_children(i) == mesh.get_element_children(i)
    # By their 1-based signed ids: the packages' topology classes differ.
    for mine, ref in ((back.primal, mesh.primal), (back.dual, mesh.dual)):
        assert (mine.n_points, mine.n_lines, mine.n_surfaces) == (
            ref.n_points, ref.n_lines, ref.n_surfaces
        )
        for i in range(1, ref.n_lines + 1):
            a, b = mine.get_line(i), ref.get_line(i)
            assert (a.begin.unpack(), a.end.unpack()) == (b.begin.unpack(), b.end.unpack())
        for i in range(1, ref.n_surfaces + 1):
            a, b = mine.get_surface(i), ref.get_surface(i)
            assert [g.unpack() for g in a.lines] == [g.unpack() for g in b.lines]


@pytest.mark.parametrize("refined", [False, True], ids=["uniform", "refined-hp"])
def test_mesh_roundtrip(tmp_path, refined):
    """The port's file round-trips and holds the JAX package's arrays, key
    for key (a split element's orders are -1)."""
    if refined:
        mesh, jmesh = _refined_mesh(tf), _refined_mesh(jf)
    else:
        mesh, jmesh = tf.examples.unit_square_mesh(3, 2, 2), jf.examples.unit_square_mesh(3, 2, 2)
    path = tmp_path / "mesh.npz"
    tf.save_mesh(path, mesh)
    _same_mesh(tf.load_mesh(path), mesh)
    mine, ref = tck.mesh_to_arrays(mesh), jck.mesh_to_arrays(jmesh)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert np.asarray(mine[key]).dtype == np.asarray(ref[key]).dtype, key
        assert np.array_equal(mine[key], ref[key]), key
    if refined:
        assert (mine["orders"][1] == -1).all()


def test_mesh_roundtrip_is_solvable():
    """A reloaded mesh drives a solve to the same answer, the JAX package's."""
    sols = {}
    for mf, ck in ((tf, tck), (jf, jck)):
        model = importlib.import_module(f"{mf.__name__}.models.poisson").mixed_poisson()
        mesh = mf.examples.unit_square_mesh(2, 2, 3)
        back = ck.mesh_from_arrays(ck.mesh_to_arrays(mesh))
        sols_a, _, _ = mf.solve_system_2d(
            mesh, mf.SystemSettings(model.system), **_kw(mf, recon_order=4)
        )
        sols_b, _, _ = mf.solve_system_2d(
            back, mf.SystemSettings(model.system), **_kw(mf, recon_order=4)
        )
        assert np.allclose(sols_a[-1].point_data["u"], sols_b[-1].point_data["u"], atol=1e-12)
        sols[mf] = sols_b[-1].point_data["u"]
    assert np.allclose(sols[tf], sols[jf], atol=1e-12)


def _final_u(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


NT, T_END = 8, 0.5


def _march(mf, mesh, nt, ckpt=None, resume=None, every=4):
    model = _transport(mf).reaction(1.5, _final_u)
    kw = {}
    if ckpt is not None:
        kw["checkpoint_settings"] = mf.CheckpointSettings(
            str(ckpt), every=every, resume_from=None if resume is None else str(resume)
        )
    sols, _, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
        time_settings=mf.TimeSettings(
            dt=T_END / NT, nt=nt, time_march_relations=model.time_march_relations
        ),
        **_kw(mf, recon_order=4, **kw),
    )
    return sols


def test_march_checkpoint_resume(tmp_path):
    """nt=4 and a resume to nt=8 match one uninterrupted nt=8 march (1e-13),
    in both packages, and the port's runs match the JAX package's."""
    finals = {}
    for mf, ck in ((tf, tck), (jf, jck)):
        path = tmp_path / f"march-{mf.__name__}.npz"
        full = _march(mf, mf.examples.unit_square_mesh(2, 2, 3), NT)
        _march(mf, mf.examples.unit_square_mesh(2, 2, 3), NT // 2, path)
        state = ck.load_march_state(path)
        assert state["time_index"] == NT // 2 and state["dt"] == T_END / NT
        resumed = _march(mf, state["mesh"], NT, path, resume=path)
        assert float(resumed[-1].field_data["time"][0]) == T_END
        assert np.abs(resumed[-1].point_data["u"] - full[-1].point_data["u"]).max() <= 1e-13
        # The resumed run's first grid is the restored state at its time.
        assert float(resumed[0].field_data["time"][0]) == NT // 2 * T_END / NT
        mid = next(g for g in full if float(g.field_data["time"][0]) == NT // 2 * T_END / NT)
        assert np.abs(resumed[0].point_data["u"] - mid.point_data["u"]).max() <= 1e-13
        finals[mf] = [g.point_data["u"] for g in resumed]
    for mine, ref in zip(finals[tf], finals[jf], strict=True):
        assert np.abs(mine - ref).max() <= 1e-10 * np.abs(ref).max()


def test_resume_rejects_wrong_mesh(tmp_path):
    model = _transport(tf).reaction(1.0, lambda x, y: x * 0 + 1.0)
    settings = tf.TimeSettings(dt=0.1, nt=2, time_march_relations=model.time_march_relations)
    ckpt = tmp_path / "m.npz"
    tf.solve_system_2d(
        tf.examples.unit_square_mesh(2, 2, 2),
        tf.SystemSettings(model.system),
        time_settings=settings,
        checkpoint_settings=tf.CheckpointSettings(str(ckpt), every=2),
        device="cpu",
    )
    with pytest.raises(ValueError, match="DoF count"):
        tf.solve_system_2d(
            tf.examples.unit_square_mesh(3, 3, 2),
            tf.SystemSettings(model.system),
            time_settings=settings,
            checkpoint_settings=tf.CheckpointSettings(str(ckpt), resume_from=str(ckpt)),
            device="cpu",
        )
    # A steady file of the wrong size is refused the same way.
    path = tmp_path / "steady.npz"
    tck.save_steady_state(path, np.zeros(3), np.zeros(2), None, 1, 0.0)
    with pytest.raises(ValueError, match="DoF count"):
        tf.solve_system_2d(
            tf.examples.unit_square_mesh(2, 2, 2),
            tf.SystemSettings(model.system),
            checkpoint_settings=tf.CheckpointSettings(str(path), resume_from=str(path)),
            device="cpu",
        )


NU = -1.0


def _vms_u(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def _vms_q(x, y):
    return np.stack(
        (
            -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def _vms_source(x, y):
    return np.sum(_vms_q(x, y) ** 2, axis=-1) - NU * np.pi**2 * _vms_u(x, y) / 2


def _vms_run(mf, max_iters, ckpt):
    model = _transport(mf).nonlinear_flow(NU, _vms_u, _vms_source)
    u, q = model.u, model.q
    v, pw = u.weight, q.weight
    symmetric = mf.KFormSystem(
        pw.derivative @ u - pw @ q == pw ^ _vms_u,
        NU * (v @ q.derivative) == -(v @ _vms_source),
    )
    sols, stats, _ = mf.solve_system_2d(
        mf.examples.unit_square_mesh(3, 3, 3),
        mf.SystemSettings(model.system, over_integration_order=3),
        mf.SolverSettings(
            mf.ConvergenceSettings(max_iters, 1e-9, 0), linear_solver="schur_direct"
        ),
        vms_settings=mf.VMSSettings(
            symmetric_system=symmetric,
            nonsymmetric_system=model.system,
            order_increase=2,
            fine_scale_convergence=mf.ConvergenceSettings(10, 1e-10, 1e-8),
            matrix_free=True,
        ),
        **_kw(mf, recon_order=4, checkpoint_settings=ckpt),
    )
    grid = sols[-1]
    return grid.point_data["u"], grid.point_data["vms-u"], int(stats.iter_history[0])


def test_steady_checkpoint_resume_vms(tmp_path):
    """A steady VMS Picard solve cut after 4 iterations resumes to the
    uninterrupted answer, with the JAX package's iterations and values."""
    results = {}
    for mf, ck in ((tf, tck), (jf, jck)):
        u_full, vms_full, iters_full = _vms_run(mf, 40, None)
        assert iters_full > 4
        path = str(tmp_path / f"steady-{mf.__name__}.npz")
        ckpt = mf.CheckpointSettings(path, every=1, resume_from=path)
        _vms_run(mf, 4, ckpt)
        st = ck.load_steady_state(path)
        assert st["iteration"] == 4 and st["fine_scales"] is not None
        u_res, vms_res, iters_res = _vms_run(mf, 40, ckpt)
        assert iters_res < iters_full
        assert np.allclose(u_res, u_full, atol=1e-9)
        assert np.allclose(vms_res, vms_full, atol=1e-10)
        assert ck.load_steady_state(path)["iteration"] == 4 + iters_res
        results[mf] = (u_res, vms_res, iters_res, st)
    (tu, tv, ti, tst), (ju, jv, ji, jst) = results[tf], results[jf]
    assert ti == ji
    assert np.abs(tu - ju).max() <= 1e-10 * np.abs(ju).max()
    assert np.abs(tv - jv).max() <= 1e-12
    # The cut iterates (solution, multipliers, fine scales) agree too.
    for key in ("solution", "lagrange", "fine_scales"):
        assert np.abs(tst[key] - jst[key]).max() <= 1e-10 * max(np.abs(jst[key]).max(), 1.0)


def test_jax_march_file_resumes_in_port(tmp_path):
    """A march file the JAX package wrote resumes in the port to the JAX
    package's own resumed run (1e-12)."""
    path = tmp_path / "jax-march.npz"
    _march(jf, jf.examples.unit_square_mesh(2, 2, 3), NT // 2, path)
    state = tck.load_march_state(path)
    assert state["time_index"] == NT // 2
    mine = _march(tf, state["mesh"], NT, tmp_path / "port.npz", resume=path)
    ref = _march(jf, jck.load_march_state(path)["mesh"], NT, tmp_path / "jax2.npz", resume=path)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert float(a.field_data["time"][0]) == float(b.field_data["time"][0])
        assert np.abs(a.point_data["u"] - b.point_data["u"]).max() <= 1e-12


def test_port_files_load_in_jax(tmp_path):
    """Mesh, march and steady files the port wrote load in
    mfv2d_tpu.checkpoint with the same contents, and the reverse."""
    rng = np.random.default_rng(0)
    vecs = [rng.normal(size=k) for k in (11, 5, 3, 3)]
    mesh, jmesh = _refined_mesh(tf), _refined_mesh(jf)
    for writer, reader, m in ((tck, jck, mesh), (jck, tck, jmesh)):
        tag = writer.__name__.split(".")[0]
        writer.save_mesh(tmp_path / f"{tag}-mesh.npz", m)
        _same_mesh(reader.load_mesh(tmp_path / f"{tag}-mesh.npz"), m)
        writer.save_march_state(tmp_path / f"{tag}-march.npz", m, *vecs, 7, 0.125)
        st = reader.load_march_state(tmp_path / f"{tag}-march.npz")
        _same_mesh(st["mesh"], m)
        for key, v in zip(("solution", "lagrange", "old_carry", "carry_term"), vecs):
            assert np.array_equal(st[key], v)
        assert (st["time_index"], st["dt"]) == (7, 0.125)
        for fine in (None, vecs[2]):
            writer.save_steady_state(tmp_path / f"{tag}-steady.npz", vecs[0], vecs[1], fine, 9, 2.5)
            st = reader.load_steady_state(tmp_path / f"{tag}-steady.npz")
            assert np.array_equal(st["solution"], vecs[0])
            assert np.array_equal(st["lagrange"], vecs[1])
            assert (st["fine_scales"] is None) == (fine is None)
            if fine is not None:
                assert np.array_equal(st["fine_scales"], fine)
            assert (st["iteration"], st["elapsed"]) == (9, 2.5)
    # A march file is not a steady one.
    with pytest.raises(ValueError, match="not a steady"):
        tck.load_steady_state(tmp_path / "mfv2d_tpu-march.npz")


def _ns(mf, path, max_iters, resume):
    flow = importlib.import_module(f"{mf.__name__}.models.flow")
    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(4, 4, 4)
    bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, flow.ns_velocity_exact)
    sols, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(mf.ConvergenceSettings(max_iters, 1e-8, 0), relaxation=0.7),
        **_kw(
            mf,
            recon_order=4,
            checkpoint_settings=mf.CheckpointSettings(
                str(path), every=1, resume_from=None if resume is None else str(resume)
            ),
        ),
    )
    return sols[-1].point_data["vel"], int(stats.iter_history[0])


@pytest.mark.parametrize("first", ["port", "jax"])
def test_steady_files_interchange(tmp_path, first):
    """A steady Picard solve cut by one package resumes in the other to the
    uninterrupted answer, with the iterations adding up."""
    cut, rest = (tf, jf) if first == "port" else (jf, tf)
    full, iters_full = _ns(jf, tmp_path / "full.npz", 60, None)
    path = tmp_path / "cut.npz"
    _ns(cut, path, 4, None)
    vel, iters = _ns(rest, tmp_path / "rest.npz", 60, path)
    assert 4 + iters == iters_full
    assert np.abs(vel - full).max() <= 1e-10 * np.abs(full).max()
    assert jck.load_steady_state(tmp_path / "rest.npz")["iteration"] == iters_full
