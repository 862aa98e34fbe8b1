"""The Stokes flow of the benchmark's ``stokes_vvp`` configuration (BASELINE
config 3: vorticity 0-form, velocity 1-form, pressure 2-form, weak
boundary conditions) through static condensation, on the curved square the
cell draws its meshes from.

The port's ``"schur_direct"`` solve is held to its own ``"direct"`` solve
and to the JAX package's ``"schur_direct"``, and its fields to the closed
form within the cell's limits at a size where the discretization error is
far below them.  The tracer's part: one ``block-inverse`` span around the
element inverses of each ``BlockSaddleSystem`` (``factorize/block-inverse``
in a steady solve) with the refinement rounds counted in it, SuperLU's
``nnz`` counted under the trace factorization's ``superlu`` span, answers
bitwise the same with the tracer on and off, and ``"direct"`` solves with
the paths they had.
"""

import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.models import flow as tflow
from mfv2d_torch.solver import iterative as ti
from mfv2d_torch.tracing import tracer
from mfv2d_tpu.models import flow as jflow

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CELL = "stokes_32x32_p8_schur_direct"
LIMITS = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]
CONFIG = json.loads((BENCH / "configs" / "stokes_vvp.json").read_text())
AMPLITUDE = 0.0613

tsolve_mod = importlib.import_module("mfv2d_torch.solve_system_2d")
jsolve_mod = importlib.import_module("mfv2d_tpu.solve_system_2d")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "configs" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REFERENCE = _load("stokes_vvp_reference")


def curved_square(x, y):
    s = AMPLITUDE * np.sin(np.pi * x) * np.sin(np.pi * y)
    return x + s, y - s


@pytest.fixture
def fresh_tracer():
    """The process's tracer, off and empty before and after the test."""
    tracer.disable()
    tracer.reset()
    yield tracer
    tracer.disable()
    tracer.reset()


def _settings(mf, flow, linear_solver):
    model = flow.stokes_flow(with_divergence=False)
    return (
        mf.SystemSettings(model.system),
        mf.SolverSettings(
            mf.ConvergenceSettings(
                CONFIG["maximum_iterations"],
                CONFIG["absolute_tolerance"],
                CONFIG["relative_tolerance"],
            ),
            linear_solver=linear_solver,
        ),
    )


def _solve(mf, flow, linear_solver="schur_direct", n=3, p=6, recon_order=6, monkeypatch=None):
    """The configuration's solve on an n x n curved square at order p: the
    grids, the stats and, where ``monkeypatch`` is given, the solution
    vector handed to the reconstruction."""
    module = tsolve_mod if mf is tf else jsolve_mod
    captured = []
    if monkeypatch is not None:
        original = module.reconstruct_mesh_from_solution

        def capture(disc, order, solution, *args):
            captured.append(np.array(solution))
            return original(disc, order, solution, *args)

        monkeypatch.setattr(module, "reconstruct_mesh_from_solution", capture)
    mesh = mf.examples.unit_square_mesh(n, n, p, deformation=curved_square)
    on_cpu = {"device": "cpu"} if mf is tf else {}
    grids, stats, _ = mf.solve_system_2d(
        mesh, *_settings(mf, flow, linear_solver), recon_order=recon_order, **on_cpu
    )
    if monkeypatch is not None:
        monkeypatch.undo()
    return grids, stats, captured[-1] if captured else None


def rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / np.abs(ref).max())


def test_schur_direct_is_the_direct_solve(monkeypatch):
    _, schur_stats, schur = _solve(tf, tflow, "schur_direct", monkeypatch=monkeypatch)
    _, direct_stats, direct = _solve(tf, tflow, "direct", monkeypatch=monkeypatch)
    assert rel(schur, direct) <= 1e-10
    assert int(schur_stats.iter_history[-1]) == int(direct_stats.iter_history[-1]) == 1


def test_schur_direct_is_the_jax_packages(monkeypatch):
    _, jstats, jsol = _solve(jf, jflow, "schur_direct", monkeypatch=monkeypatch)
    _, tstats, tsol = _solve(tf, tflow, "schur_direct", monkeypatch=monkeypatch)
    assert tsol.shape == jsol.shape
    assert rel(tsol, jsol) <= 1e-10
    assert np.array_equal(tstats.iter_history, jstats.iter_history)
    assert int(tstats.n_total_dofs) == int(jstats.n_total_dofs)


@pytest.fixture(scope="module")
def grid_4x4_p10():
    grids, _, _ = _solve(tf, tflow, "schur_direct", n=4, p=10, recon_order=10)
    return grids[-1]


def _reading(grid, name: str) -> float:
    """The cell's number ``name`` for the grid, as ``benchmark/check.py``
    computes it: RMS error over the exact RMS, or the largest magnitude."""
    x, y = grid.points[:, 0], grid.points[:, 1]
    got = np.asarray(grid.point_data[name.rsplit("_", 1)[0]], np.float64)
    if name.endswith("_max"):
        return float(np.abs(got).max())
    want = REFERENCE.FIELDS[name[: -len("_rms")]](x, y)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2)))


@pytest.mark.parametrize("name", ["vel_rms", "vor_rms", "prs_max"])
def test_fields_are_within_the_cells_limits(grid_4x4_p10, name):
    """At 4x4 p=10 the discretization error is round-off, far below the
    cell's limits (set at 32x32 p=8 on the card)."""
    reading = _reading(grid_4x4_p10, name)
    assert np.isfinite(reading) and reading <= LIMITS[name] / 100, (name, reading)


def test_one_block_inverse_span_a_system(fresh_tracer, monkeypatch):
    """Each BlockSaddleSystem opens one ``block-inverse`` span, and every
    inverse and probe of its buckets runs inside it."""
    calls = []
    for name in ("gj_inverse", "choose_refine_rounds"):
        original = getattr(ti, name)

        def record(*args, _original=original, _name=name, **kwargs):
            out = _original(*args, **kwargs)
            calls.append((_name, time.perf_counter_ns()))
            return out

        monkeypatch.setattr(ti, name, record)
    fresh_tracer.enable()
    _solve(tf, tflow, "schur_direct")
    _solve(tf, tflow, "schur_direct")
    fresh_tracer.disable()
    spans = [s for s in fresh_tracer.spans if s.name == "block-inverse"]
    assert [s.path for s in spans] == ["factorize/block-inverse"] * 2
    assert len({s.solve for s in spans}) == 2
    assert fresh_tracer.stages["factorize/block-inverse"][0] == 2
    assert calls and len(calls) % 2 == 0
    for _, at in calls:
        assert any(s.start_ns <= at <= s.end_ns for s in spans)


def _element_system(n: int, p: int):
    """The discretization, element matrices and constraint matrix that a
    solve of the configuration assembles on an n x n curved square at p."""
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator, compute_linear_system

    system = tflow.stokes_flow(with_divergence=False).system
    mesh = tf.examples.unit_square_mesh(n, n, p, deformation=curved_square)
    disc = discretize_mesh(mesh, system.unknown_forms, FemCache(3), device="cpu")
    evaluator = SystemEvaluator(system.unknown_forms, CompiledSystem(system), disc)
    _, matrices, g, _ = compute_linear_system(disc, system, evaluator, [], [], None)
    return disc, matrices, g


def test_trace_lu_nonzeros_is_superlus_nnz(fresh_tracer):
    """The counter is SuperLU's ``nnz`` of the assembled trace, under the
    trace factorization's span: every entry its supernodes store, at least
    those of L (less its unit diagonal) and U."""
    fresh_tracer.enable()
    _, _, _ = _solve(tf, tflow, "schur_direct", n=4, p=4, recon_order=4)
    fresh_tracer.disable()
    counted = fresh_tracer.counters["picard-solve/schur-factor/superlu"]
    assert fresh_tracer.total("trace_lu_nonzeros") == counted["trace_lu_nonzeros"]
    assert counted["superlu_colamd"] == 1

    # The same trace, assembled again outside the solve.
    disc, matrices, g = _element_system(4, 4)
    schur = sp.csc_matrix(ti.BlockSaddleSystem(disc, matrices, g).assemble_schur_sparse())
    assert ti.trace_column_ordering(schur) == "COLAMD"
    lu = sla.splu(schur, permc_spec="COLAMD")
    assert counted["trace_lu_nonzeros"] == lu.nnz
    assert lu.nnz >= lu.L.nnz + lu.U.nnz - schur.shape[0]


def test_block_refine_rounds_are_recorded(fresh_tracer):
    """The probe's rounds, summed over the buckets, under the span."""
    disc, matrices, g = _element_system(3, 5)
    fresh_tracer.enable()
    saddle = ti.BlockSaddleSystem(disc, matrices, g, min_refine_rounds=2)
    fresh_tracer.disable()
    assert set(fresh_tracer.stages) == {"block-inverse"}
    rounds = fresh_tracer.counters["block-inverse"]["block_refine_rounds"]
    # The counter holds what the probe chose, not the floor every apply runs.
    assert rounds == 0 and saddle._refine_rounds == [2] * len(disc.buckets)


def test_tracing_changes_no_answer(fresh_tracer, monkeypatch):
    grids_off, _, off = _solve(tf, tflow, "schur_direct", monkeypatch=monkeypatch)
    fresh_tracer.enable()
    grids_on, _, on = _solve(tf, tflow, "schur_direct", monkeypatch=monkeypatch)
    fresh_tracer.disable()
    assert "factorize/block-inverse" in fresh_tracer.stages
    assert np.array_equal(on, off)
    for name, values in grids_off[-1].point_data.items():
        assert np.array_equal(grids_on[-1].point_data[name], values), name


DIRECT_PATHS = {
    "setup", "assembly+constraints", "factorize", "factorize/saddle-matrix",
    "factorize/superlu", "reconstruct", "picard-residual", "picard-solve",
    "solve+reconstruct",
}


def test_direct_solves_keep_their_paths(fresh_tracer):
    fresh_tracer.enable()
    _solve(tf, tflow, "direct")
    fresh_tracer.disable()
    assert set(fresh_tracer.stages) == DIRECT_PATHS
    names = {k for at in fresh_tracer.counters.values() for k in at}
    assert not names & {"block_refine_rounds", "trace_lu_nonzeros"}


def test_an_off_tracer_records_nothing(fresh_tracer):
    _solve(tf, tflow, "schur_direct")
    assert fresh_tracer.stages == {} and fresh_tracer.counters == {}


def test_the_adapter_is_the_configuration():
    """The benchmark's adapter hands ``solve_system_2d`` the configuration's
    system, convergence and the traffic's solver and reconstruction order."""
    adapter = _load("stokes_vvp")
    arguments = adapter.problem(CONFIG, {"linear_solver": "schur_direct", "recon_order": 6})
    kw = arguments(tf.examples.unit_square_mesh(2, 2, 3))
    assert set(kw) == {"system_settings", "solver_settings", "recon_order"}
    assert kw["recon_order"] == 6
    assert kw["solver_settings"].linear_solver == "schur_direct"
    conv = kw["solver_settings"].convergence
    assert (conv.maximum_iterations, conv.absolute_tolerance, conv.relative_tolerance) == (
        100, 1e-10, 0.0)
    # Vorticity a 0-form, velocity a 1-form, pressure a 2-form; no divergence.
    forms = tuple(kw["system_settings"].system.unknown_forms)
    assert forms == (("vor", 1), ("vel", 2), ("prs", 3))
    assert CONFIG["form_orders"] == [0, 1, 2] and CONFIG["reduced"] == []
