"""The mixed heat march of the benchmark's ``heat_mixed_march`` configuration
against its closed form, and the march loop's spans and step counter.

The closed form (``benchmark/configs/heat_mixed_march_reference.py``) is
that of the discrete trapezoidal march: after nt steps from zero the fields
are (1 - r^nt) times the steady state, r = (1 - beta dt/2)/(1 + beta dt/2).
The port is held to it at 4x4 p=10, where the spatial error is far below
the cell's limits, on the curved square the cell draws its meshes from; the
JAX package's march is held to it at one of those sizes.

The tracer's part: whatever the linear solver, each step is a
``march-step`` span with the step's residuals, update solve, carry and
reconstruction under it, and one ``march_steps`` count; steady solves keep
the paths they had.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
from mfv2d_torch.models import poisson as tpoisson
from mfv2d_torch.tracing import tracer

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CELL = "heat_64x64_p4_march16_direct"
LIMITS = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "configs" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REFERENCE = _load("heat_mixed_march_reference")
CONFIG = REFERENCE.CONFIG
AMPLITUDE = 0.0613


def steady_u(x, y):
    return np.cos(np.pi * x / 2) * np.cos(np.pi * y / 2)


def curved_square(x, y):
    s = AMPLITUDE * np.sin(np.pi * x) * np.sin(np.pi * y)
    return x + s, y - s


def _march(mf, nt, n=4, p=10, recon_order=10, linear_solver="direct", **kw):
    """The configuration's march of ``nt`` steps to its end time through
    ``mf.solve_system_2d``."""
    transport = importlib.import_module(f"{mf.__name__}.models.transport")
    model = transport.heat_mixed(CONFIG["alpha"], CONFIG["beta"], steady_u)
    mesh = mf.examples.unit_square_mesh(n, n, p, deformation=curved_square)
    if mf is tf:
        kw["device"] = "cpu"
    return mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(
            mf.ConvergenceSettings(
                CONFIG["maximum_iterations"],
                CONFIG["absolute_tolerance"],
                CONFIG["relative_tolerance"],
            ),
            linear_solver=linear_solver,
        ),
        time_settings=mf.TimeSettings(
            dt=CONFIG["t_end"] / nt,
            nt=nt,
            time_march_relations=model.time_march_relations,
            sample_rate=CONFIG["sample_rate"],
        ),
        recon_order=recon_order,
        **kw,
    )


def _rms(grid, fields) -> dict:
    """Each field's RMS error over the grid's points over its exact RMS."""
    x, y = grid.points[:, 0], grid.points[:, 1]
    out = {}
    for name, field in fields.items():
        want = field(x, y)
        err = np.asarray(grid.point_data[name]) - want
        out[f"{name}_rms"] = float(np.sqrt(np.mean(err**2)) / np.sqrt(np.mean(want**2)))
    return out


def _picard_capped(nt: int, iterations: int) -> dict:
    """The fields where one step's Picard loop stops at its cap.

    The terms of u on the right of the system are explicit: the frozen
    factorization holds (2/dt) M + alpha div grad, the residual also
    -(beta - alpha pi^2/2) M u.  On the steady state's shape each Picard
    iteration multiplies the distance to the step's fixed point by
    rho = -(beta - alpha pi^2/2) / (2/dt + alpha pi^2/2).  At nt = 1 (dt =
    2, r = 0) rho = -0.820, and the loop's 20 iterations from zero leave
    u = (1 - rho^20) s, 1.9% short of the fixed point."""
    assert nt == 1
    alpha, beta, dt = CONFIG["alpha"], CONFIG["beta"], CONFIG["t_end"] / nt
    decay = alpha * np.pi**2 / 2
    rho = -(beta - decay) / (2 / dt + decay)
    f = REFERENCE.factor(beta, dt, nt)
    assert f == 1.0
    scale = 1 - rho**iterations
    return {name: (lambda x, y, g=g: scale * g(x, y)) for name, g in
            REFERENCE.fields(beta, CONFIG["t_end"], nt).items()}


@pytest.mark.parametrize("nt", [1, 4, 16])
def test_the_port_marches_to_the_closed_form(nt):
    grids, stats, _ = _march(tf, nt)
    assert len(grids) == nt + 1
    assert float(grids[-1].field_data["time"][0]) == pytest.approx(CONFIG["t_end"])
    if nt == 1:
        # The one step's Picard loop stops at its cap (see _picard_capped).
        assert stats.iter_history.tolist() == [CONFIG["maximum_iterations"]]
        fields = _picard_capped(nt, CONFIG["maximum_iterations"])
        assert _rms(grids[-1], REFERENCE.fields(CONFIG["beta"], CONFIG["t_end"], 1))[
            "u_rms"] > 1e-2
    else:
        assert (stats.iter_history < CONFIG["maximum_iterations"]).all()
        fields = REFERENCE.fields(CONFIG["beta"], CONFIG["t_end"], nt)
    readings = _rms(grids[-1], fields)
    for name, value in readings.items():
        assert value <= LIMITS[name], readings


def test_the_reference_is_the_cells():
    """FIELDS is the closed form at the configuration's nt and end time,
    and the discrete factor differs from the continuous one."""
    dt = CONFIG["t_end"] / CONFIG["nt"]
    assert CONFIG["nt"] == 16 and dt == 0.125
    f = REFERENCE.factor(CONFIG["beta"], dt, CONFIG["nt"])
    assert f == pytest.approx(0.865018, abs=1e-6)
    assert abs(f - (1 - np.exp(-2.0))) > 3e-4
    x, y = np.array([0.3, -0.7]), np.array([0.1, 0.45])
    assert np.allclose(REFERENCE.FIELDS["u"](x, y), f * steady_u(x, y), rtol=0, atol=1e-15)


def test_the_jax_package_marches_to_the_same_form():
    jf = pytest.importorskip("mfv2d_tpu")
    nt = 4
    grids, _, _ = _march(jf, nt, n=4, p=10, recon_order=10)
    readings = _rms(grids[-1], REFERENCE.fields(CONFIG["beta"], CONFIG["t_end"], nt))
    for name, value in readings.items():
        assert value <= LIMITS[name], readings


@pytest.fixture
def fresh_tracer():
    tracer.disable()
    tracer.reset()
    yield tracer
    tracer.disable()
    tracer.reset()


STEP_PATHS = {
    "march-step",
    "march-step/picard-residual",
    "march-step/picard-solve",
    "march-step/carry",
    "march-step/reconstruct",
}


def test_each_step_is_a_span_and_a_count(fresh_tracer):
    nt = 8
    plain, _, _ = _march(tf, nt, n=2, p=3, recon_order=3)
    fresh_tracer.enable()
    traced, stats, _ = _march(tf, nt, n=2, p=3, recon_order=3)
    fresh_tracer.disable()
    stages = fresh_tracer.stages

    assert STEP_PATHS <= set(stages)
    assert stages["march-step"][0] == nt
    assert stages["march-step/carry"][0] == nt
    assert stages["march-step/reconstruct"][0] == nt  # sample_rate 1
    assert stages["march-step/picard-solve"][0] == int(stats.iter_history.sum())
    # One residual an iteration, and one more where the step converged.
    converged = int((stats.iter_history < CONFIG["maximum_iterations"]).sum())
    assert converged == nt
    assert stages["march-step/picard-residual"][0] == int(stats.iter_history.sum()) + nt
    # Outside the steps: the set-up and the initial state's grid alone.
    assert stages["reconstruct"][0] == 1
    assert not {"picard-solve", "picard-residual", "carry"} & set(stages)
    assert fresh_tracer.total("march_steps") == nt
    assert fresh_tracer.counters["march-step"]["march_steps"] == nt
    # The steps sit inside the call, one after another.
    steps = [s for s in fresh_tracer.spans if s.path == "march-step"]
    assert all(s.parent is None and s.solve is not None for s in steps)
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))
    for s in fresh_tracer.spans:
        if s.path.startswith("march-step/"):
            (parent,) = [t for t in steps if t.id == s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    # The spans change no number.
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert np.array_equal(a.points, b.points)
        for name in a.point_data:
            assert np.array_equal(a.point_data[name], b.point_data[name])


def test_an_off_tracer_counts_no_step(fresh_tracer):
    _march(tf, 2, n=2, p=2, recon_order=2)
    assert fresh_tracer.stages == {} and fresh_tracer.total("march_steps") == 0


def test_a_dense_march_has_the_direct_step_spans(fresh_tracer):
    nt = 3
    steps = {}
    for linear_solver in ("direct", "dense"):
        fresh_tracer.reset()
        fresh_tracer.enable()
        _march(tf, nt, n=2, p=2, recon_order=2, linear_solver=linear_solver)
        fresh_tracer.disable()
        steps[linear_solver] = {
            path: calls
            for path, (calls, *_) in fresh_tracer.stages.items()
            if path.startswith("march-step")
        }
        assert STEP_PATHS <= set(steps[linear_solver])
        assert steps[linear_solver]["march-step"] == nt
        assert fresh_tracer.total("march_steps") == nt
        assert fresh_tracer.counters["march-step"]["march_steps"] == nt
    assert steps["dense"] == steps["direct"]


STEADY_PATHS = {
    "direct": {
        "setup", "assembly+constraints", "factorize", "factorize/saddle-matrix",
        "factorize/superlu", "reconstruct", "picard-residual", "picard-solve",
        "solve+reconstruct",
    },
    "schur_direct": {
        "setup", "assembly+constraints", "factorize", "factorize/block-inverse", "reconstruct",
        "picard-residual", "picard-solve", "picard-solve/schur-factor",
        "picard-solve/schur-factor/condense",
        "picard-solve/schur-factor/superlu", "picard-solve/inv-apply",
        "picard-solve/trace-solve", "solve+reconstruct",
    },
}


@pytest.mark.parametrize("linear_solver", sorted(STEADY_PATHS))
def test_steady_solves_keep_their_paths(fresh_tracer, linear_solver):
    fresh_tracer.enable()
    tf.solve_system_2d(
        tf.examples.unit_square_mesh(3, 3, 3),
        tf.SystemSettings(tpoisson.mixed_poisson().system),
        tf.SolverSettings(linear_solver=linear_solver),
        recon_order=3,
        device="cpu",
    )
    fresh_tracer.disable()
    assert set(fresh_tracer.stages) == STEADY_PATHS[linear_solver]
    assert fresh_tracer.total("march_steps") == 0


def test_the_adapter_marches():
    """The benchmark's adapter hands ``solve_system_2d`` the configuration's
    march on the traffic's solver."""
    adapter = _load("heat_mixed_march")
    arguments = adapter.problem(CONFIG, {"linear_solver": "direct", "recon_order": 3})
    kw = arguments(tf.examples.unit_square_mesh(2, 2, 3))
    assert set(kw) == {"system_settings", "solver_settings", "time_settings", "recon_order"}
    assert kw["time_settings"].nt == CONFIG["nt"]
    assert kw["time_settings"].dt == CONFIG["t_end"] / CONFIG["nt"]
    assert kw["time_settings"].sample_rate == CONFIG["sample_rate"]
    assert kw["solver_settings"].linear_solver == "direct"
