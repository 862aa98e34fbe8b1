"""The Stokes cell at a size a test run holds: ``correct`` for the program as
it is, not for the float32 control, nor for the timed path broken in each
way of ``test_bench_faults``; the readers of its element inverses, its trace
factorization's fill and the streamed inverse's roofline; and the manifest
rules on the repo."""

import time
import types

import pytest
from conftest import ROOT
from test_bench_faults import FAULTS, entry

import check
import harness
import manifest
import manifest_rules
import roofline
from device_trace import Profile

CELL = "stokes_32x32_p8_schur_direct"
READERS = ("block_inverse_s", "trace_lu_nnz_m", "gj_streamed_roofline_pct")


def _cell():
    """The cell's configuration and solver on 4x4 elements of p=10, where
    the discretization error is round-off."""
    cell = manifest.load_cell(CELL)
    cell.traffic.update(mesh=4, order=10, recon_order=10)
    cell.config.update(mesh=4, orders=[10])
    return cell


def _run(cell, seed=5, trace=False, seconds=0.0):
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())


def test_the_cell_is_correct():
    result = _run(_cell(), seed=2147483659)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["checks"]) == {"points_gap", "vel_rms", "vor_rms", "prs_max"}
    assert set(result["metrics"]) == {"solve_s", "setup_s"}


def test_the_control_is_not():
    cell = _cell()
    exact, magnitude = manifest.judged_fields(cell)
    assert magnitude == ("prs",)
    answers = [check.control_answer(cell.traffic, a, exact, magnitude)
               for a in (0.05, 0.07, 0.0613)]
    values = check.worst([check.readings(x, cell.traffic, exact, magnitude) for x in answers],
                         cell.limits)
    assert not check.judge(values, cell.limits), values
    # The pressure's float32 zeros meet its limit: the closed-form fields fail.
    assert values["prs_max"] == 0.0
    assert all(values[n] > cell.limits[n] for n in ("vel_rms", "vor_rms")), values


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not(fault, monkeypatch):
    target, breaker = FAULTS[fault]
    monkeypatch.setattr(entry, target, breaker(getattr(entry, target)))
    result = _run(_cell())
    assert not result["correct"], result["checks"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def _hand_run(stages, solves=2, profile=None):
    return harness.Run(config={"form_orders": [0, 1, 2]}, traffic={"mesh": 32, "order": 8},
                       solves=solves, first_solve_s=1.0, mesh_seconds=0.0, stages=stages,
                       peak_bytes=0, profile=profile)


def _read(name, run):
    return manifest.reader(manifest.load_cell(CELL), name).read(run)


@pytest.fixture
def tracer():
    from mfv2d_torch.tracing import tracer

    tracer.disable()
    tracer.reset()
    yield tracer
    tracer.disable()
    tracer.reset()


def _profile(*kernels):
    return Profile(window_s=10.0, busy_s=1.0,
                   ops=[("kernel", name, 0.0, seconds) for name, seconds in kernels])


def test_readers_on_a_run_by_hand(tracer):
    tracer.enable()
    for _ in range(4):
        tracer.count("solves")
    with tracer.stage("picard-solve"):
        tracer.count("trace_lu_nonzeros", 30_000_000)
    tracer.count("trace_lu_nonzeros", 20_000_000)
    tracer.disable()
    run = _hand_run(
        {"factorize": (2, 0.5), "factorize/block-inverse": (2, 0.08)},
        profile=_profile(("gj_streamed_panel_kernel", 0.004), ("gj_streamed_update_kernel",
                         0.006), ("gj_streamed_unswap_kernel", 0.001), ("mass_edge", 0.5),
                         ("gj_inverse_blocked_kernel", 0.3)),
    )
    assert _read("block_inverse_s", run) == pytest.approx(0.04)
    # The tracer's solves, not the window's: 50 M entries over 4 solves.
    assert _read("trace_lu_nnz_m", run) == pytest.approx(12.5)
    # 1,024 blocks of n=289: 2 n^3 E operations at 67 TFLOP/s, over the
    # streamed kernels' 11 ms.
    bound = 2 * 289**3 * 1024 / roofline.FP64_FLOP_PER_S
    assert _read("gj_streamed_roofline_pct", run) == pytest.approx(100 * bound / 0.011)
    assert 6.0 < _read("gj_streamed_roofline_pct", run) < 7.0


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_their_stage_or_counter(name, tracer, monkeypatch):
    # The parent program's stages, a profile without the streamed route's
    # kernels, and a tracer that counted solves but no trace fill.
    tracer.enable()
    tracer.count("solves")
    tracer.disable()
    parent = _hand_run({"factorize": (2, 0.5), "picard-solve": (2, 8.0)},
                       profile=_profile(("gj_inverse_blocked_kernel", 0.3)))
    assert _read(name, parent) is None
    assert _read(name, _hand_run({"factorize/block-inverse": (0, 0.0)}, solves=0)) is None
    # A program whose tracer keeps no counters.
    monkeypatch.setattr("mfv2d_torch.tracing.tracer",
                        types.SimpleNamespace(enabled=False, stages={}, reset=lambda: None))
    assert _read(name, parent) is None


def test_a_traced_run_reports_exactly_the_new_metrics():
    cell = _cell()
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    result = _run(cell, seed=2147483659, trace=True, seconds=0.3)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    # No profile on the CPU: the roofline reads nothing there.
    assert set(metrics) == {"block_inverse_s", "trace_lu_nnz_m"}
    assert metrics["block_inverse_s"]["value"] > 0
    assert metrics["trace_lu_nnz_m"]["value"] > 0
    assert {k: v["unit"] for k, v in metrics.items()} == {"block_inverse_s": "s",
                                                          "trace_lu_nnz_m": "M"}


def test_manifest_rules_hold_on_the_repo():
    manifest_rules.check(manifest.load_manifest(), ROOT)
    # No metric of the other cells lists this one, and the new metrics
    # list it alone.
    m = manifest.load_manifest()
    for metric in m["per_layer"]:
        listed = metric.get("workloads", [])
        assert (CELL in listed) == (metric["name"] in READERS)
        if metric["name"] in READERS:
            assert listed == [CELL] and metric["moves"] == "solve_s"
