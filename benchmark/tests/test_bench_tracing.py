"""The readers of the program's spans inside the two host factorizations
and of its host-device byte counters: on a ``Run`` built by hand, on a
program whose tracer has no counters, and through a traced run of each
kind of cell at test size on the CPU."""

import time
import types

import pytest

import harness
import manifest

SPAN_READERS = ("superlu_s", "saddle_matrix_s", "schur_condense_s")
COUNTER_READERS = ("h2d_gb", "d2h_gb")
DIRECT, SCHUR = "poisson_64x64_p4_direct", "poisson_64x64_p8_schur_direct"


def _read(name, run, cell=DIRECT):
    return manifest.reader(manifest.load_cell(cell), name).read(run)


def _run(stages, solves=4):
    return harness.Run(config={}, traffic={}, solves=solves, first_solve_s=1.0,
                       mesh_seconds=0.0, stages=stages, peak_bytes=0)


@pytest.fixture
def tracer():
    from mfv2d_torch.tracing import tracer

    tracer.disable()
    tracer.reset()
    yield tracer
    tracer.disable()
    tracer.reset()


def test_span_readers_on_a_run_by_hand():
    direct = _run({"factorize": (4, 10.0), "factorize/saddle-matrix": (4, 2.0),
                   "factorize/superlu": (4, 7.0), "picard-solve": (4, 0.4)})
    assert _read("superlu_s", direct) == pytest.approx(7.0 / 4)
    assert _read("saddle_matrix_s", direct) == pytest.approx(2.0 / 4)
    assert _read("schur_condense_s", direct) is None
    schur = _run({"factorize": (4, 1.0), "picard-solve": (4, 34.0),
                  "picard-solve/schur-factor": (4, 32.0),
                  "picard-solve/schur-factor/condense": (4, 3.0),
                  "picard-solve/schur-factor/superlu": (4, 26.0),
                  "picard-solve/trace-solve": (4, 0.5)})
    assert _read("superlu_s", schur, SCHUR) == pytest.approx(26.0 / 4)
    assert _read("schur_condense_s", schur, SCHUR) == pytest.approx(3.0 / 4)
    assert _read("saddle_matrix_s", schur, SCHUR) is None
    # A Newton refactorization's SuperLU counts beside the first one.
    both = _run({"factorize/superlu": (2, 3.0), "picard-solve/superlu": (1, 1.0)}, solves=2)
    assert _read("superlu_s", both) == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_give_nothing_without_the_stages(name):
    # The parent program's stages: no span inside the factorizations.
    parent = _run({"factorize": (4, 10.0), "picard-solve": (4, 34.0),
                   "picard-solve/schur-factor": (4, 32.0)})
    assert _read(name, parent) is None
    assert _read(name, _run({"factorize/superlu": (0, 0.0)}, solves=0)) is None


def test_counter_readers_on_counts_by_hand(tracer):
    tracer.enable()
    for _ in range(3):
        tracer.count("solves")
    with tracer.stage("factorize"):
        tracer.count("h2d_bytes", 1_000_000_000)
        tracer.count("d2h_bytes", 2_400_000_000)
    tracer.count("h2d_bytes", 500_000_000)
    tracer.disable()
    run = _run({}, solves=2)  # the window's solves: the readers use the tracer's
    assert _read("h2d_gb", run) == pytest.approx(0.5)
    assert _read("d2h_gb", run) == pytest.approx(0.8)


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_readers_give_nothing_without_counters(name, tracer, monkeypatch):
    assert _read(name, _run({})) is None  # no solve counted
    # The parent program's tracer: stages and totals, no counters.
    parent = types.SimpleNamespace(enabled=False, stages={}, reset=lambda: None)
    monkeypatch.setattr("mfv2d_torch.tracing.tracer", parent)
    assert _read(name, _run({})) is None


# Each kind of cell at a test size, its configuration's solver kept.
SMALL = {DIRECT: {"mesh": 4, "order": 3, "recon_order": 3},
         SCHUR: {"mesh": 4, "order": 3, "recon_order": 3}}


@pytest.mark.parametrize("name", SMALL)
def test_a_traced_run_reports_the_new_metrics(name):
    cell = manifest.load_cell(name)
    cell.traffic.update(SMALL[name])
    cell.config.update(mesh=cell.traffic["mesh"], orders=[cell.traffic["order"]])
    result = harness.run_cell(cell, 2147483659, 0.3, True, "cpu", time.perf_counter())
    metrics = result["metrics"]
    expected = {m["name"] for m in cell.per_layer
                if m["name"] in SPAN_READERS + COUNTER_READERS}
    assert expected <= set(metrics)
    assert ("saddle_matrix_s" in metrics) == (name == DIRECT)
    assert ("schur_condense_s" in metrics) == (name == SCHUR)
    for key in expected:
        assert metrics[key]["value"] >= 0
    # No byte crosses on the CPU.
    assert metrics["h2d_gb"]["value"] == 0 and metrics["d2h_gb"]["value"] == 0
    # The factorization's children fit inside it.
    factorize = metrics["factorize_s"]["value"]
    if name == DIRECT:
        assert metrics["saddle_matrix_s"]["value"] + metrics["superlu_s"]["value"] <= factorize
