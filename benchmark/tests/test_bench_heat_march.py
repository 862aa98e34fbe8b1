"""The heat march cell at a size a test run holds: ``correct`` for the program
as it is, not for the float32 control, nor for the timed path broken in
each way of ``test_bench_faults``; and the readers of the march loop's
spans."""

import time

import pytest
from test_bench_faults import FAULTS, entry

import check
import harness
import manifest

CELL = "heat_64x64_p4_march16_direct"
MARCH_READERS = {
    "march_s": "march-step",
    "march_update_s": "march-step/picard-solve",
    "march_residual_s": "march-step/picard-residual",
    "march_carry_s": "march-step/carry",
    "march_frames_s": "march-step/reconstruct",
}


def _cell():
    """The cell's configuration, 16 steps and solver on 4x4 elements of p=10."""
    cell = manifest.load_cell(CELL)
    cell.traffic.update(mesh=4, order=10, recon_order=10)
    cell.config.update(mesh=4, orders=[10])
    return cell


def _run(cell, seed=5, trace=False):
    return harness.run_cell(cell, seed, 0.0, trace, "cpu", time.perf_counter())


def test_the_march_is_correct():
    result = _run(_cell())
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0


def test_the_control_is_not():
    cell = _cell()
    exact = manifest.reference(cell).FIELDS
    answers = [check.control_answer(cell.traffic, a, exact) for a in (0.05, 0.07, 0.0613)]
    values = check.worst([check.readings(x, cell.traffic, exact) for x in answers], cell.limits)
    assert not check.judge(values, cell.limits), values
    assert all(values[n] > cell.limits[n] for n in ("u_rms", "q_rms")), values


def _state_kept(run):
    """Each step hands back the state it was given (the eighth argument)."""

    def broken(*args, **kwargs):
        out = run(*args, **kwargs)
        return (args[7].copy(), *out[1:])

    return broken


# ``state_unchanged`` hands back the forcing, whose multiplier rows make it
# longer than the state: a steady solve ends there and is judged, while the
# march's next step refuses it, and the run ends with no result line.
RAISES = {"state_unchanged"}
MARCH_FAULTS = {**FAULTS, "state_kept": ("non_linear_solve_run", _state_kept)}


@pytest.mark.parametrize("fault", MARCH_FAULTS)
def test_a_broken_march_is_not(fault, monkeypatch):
    target, breaker = MARCH_FAULTS[fault]
    monkeypatch.setattr(entry, target, breaker(getattr(entry, target)))
    if fault in RAISES:
        with pytest.raises(ValueError, match="dimension mismatch"):
            _run(_cell())
        return
    result = _run(_cell())
    assert not result["correct"], result["checks"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def _hand_run(stages, solves=2):
    return harness.Run(config={}, traffic={}, solves=solves, first_solve_s=1.0,
                       mesh_seconds=0.0, stages=stages, peak_bytes=0)


def _read(name, run):
    return manifest.reader(manifest.load_cell(CELL), name).read(run)


def test_march_readers_on_a_run_by_hand():
    run = _hand_run({
        "factorize": (2, 8.0), "reconstruct": (2, 0.4),
        "march-step": (32, 20.0), "march-step/picard-solve": (32, 6.0),
        "march-step/picard-residual": (64, 3.0), "march-step/carry": (32, 1.0),
        "march-step/reconstruct": (32, 5.0),
    })
    assert _read("march_s", run) == pytest.approx(10.0)
    assert _read("march_update_s", run) == pytest.approx(3.0)
    assert _read("march_residual_s", run) == pytest.approx(1.5)
    assert _read("march_carry_s", run) == pytest.approx(0.5)
    assert _read("march_frames_s", run) == pytest.approx(2.5)


@pytest.mark.parametrize("name", MARCH_READERS)
def test_march_readers_give_nothing_without_their_stages(name):
    # A program without the march spans: the step's stages at the top.
    parent = _hand_run({"factorize": (2, 8.0), "picard-solve": (32, 6.0),
                        "picard-residual": (64, 3.0), "reconstruct": (34, 5.4)})
    assert _read(name, parent) is None
    assert _read(name, _hand_run({MARCH_READERS[name]: (0, 0.0)}, solves=0)) is None


def test_a_traced_march_reports_the_march_metrics():
    cell = _cell()
    result = _run(cell, seed=2147483659, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(MARCH_READERS) <= set(metrics)
    parts = sum(metrics[n]["value"] for n in MARCH_READERS if n != "march_s")
    assert 0 < parts <= metrics["march_s"]["value"]
    # No metric of the steady cells lists this one.
    listed = {m["name"] for m in cell.per_layer}
    assert listed == set(MARCH_READERS)
