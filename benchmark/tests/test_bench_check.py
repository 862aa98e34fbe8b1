"""Fields held by magnitude: ``<field>_max`` for a field whose exact value is
zero, which reads infinite where the field is absent, NaN or of the wrong
length; the control's zeros for it; and such a field added by files alone
and judged through a whole run."""

import importlib
import json
import time

import numpy as np
import pytest
from test_bench_cpu import CASES, _copy_benchmark, add_by_files

import check
import control
import harness
import manifest
import manifest_rules as rules

TRAFFIC = {"mesh": 3, "recon_order": 4}
AMPLITUDE = 0.0613
POINTS = 9 * 25  # 3x3 elements, (recon_order + 1)^2 points each
XY = check.reference_points(TRAFFIC["mesh"], TRAFFIC["recon_order"], AMPLITUDE)
EXACT = manifest.load_module(manifest.HERE / "configs" / "mixed_poisson_reference.py").FIELDS


def _answer(**fields):
    return check.Answer(AMPLITUDE, XY, fields)


@pytest.mark.parametrize("shape", [(POINTS,), (POINTS, 2)])
def test_a_magnitude_field_reads_its_largest_size(shape):
    rng = np.random.default_rng(3)
    field = rng.uniform(-1e-11, 1e-11, shape)
    field.flat[17] = -4.5e-11
    out = check.readings(_answer(fine=field), TRAFFIC, {}, ("fine",))
    assert out == {"points_gap": 0.0, "fine_max": 4.5e-11}


UNSOUND = {
    "absent": {},
    "nan": {"fine": np.where(np.arange(POINTS) == 5, np.nan, 0.0)},
    "wrong_length": {"fine": np.zeros(POINTS - 1)},
    "a_scalar": {"fine": np.float64(0.0)},
}


@pytest.mark.parametrize("case", UNSOUND)
def test_a_magnitude_field_reads_inf_where_unsound(case):
    out = check.readings(_answer(**UNSOUND[case]), TRAFFIC, {}, ("fine",))
    assert out["fine_max"] == np.inf
    assert not check.judge(out, {"points_gap": 1e-12, "fine_max": 1e-9})


def test_no_magnitude_field_leaves_the_readings_as_they_were():
    answer = _answer(**{name: f(XY[:, 0], XY[:, 1]) * (1 + 1e-9) for name, f in EXACT.items()})
    out = check.readings(answer, TRAFFIC, EXACT)
    assert out == check.readings(answer, TRAFFIC, EXACT, ())
    assert set(out) == {"points_gap", "u_rms", "q_rms"}
    assert out["u_rms"] == pytest.approx(1e-9) and out["q_rms"] == pytest.approx(1e-9)


def test_the_control_gives_zeros_for_a_magnitude_field():
    control = check.control_answer(TRAFFIC, AMPLITUDE, EXACT, ("fine",))
    assert control.fields["fine"].dtype == np.float32
    assert control.fields["fine"].shape == (POINTS,) and not control.fields["fine"].any()
    limits = {"points_gap": 1e-12, "u_rms": 5e-9, "q_rms": 1.5e-8, "fine_max": 1e-9}
    values = check.readings(control, TRAFFIC, EXACT, ("fine",))
    assert values["fine_max"] == 0.0
    # The control still fails, on the closed-form fields.
    assert not check.judge(values, limits)
    assert values["u_rms"] > limits["u_rms"] and values["q_rms"] > limits["q_rms"]


@pytest.fixture
def vms_u(monkeypatch):
    """The program's grids carry a ``vms-u`` field of round-off size."""
    entry = importlib.import_module("mfv2d_torch.solve_system_2d")
    reconstruct = entry.reconstruct_mesh_from_solution

    def with_fine_scales(*args, **kwargs):
        grid = reconstruct(*args, **kwargs)
        grid.point_data["vms-u"] = np.full((grid.points.shape[0], 2), -3e-12)
        return grid

    monkeypatch.setattr(entry, "reconstruct_mesh_from_solution", with_fine_scales)


@pytest.mark.parametrize("produced", [True, False], ids=["produced", "never_produced"])
def test_a_magnitude_field_added_by_files_alone(tmp_path, request, produced):
    """A reference that names ``MAGNITUDE_FIELDS`` and a cell with a
    ``<field>_max`` limit, added by files: a run is correct where the
    program's grids carry the field within it, and not where they lack it;
    the cell's control is not correct either way."""
    case = CASES["direct"]
    _copy_benchmark(tmp_path)
    add_by_files(tmp_path, case)
    bench = tmp_path / "benchmark"
    reference = bench / "configs" / f"{case['config']}_reference.py"
    reference.write_text(reference.read_text() + '\nMAGNITUDE_FIELDS = ("vms-u",)\n')
    limits_file = bench / "workloads" / f"{case['cell']}.json"
    limits = json.loads(limits_file.read_text())
    limits["limits"]["vms-u_max"] = 1e-9
    limits_file.write_text(json.dumps(limits))
    rules.check(manifest.load_manifest(tmp_path), tmp_path)
    cell = manifest.load_cell(case["cell"], root=tmp_path)
    # The cell's control (benchmark/control.py) reads zeros there, and fails.
    values = control.control_values(cell, 5, 3)
    assert values["vms-u_max"] == 0.0 and not check.judge(values, cell.limits)
    if produced:
        request.getfixturevalue("vms_u")

    result = harness.run_cell(cell, 2147483659, 0.0, False, "cpu", time.perf_counter())
    reading = result["checks"]["vms-u_max"]
    assert reading["limit"] == 1e-9
    if produced:
        assert result["correct"] and reading["value"] == 3e-12
    else:
        assert not result["correct"] and reading["value"] == np.inf
        assert all(v["value"] <= v["limit"] for n, v in result["checks"].items() if n != "vms-u_max")
