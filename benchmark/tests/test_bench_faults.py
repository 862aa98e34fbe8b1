"""``correct`` at a size a test run holds: true for the program as it is;
false for the control (the reference in float32 in the program's place)
and for the timed path broken underneath in each way a cell can break.
One chip: no cell has an exchange between chips to leave out."""

import importlib
import time

import numpy as np
import pytest

import check
import harness
import manifest
entry = importlib.import_module("mfv2d_torch.solve_system_2d")

# Each cell's limits at sizes whose answers are within them: the cell's
# configuration and solver on a few elements of high order.
SMALL = {
    "poisson_64x64_p4_direct": {"mesh": 4, "order": 10, "recon_order": 10},
    "ns_32x32_p5_picard_direct": {"mesh": 3, "order": 12, "recon_order": 12},
}


def _cell(name):
    cell = manifest.load_cell(name)
    cell.traffic.update(SMALL[name])
    cell.config.update(mesh=cell.traffic["mesh"], orders=[cell.traffic["order"]])
    return cell


def _run(cell, seed=5):
    return harness.run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", SMALL)
def test_the_program_is_correct(name):
    result = _run(_cell(name))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", SMALL)
def test_the_control_is_not(name):
    cell = _cell(name)
    exact = manifest.reference(cell).FIELDS
    draws = iter([0.05, 0.07, 0.0613])
    answers = [check.control_answer(cell.traffic, a, exact) for a in draws]
    values = check.worst([check.readings(x, cell.traffic, exact) for x in answers], cell.limits)
    assert not check.judge(values, cell.limits), values
    fields = [n for n in values if n != "points_gap"]
    assert any(values[n] > cell.limits[n] for n in fields), values


def _unchanged(run):
    def broken(*args, **kwargs):
        out = run(*args, **kwargs)
        return (args[6].copy(), *out[1:])

    return broken


def _half_left_out(run):
    def broken(*args, **kwargs):
        solution, *rest = run(*args, **kwargs)
        solution = solution.copy()
        solution[solution.size // 2:] = 0.0
        return (solution, *rest)

    return broken


def _altered(run):
    def broken(*args, **kwargs):
        solution, *rest = run(*args, **kwargs)
        solution = solution.copy()
        solution[: max(1, solution.size // 64)] *= 1 + 1e-3
        return (solution, *rest)

    return broken


def _grid_of_half(reconstruct):
    def broken(*args, **kwargs):
        grid = reconstruct(*args, **kwargs)
        half = grid.points.shape[0] // 2
        grid.points = grid.points[:half]
        grid.point_data = {k: v[:half] for k, v in grid.point_data.items()}
        return grid

    return broken


FAULTS = {
    "state_unchanged": ("non_linear_solve_run", _unchanged),
    "half_left_out": ("non_linear_solve_run", _half_left_out),
    "answer_altered": ("non_linear_solve_run", _altered),
    "grid_of_half": ("reconstruct_mesh_from_solution", _grid_of_half),
}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", SMALL)
def test_a_broken_timed_path_is_not(name, fault, monkeypatch):
    target, breaker = FAULTS[fault]
    monkeypatch.setattr(entry, target, breaker(getattr(entry, target)))
    result = _run(_cell(name))
    assert not result["correct"], result["checks"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_points_are_the_programs():
    """The reference's points are the grid's, bit for bit, on the CPU."""
    import mfv2d_torch as mf
    from traffic import curved_square

    traffic = {"mesh": 3, "recon_order": 5}
    mesh = mf.examples.unit_square_mesh(3, 3, 2, deformation=curved_square(0.061))
    from mfv2d_torch.models import poisson

    grids, _, _ = mf.solve_system_2d(
        mesh, mf.SystemSettings(poisson.mixed_poisson().system), recon_order=5, device="cpu")
    ref = check.reference_points(traffic["mesh"], traffic["recon_order"], 0.061)
    assert np.array_equal(grids[-1].points[:, :2], ref)
