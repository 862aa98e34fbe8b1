"""Lid-driven cavity flow, unsteady NS (ref: plot_cavity_flow.py)."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import flow

RE = 25.0


def lid_velocity(x, y):
    """Unit velocity along the lid (y = +1), zero elsewhere."""
    on_lid = np.isclose(y, 1.0)
    return np.stack((np.where(on_lid, 1.0, 0.0), np.zeros_like(y)), axis=-1)


def main():
    model = flow.cavity_flow(RE, lid_velocity)
    mesh = mf.examples.unit_square_mesh(6, 6, 3)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, lid_velocity
    )
    sols, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(30, 1e-8, 0), relaxation=0.8
        ),
        time_settings=mf.TimeSettings(
            dt=0.25, nt=8, time_march_relations=model.time_march_relations
        ),
        recon_order=6,
        device=DEVICE,
    )
    sol = sols[-1]
    vel = sol.point_data["vel"]
    report(
        "cavity_flow",
        max_speed=float(np.max(np.linalg.norm(vel, axis=-1))),
        kinetic_energy=float(np.mean(np.sum(vel**2, axis=-1))),
    )
    assert np.all(np.isfinite(vel))
    save_field_figure(sol, "vel", __file__, title=f"Cavity flow Re={RE}: |velocity|")
    save_field_figure(sol, "vor", __file__, title=f"Cavity flow Re={RE}: vorticity")


if __name__ == "__main__":
    main()
