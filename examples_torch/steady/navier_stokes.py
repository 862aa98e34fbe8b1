"""Steady Navier-Stokes with nonlinear advection (ref: plot_navier_stokes.py).

The reference runs Re=1000 with frozen-operator Picard; that iteration's
contraction limit makes moderate Re need under-relaxation."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, l2_point_error, report, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import flow


def main():
    RE = 10.0
    model = flow.navier_stokes(RE)
    mesh = mf.examples.unit_square_mesh(4, 4, 5)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    sols, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(
                maximum_iterations=80, absolute_tolerance=1e-8, relative_tolerance=0
            ),
            relaxation=0.7,
        ),
        recon_order=10,
        device=DEVICE,
    )
    grid = sols[-1]
    report(
        f"navier_stokes Re={RE} iters={int(stats.iter_history[-1])}",
        err_vel=l2_point_error(grid, "vel", flow.ns_velocity_exact),
        err_vor=l2_point_error(grid, "vor", flow.ns_vorticity_exact),
    )
    save_field_figure(grid, "vel", __file__, title=f"Navier-Stokes Re={RE}: |velocity|")
    save_field_figure(grid, "vor", __file__, title=f"Navier-Stokes Re={RE}: vorticity")


if __name__ == "__main__":
    main()
