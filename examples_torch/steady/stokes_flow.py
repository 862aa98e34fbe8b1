"""Steady Stokes flow in VVP form (ref: plot_stokes_flow.py)."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, l2_point_error, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import flow


def main():
    orders, errs = [], []
    for p in (2, 4, 6):
        model = flow.stokes_flow()
        mesh = mf.examples.unit_square_mesh(4, 4, p)
        sols, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(
                mf.ConvergenceSettings(absolute_tolerance=1e-10, relative_tolerance=0)
            ),
            recon_order=10,
            device=DEVICE,
        )
        grid = sols[-1]
        err_vel = l2_point_error(grid, "vel", flow.stokes_velocity_exact)
        report(
            f"stokes p={p}",
            err_vel=err_vel,
            err_vor=l2_point_error(grid, "vor", flow.stokes_vorticity_exact),
            div_max=float(np.abs(grid.point_data["div"]).max()),
        )
        orders.append(p)
        errs.append(err_vel)
    save_convergence_figure(orders, errs, __file__, ylabel="velocity L2 error",
                            title="Stokes flow: p-convergence")
    save_field_figure(grid, "vel", __file__, title="Stokes flow: |velocity|")
    save_field_figure(grid, "vor", __file__, title="Stokes flow: vorticity")


if __name__ == "__main__":
    main()
