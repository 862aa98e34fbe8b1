"""Poisson equation in the direct formulation (ref: plot_direct_poisson.py).

0-form u with strong Dirichlet BCs and auxiliary 1-form q."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, curved_square_deformation, l2_point_error, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import poisson


def main():
    model = poisson.direct_poisson()
    orders, errs = [], []
    for p in range(1, 7):
        mesh = mf.examples.unit_square_mesh(
            6, 6, p, deformation=curved_square_deformation
        )
        bc = mf.BoundaryCondition2DSteady(
            model.u, mesh.boundary_indices, poisson.u_exact
        )
        sols, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system, boundary_conditions=[bc]),
            mf.SolverSettings(
                mf.ConvergenceSettings(absolute_tolerance=1e-10, relative_tolerance=0)
            ),
            recon_order=12,
            device=DEVICE,
        )
        grid = sols[-1]
        l2_u = l2_point_error(grid, "u", poisson.u_exact)
        report(f"direct_poisson p={p}", l2_u=l2_u)
        orders.append(p)
        errs.append(l2_u)
    save_convergence_figure(orders, errs, __file__, title="Direct Poisson: p-convergence")
    save_field_figure(grid, "u", __file__, title="Direct Poisson: u")


if __name__ == "__main__":
    main()
