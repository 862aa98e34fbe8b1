"""Poisson equation in the mixed formulation (ref: plot_mixed_poisson.py).

Solves -lap(u) = f with u a 2-form and flux q a 1-form, weak BCs, and
reports p-convergence of the L2 and H1 errors on a curved mesh.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, curved_square_deformation, l2_point_error, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import poisson


def main():
    model = poisson.mixed_poisson()
    orders, errs = [], []
    for p in range(1, 7):
        mesh = mf.examples.unit_square_mesh(
            6, 6, p, deformation=curved_square_deformation
        )
        sols, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(
                mf.ConvergenceSettings(absolute_tolerance=1e-10, relative_tolerance=0)
            ),
            recon_order=12,
            device=DEVICE,
        )
        grid = sols[-1]
        l2_u = l2_point_error(grid, "u", poisson.u_exact)
        report(
            f"mixed_poisson p={p}",
            l2_u=l2_u,
            h1_q=l2_point_error(grid, "q", poisson.grad_u_exact),
        )
        orders.append(p)
        errs.append(l2_u)
    save_convergence_figure(orders, errs, __file__, title="Mixed Poisson: p-convergence")
    save_field_figure(grid, "u", __file__, title="Mixed Poisson: u")


if __name__ == "__main__":
    main()
