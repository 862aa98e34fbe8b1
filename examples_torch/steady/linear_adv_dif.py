"""Steady linear advection-diffusion (ref: plot_linear_adv_dif.py)."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, l2_point_error, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import transport

NU = -0.05


def a_field(x, y):
    return np.stack(((3 * y - x), (2 - y + 0 * x)), axis=-1)


def u_exact(x, y):
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def q_exact(x, y):
    return np.stack(
        (
            -np.pi * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def source_exact(x, y):
    return np.sum(a_field(x, y) * q_exact(x, y), axis=-1) - NU * np.pi**2 * u_exact(
        x, y
    ) / 2


def main():
    model = transport.linear_advection_diffusion(NU, a_field, u_exact, source_exact)
    orders, errs = [], []
    for p in (2, 3, 4, 5):
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
        l2_u = l2_point_error(sols[-1], "u", u_exact)
        report(f"linear_adv_dif p={p}", l2_u=l2_u)
        orders.append(p)
        errs.append(l2_u)
    save_convergence_figure(orders, errs, __file__,
                            title="Advection-diffusion: p-convergence")
    save_field_figure(sols[-1], "u", __file__, title="Advection-diffusion: u")


if __name__ == "__main__":
    main()
