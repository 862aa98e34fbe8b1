"""Unsteady heat equation, mixed form (ref: plot_heat_mixed.py)."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import transport

ALPHA, BETA = 0.02, 1.0


def steady_u(x, y):
    return np.cos(np.pi * x / 2) * np.cos(np.pi * y / 2)


def main():
    model = transport.heat_mixed(ALPHA, BETA, steady_u)
    T_END = 2.0
    dts, errs = [], []
    for nt in (8, 16, 32):
        mesh = mf.examples.unit_square_mesh(6, 6, 3)
        sols, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
            time_settings=mf.TimeSettings(
                dt=T_END / nt,
                nt=nt,
                time_march_relations=model.time_march_relations,
            ),
            recon_order=8,
            device=DEVICE,
        )
        sol = sols[-1]
        t = float(sol.field_data["time"][0])
        exact = steady_u(sol.points[:, 0], sol.points[:, 1]) * (1 - np.exp(-BETA * t))
        err = float(np.sqrt(np.mean((sol.point_data["u"] - exact) ** 2)))
        report(f"heat_mixed nt={nt}", dt=T_END / nt, err=err)
        dts.append(T_END / nt)
        errs.append(err)
    save_convergence_figure(dts, errs, __file__, xlabel="dt", logx=True,
                            title="Heat (mixed): dt-convergence")
    save_field_figure(sol, "u", __file__, title="Heat (mixed): u(T)")


if __name__ == "__main__":
    main()
