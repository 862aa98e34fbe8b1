"""Unsteady scalar reaction march (ref: plot_reaction.py)."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf
from mfv2d_torch.models import transport

ALPHA = 1.5


def final_u(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def main():
    model = transport.reaction(ALPHA, final_u)
    dts, errs = [], []
    for nt in (8, 16, 32, 64):
        mesh = mf.examples.unit_square_mesh(6, 6, 3)
        sols, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
            time_settings=mf.TimeSettings(
                dt=1.0 / nt, nt=nt, time_march_relations=model.time_march_relations
            ),
            recon_order=6,
            device=DEVICE,
        )
        sol = sols[-1]
        exact = final_u(sol.points[:, 0], sol.points[:, 1]) * (1 - np.exp(-ALPHA))
        err = float(np.max(np.abs(sol.point_data["u"] - exact)))
        report(f"reaction nt={nt}", err=err)
        dts.append(1.0 / nt)
        errs.append(err)
    save_convergence_figure(dts, errs, __file__, xlabel="dt", logx=True,
                            title="Reaction: dt-convergence")
    save_field_figure(sol, "u", __file__, title="Reaction: u(T)")


if __name__ == "__main__":
    main()
