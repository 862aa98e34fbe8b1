"""hp-refined advection-diffusion (ref: plot_advdif_post_hp_projection.py).

Sharp internal layer resolved by hp-refinement with the local-inverse
estimator.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_convergence_figure, save_field_figure

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
    mesh = mf.examples.unit_square_mesh(3, 3, 2)
    history = []
    for round_idx in range(4):
        settings = mf.RefinementSettings(
            error_estimate=mf.ErrorEstimateL2OrderReduction(model.u, 1),
            refinement_limit=mf.RefinementLimitUnknownCount(0.25, 400),
            h_refinement_ratio=0.3,
        )
        sols, stats, mesh = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(mf.ConvergenceSettings(100, 1e-10, 0)),
            refinement_settings=settings,
            recon_order=8,
            device=DEVICE,
        )
        grid = sols[-1]
        err = float(
            np.sqrt(
                np.mean(
                    (grid.point_data["u"] - u_exact(grid.points[:, 0], grid.points[:, 1]))
                    ** 2
                )
            )
        )
        report(
            f"advdif_hp round={round_idx}",
            err=err,
            dofs=stats.n_leaf_dofs,
            leaves=stats.n_leaves,
        )
        history.append((stats.n_leaf_dofs, err))
    save_convergence_figure([d for d, _ in history], [e for _, e in history],
                            __file__, xlabel="leaf DoFs", logx=True,
                            title="Advection-diffusion hp refinement")
    save_field_figure(grid, "u", __file__, title="Advection-diffusion: u (refined)")


if __name__ == "__main__":
    main()
