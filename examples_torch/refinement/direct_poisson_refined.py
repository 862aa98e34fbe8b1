"""hp-refined direct Poisson (ref: plot_direct_poisson_refined_*.py).

Refines around a localized bump using the explicit estimator, then the
L2-order-reduction and local-inverse estimators, tracking error decay.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_strategies_figure

import mfv2d_torch as mf


def u_exact(x, y):
    return np.exp(-8 * (x**2 + y**2)) + 0.05 * x


def source_exact(x, y):
    r2 = x**2 + y**2
    return (256 * r2 - 32) * np.exp(-8 * r2)


def grad_u_flux(x, y):
    gx = -16 * x * np.exp(-8 * (x**2 + y**2)) + 0.05
    gy = -16 * y * np.exp(-8 * (x**2 + y**2))
    return np.stack((gy, -gx), axis=-1)


def make_system():
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = mf.KFormSystem(
        v.derivative @ u.derivative == -(v @ source_exact) + (v ^ grad_u_flux),
        p @ u.derivative - p @ q == 0,
        sorting=lambda f: f.order,
    )
    return system, u


def run(estimator_name: str, make_estimator):
    history = []
    system, u = make_system()
    mesh = mf.examples.unit_square_mesh(4, 4, 2)
    for round_idx in range(4):
        bc = mf.BoundaryCondition2DSteady(u, mesh.boundary_indices, u_exact)
        settings = mf.RefinementSettings(
            error_estimate=make_estimator(u),
            refinement_limit=mf.RefinementLimitElementCount(0.3, 6),
            h_refinement_ratio=0.3,
        )
        sols, stats, mesh = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(system, boundary_conditions=[bc]),
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
            f"{estimator_name} round={round_idx}",
            err=err,
            dofs=stats.n_leaf_dofs,
            leaves=stats.n_leaves,
        )
        history.append((stats.n_leaf_dofs, err))
    return history


def main():
    histories = {
        "explicit": run("explicit", lambda u: mf.ErrorEstimateExplicit(u, u_exact)),
        "order_reduction": run(
            "order_reduction", lambda u: mf.ErrorEstimateL2OrderReduction(u, 1)
        ),
        "local_inverse": run(
            "local_inverse", lambda u: mf.ErrorEstimateLocalInverse(u, 1)
        ),
    }
    save_strategies_figure(histories, __file__, xlabel="leaf DoFs",
                           title="Direct Poisson: estimator comparison")


if __name__ == "__main__":
    main()
