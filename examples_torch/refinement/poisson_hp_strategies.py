"""Direct Poisson: h-only vs p-only vs hp refinement strategies.

Covers the reference's pre/post refinement-strategy comparison scripts
(plot_direct_poisson_refined_pre.py, plot_direct_poisson_refined_post_p.py,
plot_direct_poison_post_hp.py): the same localized-bump problem refined with
the exact-error (explicit) estimator under three h/p trade-offs, printing
error-vs-DoF tables with observed algebraic convergence rates.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, l2_point_error, report, save_strategies_figure

import mfv2d_torch as mf


def u_exact(x, y):
    return np.exp(-16 * ((x - 0.3) ** 2 + (y + 0.2) ** 2)) + 0.05 * x


def source_exact(x, y):
    r2 = (x - 0.3) ** 2 + (y + 0.2) ** 2
    return (1024 * r2 - 64) * np.exp(-16 * r2)


def grad_u_flux(x, y):
    g = np.exp(-16 * ((x - 0.3) ** 2 + (y + 0.2) ** 2))
    gx = -32 * (x - 0.3) * g + 0.05
    gy = -32 * (y + 0.2) * g
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


def run_strategy(name: str, h_ratio: float, n_rounds: int = 5):
    system, u = make_system()
    mesh = mf.examples.unit_square_mesh(4, 4, 2)
    history = []
    for _ in range(n_rounds):
        bc = mf.BoundaryCondition2DSteady(u, mesh.boundary_indices, u_exact)
        settings = mf.RefinementSettings(
            error_estimate=mf.ErrorEstimateExplicit(
                u, u_exact, reconstruction_orders=(8, 8)
            ),
            refinement_limit=mf.RefinementLimitElementCount(0.3, 8),
            h_refinement_ratio=h_ratio,
            upper_order_limit=8,
        )
        sols, stats, mesh = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(system, boundary_conditions=[bc]),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
            refinement_settings=settings,
            recon_order=10,
            device=DEVICE,
        )
        err = l2_point_error(sols[-1], "u", u_exact)
        history.append((stats.n_total_dofs, err))
    print(f"-- strategy {name} (h_ratio={h_ratio}) --")
    prev = None
    for dofs, err in history:
        rate = ""
        if prev is not None and err > 0 and prev[1] > 0 and dofs != prev[0]:
            rate = f"  rate={np.log(prev[1] / err) / np.log(dofs / prev[0]):+.2f}"
        print(f"   dofs={dofs:6d}  L2={err:.4e}{rate}")
        prev = (dofs, err)
    return history


def main():
    hist_p = run_strategy("p-refine", 0.0)
    hist_hp = run_strategy("hp", 0.5)
    hist_h = run_strategy("h-refine", 100.0)
    report(
        "poisson_hp_strategies final",
        p_err=hist_p[-1][1],
        hp_err=hist_hp[-1][1],
        h_err=hist_h[-1][1],
    )
    save_strategies_figure(
        {"p-refine": hist_p, "hp": hist_hp, "h-refine": hist_h},
        __file__, title="Poisson hp strategies",
    )
    # Smooth-but-localized solution: p/hp must beat uniform-ish h-splitting.
    assert min(hist_p[-1][1], hist_hp[-1][1]) < hist_h[-1][1]


if __name__ == "__main__":
    main()
