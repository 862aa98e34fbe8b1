"""Advection-diffusion hp-refinement driven by fine-solve projection.

Reproduces the reference's heaviest example
(plot_advdif_post_hp_projection.py): a sharp Gaussian bump at (0.75, 0.75)
advected by a = (3x + y, x^2 - y^3) on a curved quadrilateral mesh, refined
with the *projection* strategy — each round re-solves the problem with all
element orders raised by dp and uses that fine solution as the error
estimate (no exact solution needed).  Three h/p trade-off strategies are
compared, printing error-vs-DoF tables with observed convergence rates.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, curved_square_deformation, l2_point_error, report, save_strategies_figure

import mfv2d_torch as mf

R = 40.0
T0 = 0.75


def s(t):
    return np.exp(-R * (t - T0) ** 2)


def dsdt(t):
    return -2 * R * (t - T0) * np.exp(-R * (t - T0) ** 2)


def d2sdt2(t):
    return 2 * R * (2 * R * (t - T0) ** 2 - 1) * np.exp(-R * (t - T0) ** 2)


def u_exact(x, y):
    return s(x) * s(y)


def q_exact(x, y):
    return np.stack((dsdt(x) * s(y), s(x) * dsdt(y)), axis=-1)


def adv_field(x, y):
    return np.stack((3 * x + y, x**2 - y**3), axis=-1)


def source_exact(x, y):
    return (s(x) * d2sdt2(y) + d2sdt2(x) * s(y)) + np.sum(
        adv_field(x, y) * q_exact(x, y), axis=-1
    )


def make_system():
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = mf.KFormSystem(
        p @ q + p.derivative @ u == p ^ u_exact,
        v @ q.derivative - ((adv_field * v) @ q) == v @ source_exact,
    )
    return system, u


def run_strategy(name: str, h_ratio: float, max_elements: int, n_rounds: int):
    system, u = make_system()
    mesh = mf.examples.unit_square_mesh(
        6, 6, 1, deformation=curved_square_deformation
    )
    history = []
    for _ in range(n_rounds):
        settings = mf.RefinementSettings(
            error_estimate=mf.ErrorEstimateFineSolve(u, order_increase=1),
            refinement_limit=mf.RefinementLimitElementCount(1.0, max_elements),
            h_refinement_ratio=h_ratio,
        )
        sols, stats, mesh = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(system),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
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
    # p-dominant, balanced hp, and h-dominant strategies (the reference
    # sweeps the same h_refinement_ratio axis).
    hist_p = run_strategy("p-refine", 0.0, 10, 6)
    hist_hp = run_strategy("hp", 0.5, 10, 6)
    hist_h = run_strategy("h-refine", 10.0, 10, 6)
    report(
        "advdif_hp_projection final",
        p_err=hist_p[-1][1],
        hp_err=hist_hp[-1][1],
        h_err=hist_h[-1][1],
    )
    save_strategies_figure(
        {"p-refine": hist_p, "hp": hist_hp, "h-refine": hist_h},
        __file__, title="Advection-diffusion hp strategies (projection)",
    )
    # The hp strategy must beat pure h-refinement at comparable DoF counts.
    assert hist_hp[-1][1] < hist_h[-1][1]


if __name__ == "__main__":
    main()
