"""Heat equation with a time-dependent source (TimeDependent forcing).

u(x, y, t) = sin(t) phi with phi = cos(pi x/2) cos(pi y/2) solves
u_t = alpha lap(u) + f for f = (cos t + alpha pi^2/2 sin t) phi.
Capability beyond the reference: its explicit terms are steady-only."""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf

ALPHA = 0.7
T_END = 1.0


def phi(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def source(x, y, t):
    return (np.cos(t) + ALPHA * np.pi**2 / 2 * np.sin(t)) * phi(x, y)


def main():
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(
        ALPHA * (v.derivative @ u.derivative) == v @ mf.TimeDependent(source),
    )
    dts, errs = [], []
    for nt in (8, 16, 32):
        mesh = mf.examples.unit_square_mesh(4, 4, 4)
        bc = mf.BoundaryCondition2DSteady(
            u, mesh.boundary_indices, lambda x, y: 0.0 * x
        )
        sols, _, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(system, boundary_conditions=[bc]),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
            time_settings=mf.TimeSettings(
                dt=T_END / nt, nt=nt, time_march_relations={v: u}
            ),
            recon_order=6,
            device=DEVICE,
        )
        g = sols[-1]
        err = np.max(
            np.abs(g.point_data["u"] - np.sin(T_END) * phi(g.points[:, 0], g.points[:, 1]))
        )
        report(f"forced_heat nt={nt:3d}", max_err=err)
        dts.append(T_END / nt)
        errs.append(float(err))
        if nt == 32:
            assert err < 2e-4
    save_convergence_figure(dts, errs, __file__, xlabel="dt", logx=True,
                            title="Forced heat: dt-convergence")
    save_field_figure(g, "u", __file__, title="Forced heat: u(T)")


if __name__ == "__main__":
    main()
