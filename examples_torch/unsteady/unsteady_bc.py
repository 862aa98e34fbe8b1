"""Heat equation driven purely by time-dependent Dirichlet data.

u(x, y, t) = e^t cosh(x) satisfies u_t = lap(u) with no source, so all the
dynamics enters through BoundaryCondition2DUnsteady (a capability the
reference declares but never wires up, python/mfv2d/boundary.py).  Also
demonstrates periodic checkpointing + resume of the march."""

import sys
import tempfile
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
from examples_torch.common import DEVICE, report, save_convergence_figure, save_field_figure

import mfv2d_torch as mf


def exact(x, y, t):
    return np.exp(t) * np.cosh(x)


def main():
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = mf.KFormSystem(v.derivative @ u.derivative == 0 * (v @ u))
    T_END = 0.5

    def solve(nt, checkpoint_settings=None, mesh=None, full_nt=None):
        if mesh is None:
            mesh = mf.examples.unit_square_mesh(4, 4, 4)
        sols, _, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(
                system,
                boundary_conditions=[
                    mf.BoundaryCondition2DUnsteady(u, mesh.boundary_indices, exact)
                ],
                initial_conditions={u: lambda x, y: np.cosh(x)},
            ),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-11, 0)),
            time_settings=mf.TimeSettings(
                dt=T_END / (full_nt or nt), nt=nt, time_march_relations={v: u}
            ),
            recon_order=6,
            device=DEVICE,
            checkpoint_settings=checkpoint_settings,
        )
        return sols[-1]

    dts, errs = [], []
    for nt in (8, 16, 32):
        sol = solve(nt)
        err = np.max(
            np.abs(sol.point_data["u"] - exact(sol.points[:, 0], sol.points[:, 1], T_END))
        )
        report(f"unsteady-bc nt={nt:3d}", max_err=err)
        dts.append(T_END / nt)
        errs.append(float(err))
    save_convergence_figure(dts, errs, __file__, xlabel="dt", logx=True,
                            title="Unsteady BCs: dt-convergence")
    save_field_figure(sol, "u", __file__, title="Unsteady BCs: u(T)")

    # Checkpoint at step 16, then resume the same march to completion.
    from mfv2d_torch.checkpoint import load_march_state

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "march.npz")
        solve(16, mf.CheckpointSettings(ckpt, every=16), full_nt=32)
        state = load_march_state(ckpt)
        sol = solve(
            32,
            mf.CheckpointSettings(ckpt, every=16, resume_from=ckpt),
            mesh=state["mesh"],
        )
    err = np.max(
        np.abs(sol.point_data["u"] - exact(sol.points[:, 0], sol.points[:, 1], T_END))
    )
    report("resumed nt=32", max_err=err)
    assert err < 5e-5


if __name__ == "__main__":
    main()
