"""Multi-card VMS-stabilized nonlinear flow (BASELINE config-5 shape).

Runs the Burgers-type nonlinear flow with matrix-free fine-scale VMS
estimation fully element-sharded over a ``torch.distributed`` device mesh
(``mfv2d_torch.parallel.vms.sharded_vms_steady_solve``): fine and coarse
saddle systems, the fine advection operator, and all coarse<->fine
transfers are sharded; each trace matvec does one ``all_reduce``.  Spawns
one rank per visible card (one on a single-card machine), each of which
calls ``run`` alike; rank 0 reports.

Reference formulation: python/mfv2d/solve_system.py:654-961.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import numpy as np
import torch.distributed as dist
from examples_torch.common import DEVICE, report, run_script, save_field_figure, spawn_ranks

import mfv2d_torch as mf
from mfv2d_torch.models import transport
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.parallel.vms import sharded_vms_steady_solve
from mfv2d_torch.solve_system_2d import reconstruct_mesh_from_solution
from mfv2d_torch.solver.discretization import discretize_mesh

NU = -1.0


def u_exact(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def source_exact(x, y):
    qx = -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y)
    qy = -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y)
    return qx**2 + qy**2 - NU * np.pi**2 * u_exact(x, y) / 2


def run(device_mesh):
    """The sharded VMS solve on this rank's share of the elements."""
    devices = device_mesh.size()
    model = transport.nonlinear_flow(NU, u_exact, source_exact)
    u, q = model.u, model.q
    v, pw = u.weight, q.weight
    symmetric = mf.KFormSystem(
        pw.derivative @ u - pw @ q == pw ^ u_exact,
        NU * (v @ q.derivative) == -(v @ source_exact),
    )
    mesh = mf.examples.unit_square_mesh(4, 4, 4)
    disc = discretize_mesh(mesh, model.system.unknown_forms, FemCache(3), device=DEVICE)
    sol, lam, residuals, fine_scales = sharded_vms_steady_solve(
        model.system,
        mf.VMSSettings(
            symmetric_system=symmetric,
            nonsymmetric_system=model.system,
            order_increase=2,
            fine_scale_convergence=mf.ConvergenceSettings(10, 1e-10, 1e-8),
            matrix_free=True,
        ),
        disc,
        device_mesh,
        maximum_iterations=40,
        absolute_tolerance=1e-9,
    )
    grid = reconstruct_mesh_from_solution(disc, 6, sol)
    x, y = grid.points[:, 0], grid.points[:, 1]
    err = float(np.sqrt(np.mean((grid.point_data["u"] - u_exact(x, y)) ** 2)))
    if dist.get_rank() == 0:
        save_field_figure(grid, "u", __file__, title="sharded VMS solution u")
        report(
            f"multichip_vms 4x4 p=4+2 devices={devices}",
            l2_u=err,
            picard_iters=len(residuals),
            final_residual=float(residuals[-1]),
            max_fine_scale=float(np.abs(fine_scales).max()),
        )
    assert err < 1e-3 and np.isfinite(fine_scales).all()


def main():
    spawn_ranks(run_script, __file__, "run")


if __name__ == "__main__":
    main()
