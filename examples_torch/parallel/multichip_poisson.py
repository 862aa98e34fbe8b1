"""Multi-card steady solve through the main entry point.

Shards the element batch of a mixed Poisson solve over a ``torch.distributed``
device mesh via ``SolverSettings(device_mesh=...)``: assembly, the Picard
residual, and the trace-Schur Krylov all run element-sharded, with one
trace ``all_reduce`` per matvec.  Spawns one rank per visible card (one on
a single-card machine), each of which calls ``run`` alike; rank 0 reports.
"""

import sys
from pathlib import Path

_here = Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[2]))  # repo root for mfv2d_torch and examples_torch
import torch.distributed as dist
from examples_torch.common import (
    DEVICE, curved_square_deformation, l2_point_error, report, run_script, save_field_figure,
    spawn_ranks,
)

import mfv2d_torch as mf
from mfv2d_torch.models import poisson


def run(device_mesh):
    """Both solves on this rank's share of the elements."""
    devices = device_mesh.size()
    model = poisson.mixed_poisson()
    for p in (3, 4):
        mesh = mf.examples.unit_square_mesh(
            6, 6, p, deformation=curved_square_deformation
        )
        sols, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(
                mf.ConvergenceSettings(
                    absolute_tolerance=1e-10, relative_tolerance=0
                ),
                device_mesh=device_mesh,
            ),
            recon_order=10,
            device=DEVICE,
        )
        grid = sols[-1]
        if dist.get_rank() == 0:
            report(
                f"multichip_poisson p={p} devices={devices}",
                l2_u=l2_point_error(grid, "u", poisson.u_exact),
                h1_q=l2_point_error(grid, "q", poisson.grad_u_exact),
            )
    if dist.get_rank() == 0:
        save_field_figure(grid, "u", __file__, title="Multi-chip Poisson: u")


def main():
    spawn_ranks(run_script, __file__, "run")


if __name__ == "__main__":
    main()
