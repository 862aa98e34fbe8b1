#!/usr/bin/env python3
"""The JAX package's VMS values for chip_smoke.py's phase 15, on the CPU.

Run from the repository root, where jax is installed:

    JAX_PLATFORMS=cpu python3 tools/vms_reference.py

Prints the constants that phase 15 pins, as Python literals:

- ``JAX_VMS_SMALL`` (phase 15a): bench_vms.py's nonlinear flow (nu = -1)
  on 8x8 at p=4 with order_increase 2, through the direct-LU and the
  matrix-free Green's operator: Picard iterations, the L2 point error of u
  and max |vms-u|;
- ``JAX_VMS_ESTIMATE`` (phase 15c): one hp round with ``ErrorEstimateVMS``
  on 8x8 at p=3 (+1) of the same flow with an asymmetric boundary value
  and source, so that no two estimates tie at the refinement cut: Picard
  iterations, unknowns, the leaves the round raised from (3, 3) to (4, 4)
  (by leaf rank; no leaf is split), the sum and largest
  value of ``error_estimate`` and ``h_ref_cost_estimate``, and the relative
  gap between the estimates on either side of the cut.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import mfv2d_tpu as mf  # noqa: E402
from mfv2d_tpu.models import transport  # noqa: E402

NU = -1.0


def u_exact(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def q_exact(x, y):
    return np.stack(
        (
            -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def source_exact(x, y):
    return np.sum(q_exact(x, y) ** 2, axis=-1) - NU * np.pi**2 * u_exact(x, y) / 2


def u_skew(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y) * np.exp(0.4 * x + 0.2 * y)


def source_skew(x, y):
    return np.exp(0.5 * x + 0.25 * y)


def systems(u_bc, source):
    model = transport.nonlinear_flow(NU, u_bc, source)
    u, q = model.u, model.q
    v, pw = u.weight, q.weight
    symmetric = mf.KFormSystem(
        pw.derivative @ u - pw @ q == pw ^ u_bc,
        NU * (v @ q.derivative) == -(v @ source),
    )
    return model, symmetric


def small_vms(matrix_free: bool):
    model, symmetric = systems(u_exact, source_exact)
    grids, stats, _ = mf.solve_system_2d(
        mf.examples.unit_square_mesh(8, 8, 4),
        mf.SystemSettings(model.system, over_integration_order=3),
        mf.SolverSettings(
            mf.ConvergenceSettings(40, 1e-9, 0), linear_solver="schur_direct", anderson_m=3
        ),
        vms_settings=mf.VMSSettings(
            symmetric_system=symmetric,
            nonsymmetric_system=model.system,
            order_increase=2,
            fine_scale_convergence=mf.ConvergenceSettings(10, 1e-10, 1e-8),
            matrix_free=matrix_free,
        ),
        recon_order=8,
    )
    g = grids[-1]
    x, y = g.points[:, 0], g.points[:, 1]
    err = float(np.sqrt(np.mean((g.point_data["u"] - u_exact(x, y)) ** 2)))
    return int(stats.iter_history[0]), err, float(np.abs(g.point_data["vms-u"]).max())


def vms_estimate():
    model, symmetric = systems(u_skew, source_skew)
    estimate = mf.ErrorEstimateVMS(model.u, symmetric, model.system, 1, 20, 1e-12, 1e-10)
    grids, stats, mesh = mf.solve_system_2d(
        mf.examples.unit_square_mesh(8, 8, 3),
        mf.SystemSettings(model.system, over_integration_order=3),
        mf.SolverSettings(mf.ConvergenceSettings(40, 1e-9, 0)),
        refinement_settings=mf.RefinementSettings(
            estimate, mf.RefinementLimitElementCount(0.1, 128)
        ),
        recon_order=4,
    )
    e = grids[-1].cell_data["error_estimate"]
    c = grids[-1].cell_data["h_ref_cost_estimate"]
    orders = [tuple(int(o) for o in mesh.get_leaf_orders(int(i))) for i in mesh.get_leaf_indices()]
    assert len(orders) == 64 and set(orders) == {(3, 3), (4, 4)}
    raised = [i for i, o in enumerate(orders) if o == (4, 4)]
    ranked = np.sort(e)[::-1]
    gap = float((ranked[len(raised) - 1] - ranked[len(raised)]) / ranked[len(raised) - 1])
    return {
        "iterations": int(stats.iter_history[0]),
        "unknowns": int(stats.n_total_dofs),
        "raised": raised,
        "digest": (float(e.sum()), float(e.max()), float(c.sum()), float(c.max())),
        "cut_gap": gap,
    }


def main() -> None:
    small = {name: small_vms(free) for name, free in (("direct LU", False), ("matrix-free", True))}
    print(f"JAX_VMS_SMALL = {small!r}")
    print(f"JAX_VMS_ESTIMATE = {vms_estimate()!r}")


if __name__ == "__main__":
    main()
