#!/usr/bin/env python3
"""The JAX package's hp rounds for chip_smoke.py's phase 14, on the CPU.

Run from the repository root, where jax is installed:

    JAX_PLATFORMS=cpu python3 tools/hp_reference_rounds.py [--n 32] [--p 4] [--h 3e-7] [--rounds 3]

Solves the advection-diffusion system of examples/refinement/advdif_hp.py
on an n x n mesh at order p and refines it ``--rounds`` times with
phase 14's settings (the local-inverse estimator, ``order_increase`` 1,
``RefinementLimitElementCount(0.1, 128)``, ``upper_order_limit`` 8,
h refinement ratio ``--h``, ``linear_solver="direct"``, ``recon_order`` p),
then solves the last mesh once more.  For each solve it prints the element
orders, the unknowns and the L2 point error of u (what phase 14 pins in
``JAX_HP_ROUNDS`` and ``JAX_HP_FINAL``), and for each refinement how many
elements were split and p-raised, the smallest relative gap between
neighbouring error estimates at the refinement budget's cut, and the
smallest distance of a refined element's h-cost fraction from h: the
margins that keep a solve with other round-off refining the same elements.
"""

import argparse
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import mfv2d_tpu as mf  # noqa: E402
from mfv2d_tpu.models import transport  # noqa: E402

NU = -0.05


def wind(x, y):
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


def source(x, y):
    return np.sum(wind(x, y) * q_exact(x, y), axis=-1) - NU * np.pi**2 * u_exact(x, y) / 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=32)
    parser.add_argument("--p", type=int, default=4)
    parser.add_argument("--h", type=float, default=3e-7)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    model = transport.linear_advection_diffusion(NU, wind, u_exact, source)
    mesh = mf.examples.unit_square_mesh(args.n, args.n, args.p)
    for i in range(args.rounds + 1):
        refine = i < args.rounds
        settings = None
        if refine:
            settings = mf.RefinementSettings(
                mf.ErrorEstimateLocalInverse(model.u, 1),
                mf.RefinementLimitElementCount(0.1, 128),
                h_refinement_ratio=args.h,
                upper_order_limit=8,
            )
        grids, stats, out = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(mf.ConvergenceSettings(100, 1e-10, 0), linear_solver="direct"),
            refinement_settings=settings,
            recon_order=args.p,
        )
        grid = grids[-1]
        x, y = grid.points[:, 0], grid.points[:, 1]
        err = float(np.sqrt(np.mean((grid.point_data["u"] - u_exact(x, y)) ** 2)))
        label = f"round {i + 1}" if refine else "final mesh"
        print(f"{label}: ({stats.element_orders}, {stats.n_total_dofs}, {err!r})")
        if refine:
            estimate = grid.cell_data["error_estimate"]
            fraction = grid.cell_data["h_ref_cost_estimate"] / estimate
            order = np.flip(np.argsort(estimate))
            count = int(np.ceil(min(mesh.leaf_count * 0.1, 128)))
            refined = fraction[order[:count]]
            ranked = estimate[order]
            gap = np.abs(np.diff(ranked[count - 2 : count + 1])) / ranked[count - 1]
            split = int((refined <= args.h).sum())
            cost = grid.cell_data["h_ref_cost_estimate"]
            digest = (
                float(estimate.sum()), float(estimate.max()), float(cost.sum()), float(cost.max())
            )
            print(f"  estimates (sum, max; cost sum, max): {digest!r}")
            print(
                f"  refined {count}: split {split}, p-raised {count - split};"
                f" smallest relative gap at the cut {gap.min():.3e};"
                f" smallest |cost fraction - h| {np.abs(refined - args.h).min():.3e}"
                f" (h {args.h:g})"
            )
        mesh = out
    return 0


if __name__ == "__main__":
    sys.exit(main())
