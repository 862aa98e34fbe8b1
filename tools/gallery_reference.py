#!/usr/bin/env python3
"""The JAX package's gallery measures and BASELINE config 3's errors, which
chip_smoke.py pins as JAX_GALLERY (phase 18) and JAX_CONFIG3 (phase 18b).

Run from the repository root, where jax is installed (about 4 minutes on
the CPU, 2.5 of them the sharded VMS script):

    JAX_PLATFORMS=cpu python3 tools/gallery_reference.py

Runs every script of the JAX package's gallery (``examples/``) on the CPU,
on one device, with its ``report`` calls recorded at full precision, and
prints ``JAX_GALLERY`` as a Python literal: by script, its report titles
and values in order.  Then solves config 3 as phase 18b does (the Stokes
flow in VVP form without the divergence unknown, 32x32, p=8,
``linear_solver="schur_direct"``, reconstructed at p) and prints
``JAX_CONFIG3``: its unknowns, Picard iterations, and the L2 point errors
of the velocity, the vorticity and the pressure (whose exact value is 0).
"""

import contextlib
import os
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]
os.environ["MFV2D_EXAMPLES_FIGURES"] = "0"
from gallery_harness import run_jax  # noqa: E402

CONFIG3_MESH, CONFIG3_ORDER = 32, 8


def gallery() -> dict:
    out = {}
    for path in sorted((ROOT / "examples").glob("*/*.py")):
        rel = str(path.relative_to(ROOT / "examples"))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the scripts' own prints
            reports, _ = run_jax(rel)
        print(f"# {rel}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        out[rel] = [[title, values] for title, values in reports]
    return out


def config3() -> dict:
    import mfv2d_tpu as mf
    from mfv2d_tpu.models import flow

    model = flow.stokes_flow(with_divergence=False)
    mesh = mf.examples.unit_square_mesh(CONFIG3_MESH, CONFIG3_MESH, CONFIG3_ORDER)
    sols, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(
            mf.ConvergenceSettings(absolute_tolerance=1e-10, relative_tolerance=0),
            linear_solver="schur_direct",
        ),
        recon_order=CONFIG3_ORDER,
    )
    grid = sols[-1]
    x, y = grid.points[:, 0], grid.points[:, 1]
    vel = grid.point_data["vel"] - flow.stokes_velocity_exact(x, y)
    return {
        "n_total_dofs": int(stats.n_total_dofs),
        "iterations": int(stats.iter_history[-1]),
        "err_vel": float(np.sqrt(np.mean(np.sum(vel**2, axis=-1)))),
        "err_vor": float(
            np.sqrt(np.mean((grid.point_data["vor"] - flow.stokes_vorticity_exact(x, y)) ** 2))
        ),
        "err_prs": float(np.sqrt(np.mean(grid.point_data["prs"] ** 2))),
    }


def main() -> None:
    # One device, as on a single-card machine: the multi-device scripts'
    # titles name it.
    if len(jax.devices()) != 1:
        raise SystemExit(f"run on one device, not {jax.devices()}")
    print(f"JAX_GALLERY = {gallery()!r}")
    print(f"JAX_CONFIG3 = {config3()!r}")


if __name__ == "__main__":
    main()
