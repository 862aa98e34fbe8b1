#!/usr/bin/env python3
"""The JAX package's sharded VMS value that tests/test_torch_parallel_vms.py pins.

Run from the repository root, where jax is installed (about 2.5 minutes on
one CPU core):

    JAX_PLATFORMS=cpu python3 tools/parallel_vms_reference.py

Runs the steady VMS solve of tests/test_torch_parallel_vms.py (the
nonlinear flow, nu = -1, 3x3 p=3, order_increase 2) through the JAX
package's ``solve_system_2d(device_mesh=...)`` on 8 virtual CPU devices,
and prints ``JAX_SHARDED_VMS`` as a Python literal: its residual
evaluations and max |vms-u|.  The sharded branch's ``vms-u`` is the dual
projection of the recovered fine scales, the single-device branch's that
of the unresolved-scale forcing, so the single-device solve cannot stand in
for it; the JAX package's sharded VMS solve is too slow on the CPU to run
in the tests.
"""

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]
import mfv2d_tpu as mf  # noqa: E402
from test_torch_parallel_vms import vms_solve  # noqa: E402


def main() -> None:
    mesh = Mesh(np.array(jax.devices())[:8], axis_names=("e",))
    out = vms_solve(mf, "3x3", mesh)
    print(
        "JAX_SHARDED_VMS = "
        + repr({"iterations": int(out["iters"][0]),
                "max_vms": float(np.abs(out["vms"]).max())})
    )


if __name__ == "__main__":
    main()
