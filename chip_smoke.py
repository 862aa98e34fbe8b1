#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mfv2d_torch) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero):

0. card, power limit, torch/CUDA/nvcc versions; exit 1 without a GPU
1. build the M1 kernel (csrc/mass_edge.cu) for sm_90a
2. kernel vs its plain PyTorch version on the card, f64 and f32, and their
   median times at p=4, E=4096
3. the golden 4x4 p=3 mixed-Poisson solution on the card
4. the main path at size: steady mixed Poisson, 64x64 mesh, p=4
5. nonlinear Picard: steady Navier-Stokes Re=10, 16x16 mesh, p=5

The line before the last is the kernel report (JSON), the last line the
device summary (JSON).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
KERNEL_ORDERS = [(2, 2), (4, 4), (3, 5), (8, 8)]
KERNEL_SIZES = [1, 1000, 4096]
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def rel_err(mine, ref) -> float:
    return float((mine - ref).abs().max() / ref.abs().max())


def phase0_device() -> None:
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
        )
        print(smi.stdout.strip())
    else:
        print("nvidia-smi: not found")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one.", file=sys.stderr)
        sys.exit(1)
    from mfv2d_torch.ops.kernels import _build

    out = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout
    print("nvcc:", out.strip().splitlines()[-1])
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the f32 checks assume full float32.")
    torch.cuda.synchronize()
    print("phase 0: device", torch.cuda.get_device_name(0))


def phase1_build() -> None:
    from mfv2d_torch.ops.kernels import _build, mass_edge

    t0 = time.perf_counter()
    mass_edge.library()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"phase 1: built mass_edge.cu in {seconds:.2f} s")
    for line in _build.build_logs.get("mass_edge", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _kernel_inputs(orders, e, dtype, seed):
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.ops.mass import batch_jacobian, tensor_basis

    tb = tensor_basis(FemCache(3).get_basis2d(*orders))
    rng = np.random.default_rng(seed)
    corners = np.tile(BASE, (e, 1, 1)) + 0.08 * rng.normal(size=(e, 4, 2))
    jac = batch_jacobian(tb, torch.tensor(corners, device="cuda"))
    return tb, type(jac)(*(t.to(dtype).contiguous() for t in jac))


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase2_kernel_vs_plain() -> dict:
    from mfv2d_torch.ops import mass as plain
    from mfv2d_torch.ops.kernels import mass_edge

    max_abs = 0.0
    for dtype, tol in KERNEL_TOL.items():
        for orders in KERNEL_ORDERS:
            for e in KERNEL_SIZES:
                tb, jac = _kernel_inputs(orders, e, dtype, seed=e + 7 * orders[0])
                out = mass_edge.mass_edge(tb, jac)
                ref = plain.mass_edge(tb, jac)
                torch.cuda.synchronize()
                if out.shape != ref.shape or out.dtype != dtype:
                    raise RuntimeError(f"kernel output {out.shape} {out.dtype}")
                err = rel_err(out, ref)
                if dtype == torch.float64:
                    max_abs = max(max_abs, float((out - ref).abs().max()))
                print(f"  {str(dtype):14s} p={orders} E={e:5d} rel err {err:.3e}")
                if not err <= tol:
                    raise RuntimeError(f"kernel disagrees: {err:.3e} > {tol:.0e}")
    tb, jac = _kernel_inputs((4, 4), 4096, torch.float64, seed=1)
    ms = _median_ms(lambda: mass_edge.mass_edge(tb, jac))
    plain_ms = _median_ms(lambda: plain.mass_edge(tb, jac))
    torch.cuda.synchronize()
    print(
        f"phase 2: kernel agrees; p=(4, 4) E=4096 f64 median: kernel {ms:.4f} ms,"
        f" plain {plain_ms:.4f} ms"
    )
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def phase3_golden() -> None:
    import mfv2d_torch as mf
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import (
        FrozenSaddleSolver,
        SystemEvaluator,
        compute_linear_system,
        non_linear_solve_run,
    )

    def u_exact(x, y):
        return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def source_exact(x, y):
        return -(np.pi**2) / 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    system = mf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == q.weight ^ u_exact,
        u.weight @ q.derivative == -(u.weight @ source_exact),
    )
    mesh = mf.examples.unit_square_mesh(4, 4, 3)
    disc = discretize_mesh(mesh, system.unknown_forms, FemCache(2), device="cuda")
    evaluator = SystemEvaluator(disc.form_spec, CompiledSystem(system), disc)
    forcing, matrices, lagrange_mat, lagrange_vec = compute_linear_system(
        disc, system, evaluator, [], [], None
    )
    solver = FrozenSaddleSolver(evaluator.matrices_per_leaf(matrices), lagrange_mat)
    explicit_vec = np.concatenate((forcing, lagrange_vec))
    solution, _, _, _ = non_linear_solve_run(
        20, 1.0, 1e-12, 0.0, False, evaluator, explicit_vec,
        np.zeros(disc.n_dofs), np.zeros(lagrange_mat.shape[0]),
        float(np.abs(explicit_vec).max()), solver, lagrange_mat,
    )
    torch.cuda.synchronize()
    fixture = np.load(ROOT / "tests" / "golden" / "reference_fixtures.npz")
    ref = fixture["solution_mixed_poisson_4x4_p3"]
    err = float(np.abs(solution - ref).max() / np.abs(ref).max())
    print(f"phase 3: golden 4x4 p=3 mixed Poisson rel err {err:.3e}")
    if not err <= 1e-10:
        raise RuntimeError(f"golden solution disagrees: {err:.3e} > 1e-10")


def _l2_point_error(grid, name, exact) -> float:
    x, y = grid.points[:, 0], grid.points[:, 1]
    diff = grid.point_data[name] - exact(x, y)
    if diff.ndim > 1:
        diff = np.linalg.norm(diff, axis=-1)
    return float(np.sqrt(np.mean(diff**2)))


def phase4_main_path() -> int:
    import mfv2d_torch as mf
    from mfv2d_torch.models import poisson
    from mfv2d_torch.ops.kernels import mass_edge
    from mfv2d_torch.tracing import tracer

    model = poisson.mixed_poisson()
    mesh = mf.examples.unit_square_mesh(64, 64, 4)
    tracer.enable()
    tracer.reset()
    torch.cuda.reset_peak_memory_stats()
    mass_edge.launches = 0
    t0 = time.perf_counter()
    grids, stats, _ = mf.solve_system_2d(
        mesh, mf.SystemSettings(model.system), recon_order=4, device="cuda"
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mass_edge.launches
    tracer.disable()
    err = _l2_point_error(grids[-1], "u", poisson.u_exact)
    print(
        f"phase 4: mixed Poisson 64x64 p=4: {stats.n_total_dofs} unknowns"
        f" ({stats.n_lagrange} multipliers), {int(stats.iter_history[-1])} Picard"
        f" iterations, L2 point error {err:.3e}, wall {wall:.3f} s,"
        f" mass_edge launches {launches}"
    )
    for name in ("setup", "assembly+constraints", "factorize", "picard-residual", "picard-solve"):
        calls, total = tracer.stages.get(name, (0, 0.0))
        print(f"  stage {name:22s} {total:9.4f} s ({calls} calls)")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    if not err <= 1e-8:
        raise RuntimeError(f"mixed Poisson error {err:.3e} > 1e-8")
    if launches <= 0:
        raise RuntimeError("the main path did not launch the mass_edge kernel")
    return launches


def phase5_picard() -> None:
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow
    from mfv2d_torch.ops.kernels import mass_edge

    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(16, 16, 5)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    max_iter, atol = 80, 1e-8
    mass_edge.launches = 0
    t0 = time.perf_counter()
    grids, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(max_iter, atol, 0.0), relaxation=0.7
        ),
        recon_order=10,
        device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(stats.iter_history[-1])
    err = _l2_point_error(grids[-1], "vel", flow.ns_velocity_exact)
    print(
        f"phase 5: Navier-Stokes Re=10 16x16 p=5: {iters} Picard iterations,"
        f" velocity error {err:.3e}, wall {wall:.3f} s,"
        f" mass_edge launches {mass_edge.launches}"
    )
    if iters >= max_iter:
        raise RuntimeError("Navier-Stokes Picard did not converge")
    if not err <= 1e-8:
        raise RuntimeError(f"Navier-Stokes velocity error {err:.3e} > 1e-8")
    if mass_edge.launches <= 0:
        raise RuntimeError("the Picard path did not launch the mass_edge kernel")


def main() -> int:
    import mfv2d_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase0_device()
    phase1_build()
    timing = phase2_kernel_vs_plain()
    phase3_golden()
    launches = phase4_main_path()
    phase5_picard()
    report = {
        "kernels": [
            {
                "name": "mass_edge",
                "route": "cuda",
                "source": "mfv2d_torch/csrc/mass_edge.cu",
                "replaces": "mfv2d_tpu/ops/pallas_mass.py:113",
                "launches": launches,
                **timing,
            }
        ]
    }
    print(json.dumps(report))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
