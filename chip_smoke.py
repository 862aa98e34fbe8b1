#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mfv2d_torch) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py [--probe [inverse|mass|hp|vms|parallel|gallery|trsv]]

  --probe         phases 0, 1 and 6 only: build the kernels and hold the
                  batched inverse's routes against torch.linalg.inv, with
                  their times
  --probe mass    phases 0, 1 and 2 only: build the kernels and hold the M1
                  kernel against its plain version, with its times
  --probe hp      phases 0, 1 and 14 only: hp refinement on the card, with
                  both kernels timed at the refined mesh's buckets
  --probe vms     phases 0, 1 and 15 only: VMS on the card, BASELINE
                  config 5 among it, with both kernels held and timed at
                  every shape the phase launched them on
  --probe parallel  phases 0, 1, 16 and 17 only: the element-sharded
                  solver over torch.distributed, with the earlier phases
                  it compares with run again for their results
  --probe gallery  phases 0, 1, 18 and 18b only: the port's example
                  gallery and BASELINE config 3 on the card
  --probe trsv    phases 0 and 1, phase 12's 64x64 p=4 heat march, and
                  12b: the frozen LU's sweeps on the card against their
                  plain version, SciPy and the library, with their times

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero):

0. card, power limit, torch/CUDA/nvcc versions; exit 1 without a GPU
1. build the kernels (csrc/mass_edge.cu, csrc/gj_inverse.cu,
   csrc/sn_trsv.cu) for sm_90a, one nvcc each, started together; ptxas's
   registers and spills, and a failure if the register route of gj_inverse
   spills or a panel kernel has a stack frame
2. M1 kernel vs its plain PyTorch version on the card, f64 and f32, at
   orders on both sides of the 176 KB at which the basis table stops being
   resident in shared memory and is streamed (to p=16, and anisotropic),
   the panel route (batches too small to fill the card) at p=10, 12 and
   16 with E=1, 4, 16 and 64, and their median times beside the bound and
   one einsum over the stacked table and the metric (the library call) at
   p=4 and p=8 (E=4096), p=10 (E=1024, phase 10's E=256 and 16, and the
   VMS inclusion's E=1) and p=16 (E=1, 4, 16, 64) in f64: a call alone,
   and per call of ten back to back, each with its route and panel.  Every
   timed shape that a path launches (here and in phases 14 to 17) must be
   no slower than the einsum
3. the golden 4x4 p=3 mixed-Poisson solution on the card, through the
   direct, static-condensation, dense and Schur CG solvers
4. the main path at size: steady mixed Poisson, 64x64 mesh, p=4
5. nonlinear Picard: steady Navier-Stokes Re=10, 16x16 mesh, p=5
6. batched-inverse kernel vs its plain version on the card: saddle
   matrices and real element blocks, f64 and f32, every route that n
   chooses (register up to 64, blocked to 218, streamed above: one panel
   block to 1024, a cluster of them beyond, to n=2401), the cluster of 8
   blocks at n=3585 and 4096 and its rows spilled to L2 at n=4097 and
   5000 (one matrix each, with their times), odd n on the streamed route
   (219, 289, 1025, 1089; its work matrix of 16-byte rows) at an odd E and
   with the rows reversed, a singular batch on the register, blocked and
   streamed routes (at odd n too) and
   on the clustered panel, and median times beside torch.linalg.inv and
   the bound (each must beat torch.linalg.inv): n=56 (E=4096), the
   phase-9 blocks (n=121, E=256), n=208 (E=4096), n=289, 290 and n=460
   (E=1000), phase 10's Poisson blocks (n=320, E=256) and Navier-Stokes
   blocks (n=441, E=16), n=1056, 1089 and 1090 (E=16) and n=2401 (E=4),
   with the odd n=289 and 1089 beside the even n=290 and 1090; where
   a call of E <= 16 takes under 5 ms also ten calls back to back; the
   kernels one call launches, counted under torch.profiler
7. Schur CG at size: mixed Poisson 64x64 p=4, linear_solver="schur"
8. static condensation at size: mixed Poisson 64x64 p=8,
   linear_solver="schur_direct", then the same solve again, warm, under
   torch.profiler: the device busy time and the device time by name
9. nonlinear Picard through static condensation: phase 5's setup with
   linear_solver="schur_direct"
10. the main path on a streamed table: steady mixed Poisson, 16x16 mesh,
   p=10, linear_solver="schur_direct" (element blocks n=320), then
   Navier-Stokes Re=10, 4x4 mesh, p=10 the same way (blocks n=441); both
   on the inverse's streamed route
11. steady Newton: phase 5's Navier-Stokes with method="newton" through
   "direct" and "schur_direct", its iterations beside Picard's and the JAX
   package's; a Jacobian after warm-up launches no kernel; then the
   "dense" Newton at 8x8, p=5, with the dense saddle's bytes
12. time marches: BASELINE config 2, the mixed heat march on 64x64, p=4
   through "direct" (16 steps, error at t_end against the exact solution;
   then its first 4 steps again, warm, under torch.profiler); the "dense"
   linear march of the JAX bench's heat cell (16x16, p=4, 64 steps); and
   the lid-driven cavity on 16x16, p=4 by the "dense" Picard march and the
   "dense" Newton march, with iterations per step and walls.  The heat
   march's frozen solves after its first run on the card (sn_trsv): its
   launches are counted from 0 for that march and must be the launches of
   one solve times its card solves and the one run before the graph's
   capture
12b. the frozen LU of phase 12's heat march (n = 261,632) on the card:
   its sweeps (csrc/sn_trsv.cu) held against their plain version
   (supernodal.solve_plain, one right side) and SciPy's SuperLU (three) to
   1e-12, two solves of one right side bitwise equal; the schedule's build
   again with its time and its peak device memory beside the schedule's
   size; the median times of a solve on the card (graph replay, and the
   host's wall with the copies), of SciPy's and of torch.triangular_solve
   on the factors as sparse CSR (the library call), beside the bound (each
   non-zero's value read once)
13. the inverse's clustered panel and M1's panel route on a model:
   steady Navier-Stokes Re=10, 4x4 mesh, p=16, linear_solver="schur_direct"
   (element blocks n=1089, M1 at E=16), its Picard iterations against the
   JAX package's; then its first assembly once more, warm, under
   torch.profiler: host time, copies and device kernels by name
14. hp refinement: the gallery's advection-diffusion system on 32x32, p=4,
   three rounds of the local-inverse estimator ("direct"), each round's
   orders, unknowns, u error and error-estimate sums against the JAX
   package's, M1 launched inside the refinement stage; the final mesh
   solved by "direct" and "schur_direct" (agreeing to 1e-10, the u error
   to 1e-8 of the JAX package's); M1 held against its plain version and
   timed at every shape the phase launched it on (the estimator's fine
   batches at p+1 among them); round 1 again, warm, under torch.profiler;
   then the inverse timed at every bucket of the final mesh; each beside
   its plain version, library call and bound
15. VMS (bench_vms.py's nonlinear flow, nu = -1, "schur_direct", Anderson
   3, order_increase 2): (a) 8x8 p=4 through the direct-LU and the
   matrix-free Green's operator, iterations, u error and max |vms-u|
   against the JAX package's (tools/vms_reference.py); (b) BASELINE
   config 5, 64x64 p=8 (+2 fine, matrix-free) at full size: at most plain
   Picard's 17 iterations, u error <= 1e-11, max |vms-u| in (0, 1e-9],
   its wall, tracer stages and peak memory; (c) one hp round with
   ErrorEstimateVMS on 8x8 p=3 (+1), raised leaves and estimate sums
   against the JAX package's; then M1 and the inverse held against their
   plain versions and timed at every shape the phase launched them on
   (M1 at p=8 and p=10, the inverse at n=208 and n=320, E=4096, among
   them), beside the library call and the bound
16. the element-sharded steady solve over torch.distributed, its ranks
   spawned processes (start method spawn) in a process group with a
   timeout; a rank that fails, dies or hangs fails the run.  (a) 64x64
   p=8 mixed Poisson (phase 8's setup) at world size 1 on NCCL against
   phase 8's "schur_direct" solution (1e-8) with the trace CG's
   iterations, wall, tracer stages and peak memory; (b) the same at 2
   ranks (NCCL over two cards, else gloo with both ranks on cuda:0)
   against 16a, each rank launching both kernels at E=2048; (c) phase
   5's Navier-Stokes at 2 ranks through trace GMRES, cut after 6
   iterations and resumed from its checkpoint, its Picard updates adding
   up to phase 5's and its velocity within 1e-8 of phase 5's; (d) phase
   14's final hp mesh at 2 ranks (trace GMRES) against phase 14's
   "schur_direct" solution; (e) checkpoints: the linear heat march cut
   at 32 steps and resumed to 64 against an uninterrupted host march
   (1e-13) and phase 12's dense march (1e-10), phase 5's solve cut after
   6 iterations and resumed (17 in all, 1e-12), and 16c's files, the
   last of which resumes a world-size-1 run.  Every rank
   returns the same answer and counts one all_reduce per trace matvec;
   both kernels are then held and timed at 16b's per-rank shapes
17. the rest of the element-sharded solver, spawned as phase 16: (a)
   phase 11's Navier-Stokes by Newton at 2 ranks (trace GMRES), its
   corrections equal to phase 11's, its velocity within 1e-8 of phase
   11's "direct" one, each rank inverting its n=121 blocks once a Newton
   step; (b) BASELINE config 2's heat march (phase 12, 64x64 p=4, 16 steps)
   by the linear sharded march at 1 rank (NCCL) and 2 ranks (gloo), every
   sampled state within 1e-8 of phase 12's "direct" march and the error
   at t_end within 1e-8 of its; (c) phase 12's cavity (16x16 p=4, Re=25,
   GMRES) by the Picard march and the host Newton march at 2 ranks for
   P17_CAVITY_NT steps, iterations a step and the state against the
   single-device "dense" marches of the same steps; (d) 16e's linear heat march at 2 ranks
   cut at 32 steps and resumed to 64 (1e-12 from the uninterrupted 2-rank
   march), the single-device cut file resumed at 2 ranks and the 2-rank
   cut file on the single-device host loop (1e-10); (e) phase 14's first
   hp round at 2 ranks, its orders, unknowns, refined mesh and estimates
   as phase 14's, every rank's mesh alike; (f) VMS: 15a's setup at 2 ranks
   against 15a, and config 5's orders (p=8, +2) on P17_VMS_MESH at 1 rank
   against the single-device solve of the same setup.  Every rank returns
   the same answer, its all_reduce calls add up (all tagged, one a
   matvec, and where the solve fixes them the others too), and rank 0
   holds both kernels against their plain versions and times them at
   every shape the phase launched them on (not the estimator's)
18. the port's example gallery: every script of examples_torch/ (19) on the
   card at its own size, the single-card ones in this process, the
   multi-device ones on one spawned rank a card through the gallery's own
   spawn_ranks; each must finish, report the JAX gallery's titles with
   values within 1e-10 of the JAX package's on the CPU (1e-8 through
   Krylov solves; tools/gallery_reference.py), and launch the kernels its
   path runs; launches counted at the wrappers per script, then M1 and the
   inverse held against their plain versions and timed at every shape the
   scripts launched them on (an M1 shape slower than the einsum fails; the
   inverse is printed beside torch.linalg.inv)
18b. BASELINE config 3: the Stokes flow in VVP form on 32x32 at p=8 by
   "schur_direct" (n=289 blocks on the inverse's streamed route, M1 at p=8,
   E=1024), unknowns, iterations and errors against the JAX package's, its
   wall by tracer stage and peak device memory, both kernels held and timed
   at its shapes

The line before the last is the kernel report (JSON), the last line the
device summary (JSON).
"""

from __future__ import annotations

import argparse
import cProfile
import json
import importlib
import pstats
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from benchmark.roofline import bound_s

ROOT = Path(__file__).resolve().parent
BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
# The orders and batches that phases 3 to 13 give the kernel ((3, 3) at 16,
# (4, 4) and (8, 8) at 4096, (5, 5) at 256, (10, 10) at 256 and 16, (16, 16)
# at 16) among them.
KERNEL_ORDERS = [
    (2, 2), (3, 3), (4, 4), (3, 5), (5, 5), (8, 8), (9, 9), (10, 10), (12, 12), (16, 16),
    (9, 3),
]
KERNEL_SIZES = [1, 16, 256, 1000, 4096]
# Batches of the panel route, checked at p=10, 12 and 16.
PANEL_ORDERS = [(10, 10), (12, 12), (16, 16)]
PANEL_SIZES = [1, 4, 16, 64]
# Above p=8 the plain version's intermediates grow like p^4 per element.
KERNEL_MAX_BATCH_HIGH = 300
# Timed M1 shapes (orders, E), f64, and the path that launches each, whose
# launches the report puts beside it: the shapes of phases 4, 8, 10 and 13
# and of the VMS inclusion's reference element (phases 15b and 17f, which
# count its launches at its shape); None for shapes no path launches:
# phase 10's order at a batch that fills the card, p=16 at other batches.
KERNEL_TIMED = [
    ((4, 4), 4096, "phase 4"),
    ((8, 8), 4096, "phase 8"),
    ((10, 10), 1024, None),
    ((10, 10), 256, "phase 10 Poisson"),
    ((10, 10), 16, "phase 10 Navier-Stokes"),
    ((16, 16), 16, "phase 13"),
    ((16, 16), 1, None),
    ((16, 16), 4, None),
    ((16, 16), 64, None),
    ((10, 10), 1, "phases 15b and 17f"),
]
# What a timed shape's "launches_in" says where no path launches it; its
# "launches" is null.
TIMED_ONLY = "none (timed only)"
# The VMS inclusion's reference element, (p1, p2, nq, E): p=10 on 14 x 14
# quadrature points.
VMS_INCLUSION = [10, 10, 196, 1]
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# The streamed route's odd n sweep a work matrix of 16-byte rows: its first
# n (219) and the cluster's (1025), and config 3's and the p=16
# Navier-Stokes blocks' n (289, 1089) beside the even n + 1, which takes as
# many panels (290, 1090).
INVERSE_SIZES = [
    1, 16, 32, 33, 56, 64, 65, 121, 168, 170, 208, 219, 289, 290, 441, 460, 625, 1024, 1025,
    1056, 1089, 1090, 2401
]
# An odd E (37) puts every other input matrix of an odd n 8 bytes off 16.
INVERSE_BATCHES = [1, 37, 1000, 4096]
# One matrix each, past the sizes above: the streamed panel over a cluster
# of 8 blocks, then with its rows past 4,096 spilled to L2.
INVERSE_LARGE = [3585, 4096, 4097, 5000]
INVERSE_MAX_BATCH = {
    219: 1000, 289: 1000, 290: 1000, 441: 1000, 460: 1000, 625: 256, 1024: 64, 1025: 64,
    1056: 16, 1089: 16, 1090: 16, 2401: 4
}
# Timed inverse cases, each on the route its n takes: the p=4 blocks'
# size (phase 7), the real phase-9 batch, the p=8 blocks' sizes, n=460,
# the real phase-10 batches, and the sizes of the clustered panel: n=1056,
# the p=16 Navier-Stokes blocks' n=1089 (phase 13) and n=2401.
INVERSE_TIMED = [
    "saddle n=56 E=4096",
    "phase-9 blocks n=121 E=256",
    "saddle n=208 E=4096",
    "saddle n=289 E=1000",
    "saddle n=290 E=1000",
    "saddle n=460 E=1000",
    "phase-10 Poisson blocks n=320 E=256",
    "phase-10 blocks n=441 E=16",
    "saddle n=1056 E=16",
    "saddle n=1089 E=16",
    "saddle n=1090 E=16",
    "saddle n=2401 E=4",
]
# Odd n beside the even n + 1 (same panels, as much work): printed as
# pairs, with the ratio of their times.
INVERSE_PAIRS = [(289, 290), (1089, 1090)]
# The route each timed n takes in f64; every timed case must beat
# torch.linalg.inv.
INVERSE_ROUTES = {56: "register", 121: "blocked", 208: "blocked", 289: "streamed",
                  290: "streamed", 320: "streamed", 441: "streamed", 460: "streamed",
                  1056: "streamed", 1089: "streamed", 1090: "streamed", 2401: "streamed"}
INVERSE_TOL = {torch.float64: 1e-10, torch.float32: 1e-3}


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
    from mfv2d_torch.ops.kernels import _build, gj_inverse, mass_edge, supernodal

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(k.library) for k in (mass_edge, gj_inverse, supernodal)]
        for build in builds:
            build.result()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"phase 1: built mass_edge.cu, gj_inverse.cu and sn_trsv.cu in {seconds:.2f} s")
    register_entries = []
    for name in ("mass_edge", "gj_inverse", "sn_trsv"):
        entry = ""
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}:", line.strip())
            found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if found:
                entry = found.group(1)
            spills = re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line
            )
            if spills and "gj_inverse_register_kernel" in entry:
                register_entries.append(entry)
                if spills.group(2) != "0" or spills.group(3) != "0":
                    raise RuntimeError(f"the register route spills: {entry}: {line.strip()}")
            # The panel rows live in registers: a stack frame means they went
            # to local memory.
            panel = "gj_inverse_blocked_kernel" in entry or "gj_streamed_panel_kernel" in entry
            if spills and panel and spills.group(1) != "0":
                raise RuntimeError(f"a panel kernel has a stack frame: {entry}: {line.strip()}")
    if "gj_inverse" in _build.build_logs and not register_entries:
        raise RuntimeError("ptxas reported no register-route kernel")
    print(f"  register route: 0 spill bytes in {len(set(register_entries))} instantiations")


def _kernel_inputs(orders, e, dtype, seed, over=3):
    """Basis tables with ``over`` extra quadrature points a direction (the
    solver's default is 3) and the Jacobian terms of ``e`` perturbed squares."""
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.ops.mass import batch_jacobian, tensor_basis

    tb = tensor_basis(FemCache(over).get_basis2d(*orders))
    rng = np.random.default_rng(seed)
    corners = np.tile(BASE, (e, 1, 1)) + 0.08 * rng.normal(size=(e, 4, 2))
    jac = batch_jacobian(tb, torch.tensor(corners, device="cuda"))
    return tb, type(jac)(*(t.to(dtype).contiguous() for t in jac))


def _median_ms(fn, reps: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` calls back
    to back, per call.  With one call the host's part of the call counts in
    full; with several it hides behind the device's, as in a loop."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def phase2_kernel_vs_plain() -> list[dict]:
    from mfv2d_torch.ops import mass as plain
    from mfv2d_torch.ops.kernels import mass_edge

    card = mass_edge.card(torch.device("cuda", 0))
    print(f"  M1's launch plans take the card as {card}")
    for dtype, tol in KERNEL_TOL.items():
        # Phase 3 integrates with 2 extra points, every other path with 3.
        for orders, over in [((3, 3), 2), *((orders, 3) for orders in KERNEL_ORDERS)]:
            sizes = KERNEL_SIZES
            if max(orders) > 8:
                sizes = sorted({min(e, KERNEL_MAX_BATCH_HIGH) for e in sizes})
            if orders in PANEL_ORDERS:
                sizes = sorted({*sizes, *PANEL_SIZES})
            if over != 3:
                sizes = [16]
            for e in sizes:
                tb, jac = _kernel_inputs(orders, e, dtype, seed=e + 7 * orders[0], over=over)
                plan = mass_edge.launch_plan(
                    tb.bh.shape[0], tb.bv.shape[0], tb.w.size, dtype, e, card
                )
                if orders in PANEL_ORDERS and e in PANEL_SIZES and plan.route != "panel":
                    raise RuntimeError(f"p={orders} E={e} does not take the panel route")
                out = mass_edge.mass_edge(tb, jac)
                ref = plain.mass_edge(tb, jac)
                torch.cuda.synchronize()
                if out.shape != ref.shape or out.dtype != dtype:
                    raise RuntimeError(f"kernel output {out.shape} {out.dtype}")
                err = rel_err(out, ref)
                print(
                    f"  {str(dtype):14s} p={orders} +{over} E={e:5d} rel err {err:.3e}"
                    f" ({_route(plan)})"
                )
                if not err <= tol:
                    raise RuntimeError(f"kernel disagrees: {err:.3e} > {tol:.0e}")
                del out, ref
    timed = []
    for orders, e, path in KERNEL_TIMED:
        tb, jac = _kernel_inputs(orders, e, torch.float64, seed=1)
        timed.append(
            _time_mass_edge(tb, jac, f"p={orders[0]} E={e}", path or TIMED_ONLY,
                            phase=2, on_path=path is not None)
        )
    return timed


def _route(plan) -> str:
    """A launch plan's route, in words."""
    if plan.route == "panel":
        rows, cols = plan.panel
        return (
            f"panel route, panels of {rows}x{cols} warp tiles of {plan.mr}x{plan.nc} blocks,"
            f" {len(plan.tiles)} an element, stages of {plan.chunk} points"
        )
    table = "resident" if plan.stages == 1 else f"streamed in chunks of {plan.chunk}"
    return f"element route, table {table}, {plan.group} elements a step"


def m1_library_call(tb, jac):
    """M1's library call: one einsum over the stacked 1-form table
    phi[i, q, a] (bh in component 0, bv in component 1) and the
    [E, nq, 2, 2] metric, which it takes as given (the kernel forms the
    metric from the Jacobian terms itself)."""
    from mfv2d_torch.ops import mass as plain

    k_hh, k_vv, k_hv = plain._edge_metric(jac, tb.w)
    metric = torch.stack([k_hh, k_hv, k_hv, k_vv], dim=-1).unflatten(-1, (2, 2))
    bh, bv = plain.as_like(tb.bh, k_hh), plain.as_like(tb.bv, k_hh)
    phi = bh.new_zeros((bh.shape[0] + bv.shape[0], bh.shape[1], 2))
    phi[: bh.shape[0], :, 0] = bh
    phi[bh.shape[0] :, :, 1] = bv
    return lambda: torch.einsum("iqa,eqab,jqb->eij", phi, metric, phi)


def _time_mass_edge(
    tb, jac, shape: str, path: str, phase: int, plain_max=None, on_path: bool = True
) -> dict:
    """M1 through the wrapper on f64 inputs, held against its plain version,
    with its median times beside the plain version, one einsum (the library
    call) and the bound.  With ``plain_max`` the plain version, whose
    intermediates grow like p^4 an element, runs on that many elements
    only: the kernel and the einsum on all of them.  A shape that a path
    launches (``on_path``) fails the run where the kernel is slower than
    the einsum."""
    from mfv2d_torch.ops import mass as plain
    from mfv2d_torch.ops.kernels import mass_edge

    e = jac.det.shape[0]
    k = e if plain_max is None else min(e, plain_max)
    jac_plain = type(jac)(*(t[:k] for t in jac))
    plan = mass_edge.launch_plan(
        tb.bh.shape[0], tb.bv.shape[0], tb.w.size, torch.float64, e,
        mass_edge.card(jac.det.device),
    )
    # Through the wrapper (plan, output allocation, launch): one call
    # alone, with the host's part; ten calls back to back beside it.
    ms = _median_ms(lambda: mass_edge.mass_edge(tb, jac))
    back_to_back_ms = _median_ms(lambda: mass_edge.mass_edge(tb, jac), calls=10)
    plain_ms = _median_ms(lambda: plain.mass_edge(tb, jac_plain), reps=10)
    library_call = m1_library_call(tb, jac)
    library_ms = _median_ms(library_call, reps=10)
    out = mass_edge.mass_edge(tb, jac)
    ref = plain.mass_edge(tb, jac_plain)
    library = library_call()
    torch.cuda.synchronize()
    n1, nq = out.shape[1], jac.det.shape[1]
    out_bytes = (out.numel() + sum(t.numel() for t in jac)) * out.element_size()
    out, library = out[:k], library[:k]
    max_abs = float((out - ref).abs().max())
    err = rel_err(out, ref)
    library_err = rel_err(library, ref)
    if not max(err, library_err) <= KERNEL_TOL[torch.float64]:
        raise RuntimeError(f"kernel or einsum disagrees: {err:.3e}, {library_err:.3e}")
    # The least work: every output written and every Jacobian term read
    # once; by the symmetry of M1, n1 (n1 + 1) / 2 sums of nq products.
    bound, bound_by = bound_s(out_bytes, e * n1 * (n1 + 1) * nq)
    bound_ms = bound * 1e3
    print(
        f"phase {phase}: kernel agrees; M1 {shape} f64 median: kernel {ms:.4f} ms"
        f" ({back_to_back_ms:.4f} ms per call of ten back to back),"
        f" plain {plain_ms:.4f} ms" + (f" (first {k} elements)" if k < e else "")
        + f", library einsum {library_ms:.4f} ms,"
        f" bound {bound_ms:.4f} ms ({bound_by}); {_route(plan)}, warp tile"
        f" {plan.mr}x{plan.nc}, {plan.warps} warps, {plan.smem_bytes} bytes of shared memory"
    )
    if on_path and not ms <= library_ms:
        raise RuntimeError(
            f"M1 {shape}, launched in {path}: the kernel ({ms:.4f} ms) is slower than"
            f" the einsum ({library_ms:.4f} ms)"
        )
    return {
        "shape": shape,
        "m1_route": plan.route,
        **({"panel": list(plan.panel)} if plan.route == "panel" else {}),
        "launches_in": path,
        "max_abs_err": max_abs,
        "ms": ms,
        "ms_back_to_back": back_to_back_ms,
        "plain_ms": plain_ms,
        **({"plain_elements": k} if k < e else {}),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def phase3_golden() -> None:
    import mfv2d_torch as mf
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.iterative import DenseSaddleSolver, IterativeSaddleSolver
    from mfv2d_torch.solver.solve import (
        ConvergenceSettings,
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
    n_lag = lagrange_mat.shape[0]
    explicit_vec = np.concatenate((forcing, lagrange_vec))
    inner = ConvergenceSettings(max(200, 4 * (disc.n_dofs + n_lag)), 1e-15, 1e-12)
    solvers = {
        "direct": (
            lambda: FrozenSaddleSolver(evaluator.matrices_per_leaf(matrices), lagrange_mat),
            1e-10,
        ),
        "schur_direct": (
            lambda: IterativeSaddleSolver(
                disc, matrices, lagrange_mat, inner, method="schur_direct"
            ),
            1e-10,
        ),
        "dense": (lambda: DenseSaddleSolver(disc, matrices, lagrange_mat), 1e-10),
        "schur": (
            lambda: IterativeSaddleSolver(disc, matrices, lagrange_mat, inner, method="schur"),
            1e-8,
        ),
    }
    fixture = np.load(ROOT / "tests" / "golden" / "reference_fixtures.npz")
    ref = fixture["solution_mixed_poisson_4x4_p3"]
    for name, (make, tol) in solvers.items():
        solution, _, _, _, _ = non_linear_solve_run(
            20, 1.0, 1e-12, 0.0, False, evaluator, explicit_vec,
            np.zeros(disc.n_dofs), np.zeros(n_lag),
            float(np.abs(explicit_vec).max()), make(), lagrange_mat,
        )
        torch.cuda.synchronize()
        err = float(np.abs(solution - ref).max() / np.abs(ref).max())
        print(f"phase 3: golden 4x4 p=3 mixed Poisson, {name}: rel err {err:.3e}")
        if not err <= tol:
            raise RuntimeError(f"golden solution ({name}) disagrees: {err:.3e} > {tol:.0e}")


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

    def solve():
        out = mf.solve_system_2d(mesh, mf.SystemSettings(model.system), recon_order=4, device="cuda")
        torch.cuda.synchronize()
        return out

    tracer.enable()
    tracer.reset()
    torch.cuda.reset_peak_memory_stats()
    mass_edge.launches = 0
    t0 = time.perf_counter()
    grids, stats, _ = solve()
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
    _require_no_uploads(4, "the solve again, warm", solve)
    return launches


def _navier_stokes(
    linear_solver: str, n: int = 16, p: int = 5, method: str = "picard", max_err: float = 1e-8
):
    """Phase 5's Navier-Stokes solve (or its setup on another mesh and
    order, or by Newton, which takes full steps); returns iterations,
    velocity error, wall, the solve's statistics and its last grid."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow

    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(n, n, p)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    max_iter, atol = 80, 1e-8
    t0 = time.perf_counter()
    grids, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(max_iter, atol, 0.0),
            relaxation=0.7 if method == "picard" else 1.0,
            linear_solver=linear_solver,
            method=method,
        ),
        recon_order=max(10, p),
        device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(stats.iter_history[-1])
    err = _l2_point_error(grids[-1], "vel", flow.ns_velocity_exact)
    if iters >= max_iter:
        raise RuntimeError(f"Navier-Stokes {method} ({linear_solver}) did not converge")
    if not err <= max_err:
        raise RuntimeError(f"Navier-Stokes velocity error {err:.3e} > {max_err:.0e}")
    return iters, err, wall, stats, grids[-1]


def phase5_picard() -> int:
    from mfv2d_torch.ops.kernels import mass_edge

    mass_edge.launches = 0
    iters, err, wall, _, grid = _navier_stokes("direct")
    REFERENCES["phase 5"] = (iters, err, grid)
    print(
        f"phase 5: Navier-Stokes Re=10 16x16 p=5: {iters} Picard iterations,"
        f" velocity error {err:.3e}, wall {wall:.3f} s,"
        f" mass_edge launches {mass_edge.launches}"
    )
    if mass_edge.launches <= 0:
        raise RuntimeError("the Picard path did not launch the mass_edge kernel")
    _require_no_uploads(5, "the solve again, warm", lambda: _navier_stokes("direct"))
    return iters


def _saddle_pool(n: int, count: int, seed: int) -> np.ndarray:
    """``count`` saddle matrices ``[[M, B^T], [B, 0]]`` of size n: M SPD with
    eigenvalues in [1, 10], B of full row rank with singular values in
    [1, 3].  Every other one is symmetrically permuted, so the zero block's
    diagonal entries land anywhere."""
    rng = np.random.default_rng(seed)
    n_b = n // 3
    n_m = n - n_b
    out = np.empty((count, n, n))
    for c in range(count):
        q, _ = np.linalg.qr(rng.normal(size=(n_m, n_m)))
        m = (q * rng.uniform(1.0, 10.0, n_m)) @ q.T
        v, _ = np.linalg.qr(rng.normal(size=(n_m, n_m)))
        b = rng.uniform(1.0, 3.0, n_b)[:, None] * v[:n_b]
        k = np.block([[m, b.T], [b, np.zeros((n_b, n_b))]])
        if c % 2:
            perm = rng.permutation(n)
            k = k[perm][:, perm]
        out[c] = k
    return out


def _element_blocks(model_system, mesh) -> np.ndarray:
    """The first bucket's element matrices of a steady system on the card."""
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator

    compiled = CompiledSystem(model_system)
    disc = discretize_mesh(mesh, model_system.unknown_forms, FemCache(3), device="cuda")
    evaluator = SystemEvaluator(disc.form_spec, compiled, disc)
    return evaluator.element_matrices(compiled.lhs_blocks)[0]


def _kernel_launches(fn, part: str) -> tuple[dict[str, int], int]:
    """The device kernels whose name holds ``part`` that one call of ``fn``
    launched, by name, as torch.profiler's device trace counts them, and
    the number of profiler sessions that took.

    Late in a long process (phase 14) the device trace loses every event
    of some calls, torch's own kernels and copies as well as the wrapper's,
    where early on (phase 6) it sees them all; a warm-up step recovers
    most of them.  So each session has a warm-up step, whose calls it
    throws away, before the one call it counts, and a session that saw
    nothing is repeated, up to three times.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    for session in range(1, 4):
        torch.cuda.synchronize()
        events = []
        with profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda done: events.extend(done.key_averages()),
        ) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        counts = {}
        for ev in events:
            if ev.device_type == torch.autograd.DeviceType.CUDA and part in ev.key:
                name = re.search(r"(\w*gj_\w+)", ev.key)
                key = name.group(1) if name else ev.key
                counts[key] = counts.get(key, 0) + ev.count
        if counts:
            break
    return counts, session


def phase6_inverse_vs_plain() -> dict:
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow, poisson
    from mfv2d_torch.ops.kernels import gj_inverse
    from mfv2d_torch.ops.precision import gj_inverse_plain

    cases = {}
    for n in INVERSE_SIZES:
        pool = torch.tensor(
            _saddle_pool(n, min(16, INVERSE_MAX_BATCH.get(n, 16)), seed=n), device="cuda"
        )
        cond = float(torch.linalg.cond(pool).max())
        plan = gj_inverse.launch_plan(n, torch.float64)
        route32 = gj_inverse.route(n, torch.float32)
        layout = ""
        if plan.route == "streamed":
            layout = (
                f" ({plan.panel} columns, {plan.blocks} panel blocks, {plan.spill} spilled,"
                f" rows {plan.ld} apart)"
            )
        print(
            f"  saddle n={n:3d}: max cond {cond:.3e}, route f64 {plan.route}{layout},"
            f" f32 {route32}"
        )
        if not cond <= 1e4:
            raise RuntimeError(f"saddle inputs too ill-conditioned: {cond:.3e}")
        for e in INVERSE_BATCHES:
            e = min(e, INVERSE_MAX_BATCH.get(n, e))
            reps = -(-e // pool.shape[0])
            cases[f"saddle n={n} E={e}"] = pool.repeat(reps, 1, 1)[:e].contiguous()
    poisson_blocks = _element_blocks(
        poisson.mixed_poisson().system, mf.examples.unit_square_mesh(64, 64, 4)
    )
    ns_blocks = _element_blocks(
        flow.navier_stokes(10.0).system, mf.examples.unit_square_mesh(16, 16, 5)
    )
    poisson10_blocks = _element_blocks(
        poisson.mixed_poisson().system, mf.examples.unit_square_mesh(16, 16, 10)
    )
    ns10_blocks = _element_blocks(
        flow.navier_stokes(10.0).system, mf.examples.unit_square_mesh(4, 4, 10)
    )
    for name, blocks in (
        ("phase-7 blocks", poisson_blocks),
        ("phase-9 blocks", ns_blocks),
        ("phase-10 Poisson blocks", poisson10_blocks),
        ("phase-10 blocks", ns10_blocks),
    ):
        print(f"  {name}: {blocks.shape}, cond of block 0 {np.linalg.cond(blocks[0]):.3e}")
        cases[f"{name} n={blocks.shape[1]} E={blocks.shape[0]}"] = torch.tensor(
            blocks, device="cuda"
        )

    max_abs = 0.0
    for dtype, tol in INVERSE_TOL.items():
        for name, a64 in cases.items():
            a = a64.to(dtype)
            out = gj_inverse.gj_inverse(a)
            ref = gj_inverse_plain(a)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                raise RuntimeError(f"kernel output {out.shape} {out.dtype}")
            err = rel_err(out, ref)
            if dtype == torch.float64:
                max_abs = max(max_abs, float((out - ref).abs().max()))
            print(f"  {str(dtype):14s} {name:36s} rel err {err:.3e}")
            if not err <= tol:
                raise RuntimeError(f"inverse kernel disagrees: {err:.3e} > {tol:.0e}")

    # The clustered panel's largest layouts, one matrix each: a cluster of 8
    # blocks from n=3585, and from n=4097 on the rows past 4,096 spilled
    # to L2 (one row at 4097, 113 rows a block at 5000).  The pool's
    # construction bounds its condition number, which the sizes above check.
    for n in INVERSE_LARGE:
        a64 = torch.tensor(_saddle_pool(n, 1, seed=n), device="cuda")
        plan = gj_inverse.launch_plan(n, torch.float64)
        for dtype, tol in INVERSE_TOL.items():
            a = a64.to(dtype)
            ref = gj_inverse_plain(a)
            err = rel_err(gj_inverse.gj_inverse(a), ref)
            ms = _median_ms(lambda: gj_inverse.gj_inverse(a), reps=3, warmup=1)
            library_ms = _median_ms(lambda: gj_inverse_plain(a), reps=3, warmup=1)
            bound, bound_by = bound_s(2 * a.numel() * a.element_size(), 2 * n**3)
            bound_ms = bound * 1e3
            print(
                f"  {str(dtype):14s} n={n} E=1, {plan.panel} columns, {plan.blocks} panel"
                f" blocks, {plan.spill} rows a block spilled to L2: rel err {err:.3e};"
                f" kernel {ms:.4f} ms, torch.linalg.inv {library_ms:.4f} ms,"
                f" bound {bound_ms:.4f} ms ({bound_by})"
            )
            if not err <= tol:
                raise RuntimeError(f"inverse kernel disagrees: {err:.3e} > {tol:.0e}")
        del a64, a, ref

    # At odd n on the streamed route, the rows reversed, so that each panel
    # swaps rows, at an odd E.
    for n in (219, 289, 1025, 1089):
        e = min(37, INVERSE_MAX_BATCH[n])
        a64 = cases[f"saddle n={n} E={e}"].flip(1).contiguous()
        for dtype, tol in INVERSE_TOL.items():
            a = a64.to(dtype)
            err = rel_err(gj_inverse.gj_inverse(a), gj_inverse_plain(a))
            torch.cuda.synchronize()
            print(f"  {str(dtype):14s} saddle n={n} E={e}, rows reversed: rel err {err:.3e}")
            if not err <= tol:
                raise RuntimeError(f"inverse kernel disagrees: {err:.3e} > {tol:.0e}")

    for n in (56, 121, 208, 219, 289, 460, 1025, 1089):
        for dtype in INVERSE_TOL:
            e = min(1000, INVERSE_MAX_BATCH.get(n, 1000))
            singular = cases[f"saddle n={n} E={e}"][:8].to(dtype).clone()
            singular[5, :, 17] = 0.0
            try:
                gj_inverse.gj_inverse(singular)
            except torch.linalg.LinAlgError as exc:
                print(f"  singular batch n={n} {gj_inverse.route(n, dtype)} ({dtype}) raised: {exc}")
                if "matrix 5 " not in str(exc) or " pivot 18 " not in str(exc):
                    raise RuntimeError("the singular batch named the wrong pivot") from exc
            else:
                raise RuntimeError("a singular batch did not raise")

    # The plain version is torch.linalg.inv, the one library call that
    # computes the same function: its time is both plain_ms and library_ms.
    routes = [_time_inverse(cases[name], name, phase=6) for name in INVERSE_TIMED]
    for timed in routes:
        want = INVERSE_ROUTES[timed["n"]]
        if timed["route"] != want:
            raise RuntimeError(f"n={timed['n']} takes the {timed['route']} route, not {want}")
        if not timed["ms"] < timed["library_ms"]:
            raise RuntimeError(f"the {want} route does not beat torch.linalg.inv: {timed}")
    by_n = {timed["n"]: timed for timed in routes}
    pairs = []
    for odd, even in INVERSE_PAIRS:
        pair = {"odd": odd, "even": even, "E": by_n[odd]["E"], "odd_ms": by_n[odd]["ms"],
                "even_ms": by_n[even]["ms"], "ratio": by_n[odd]["ms"] / by_n[even]["ms"]}
        print(
            f"phase 6: odd n={odd} against even n={even} (E={pair['E']}, as many panels):"
            f" {pair['odd_ms']:.4f} against {pair['even_ms']:.4f} ms, ratio {pair['ratio']:.4f}"
        )
        pairs.append(pair)
    first = routes[0]
    return {
        "max_abs_err": max_abs,
        "ms": first["ms"],
        "plain_ms": first["library_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "routes": routes,
        "odd_even_pairs": pairs,
    }


def _time_inverse(a: torch.Tensor, name: str, phase: int) -> dict:
    """gj_inverse on an f64 batch: median times beside torch.linalg.inv (its
    plain version and library call) and the bound, with the kernels one call
    launches as torch.profiler counts them."""
    from mfv2d_torch.ops.kernels import gj_inverse
    from mfv2d_torch.ops.precision import gj_inverse_plain

    e, n = a.shape[0], a.shape[1]
    route = gj_inverse.route(n, torch.float64)
    ms = _median_ms(lambda: gj_inverse.gj_inverse(a))
    library_ms = _median_ms(lambda: gj_inverse_plain(a))
    timing = {}
    if e <= 16 and ms < 5.0:  # a call this small and quick may be led by the launches
        timing["ms_back_to_back"] = _median_ms(lambda: gj_inverse.gj_inverse(a), calls=10)
        timing["library_ms_back_to_back"] = _median_ms(lambda: gj_inverse_plain(a), calls=10)
    torch.cuda.synchronize()
    bound, bound_by = bound_s(2 * a.numel() * a.element_size(), 2 * n**3 * e)
    bound_ms = bound * 1e3
    by_kernel, sessions = _kernel_launches(lambda: gj_inverse.gj_inverse(a), "gj_")
    launches = sum(by_kernel.values()) or None  # None: the profiler saw no kernel
    print(
        f"phase {phase}: inverse kernel agrees; {name} f64 {route} route median:"
        f" kernel {ms:.4f} ms, torch.linalg.inv {library_ms:.4f} ms,"
        f" bound {bound_ms:.4f} ms ({bound_by}); kernel launches in one call"
        f" (torch.profiler, session {sessions}) {launches}: {by_kernel}"
        + "".join(f", {k} {v:.4f} ms" for k, v in timing.items())
    )
    return {"n": n, "E": e, "route": route, "ms": ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "launches_per_call": launches,
            **timing}


def _mixed_poisson_at_size(n: int, p: int, linear_solver: str, phase: int):
    import mfv2d_torch as mf
    from mfv2d_torch.models import poisson
    from mfv2d_torch.tracing import tracer

    model = poisson.mixed_poisson()
    mesh = mf.examples.unit_square_mesh(n, n, p)
    tracer.enable()
    tracer.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grids, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(linear_solver=linear_solver),
        recon_order=p,
        device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.disable()
    err = _l2_point_error(grids[-1], "u", poisson.u_exact)
    print(
        f"phase {phase}: mixed Poisson {n}x{n} p={p} {linear_solver}:"
        f" {stats.n_total_dofs} unknowns ({stats.n_lagrange} multipliers),"
        f" {int(stats.iter_history[-1])} Picard iterations, L2 point error"
        f" {err:.3e}, wall {wall:.3f} s"
    )
    for name, (calls, total) in sorted(tracer.stages.items(), key=lambda kv: -kv[1][1]):
        print(f"  stage {name:28s} {total:9.4f} s ({calls} calls)")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    if not err <= 1e-8:
        raise RuntimeError(f"mixed Poisson error {err:.3e} > 1e-8")
    return grids[-1]


def _require_launches(phase: int, **counts: int) -> None:
    print(f"  launches: {counts}")
    for name, count in counts.items():
        if count <= 0:
            raise RuntimeError(f"phase {phase} did not launch the {name} kernel")


def _require_no_uploads(phase, label: str, fn):
    """Run ``fn``, a run whose constant tables an earlier run of the phase
    uploaded, with the device-table cache's upload counter at 0; print its
    wall and fail if it uploaded a table."""
    from mfv2d_torch.ops import device_tables

    device_tables.uploads = device_tables.upload_bytes = 0
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(
        f"  {label}: wall {wall:.3f} s, constant tables uploaded {device_tables.uploads}"
        f" ({device_tables.upload_bytes} bytes)"
    )
    if device_tables.uploads:
        raise RuntimeError(
            f"phase {phase}: {label} uploaded {device_tables.uploads} constant tables"
        )
    return result


def _print_memory(phase) -> None:
    """Peak device memory since the last reset, and what the device-table
    cache holds now (tables that earlier phases left resident included)."""
    from mfv2d_torch.ops import device_tables

    print(
        f"  phase {phase}: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes,"
        f" device tables resident {device_tables.resident_bytes('cuda')} bytes"
    )


def phase7_schur_cg() -> int:
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.solver import iterative

    cg_iterations = []
    cg_general = iterative.cg_general

    def counting_cg(*args, **kwargs):
        x, residual, iters = cg_general(*args, **kwargs)
        cg_iterations.append(iters)
        return x, residual, iters

    iterative.cg_general = counting_cg
    gj_inverse.launches = 0
    mass_edge.launches = 0
    try:
        _mixed_poisson_at_size(64, 4, "schur", phase=7)
    finally:
        iterative.cg_general = cg_general
    print(f"  trace CG iterations per solve: {cg_iterations}")
    _require_launches(7, gj_inverse=gj_inverse.launches, mass_edge=mass_edge.launches)
    return gj_inverse.launches


def _device_profile(label: str, fn) -> dict:
    """Run ``fn`` under torch.profiler; print the device busy time and the
    device time by name (kernels and copies), and return the wall, the busy
    time and the copy time each way."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us, ev.count, ev.key))
    busy = sum(us for us, _, _ in rows) / 1e6
    copies = {
        way: sum(us for us, _, key in rows if "Memcpy" in key and way in key) / 1e6
        for way in ("HtoD", "DtoH", "DtoD")
    }
    print(
        f"  profile {label}: wall {wall:.3f} s, device busy {busy:.4f} s"
        f" (idle {100 * (1 - busy / wall):.1f}%; the host's share, wall less busy,"
        f" {wall - busy:.4f} s): copies H2D {copies['HtoD']:.4f} s, D2H"
        f" {copies['DtoH']:.4f} s, D2D {copies['DtoD']:.4f} s; kernels and the rest"
        f" {busy - sum(copies.values()):.4f} s"
    )
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / 1e3:11.3f} ms {count:7d}  {key[:80]}")
    return {"wall_s": wall, "busy_s": busy, **copies}


def phase8_static_condensation() -> int:
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    route = gj_inverse.route(208, torch.float64)
    print(f"  n=208 f64 blocks take the {route} route")
    if route != "blocked":
        raise RuntimeError(f"the p=8 blocks take the {route} route, not the blocked one")
    gj_inverse.launches = 0
    mass_edge.launches = 0
    REFERENCES["phase 8"] = _mixed_poisson_at_size(64, 8, "schur_direct", phase=8)
    launches = mass_edge.launches
    _require_launches(8, gj_inverse=gj_inverse.launches, mass_edge=launches)
    profile = _require_no_uploads(8, "the solve again, warm, profiled", lambda: _device_profile(
        "phase 8, warm", lambda: _mixed_poisson_at_size(64, 8, "schur_direct", phase=8)
    ))
    print(
        f"  phase 8 warm copies: H2D {1e3 * profile['HtoD']:.1f} ms, D2H"
        f" {1e3 * profile['DtoH']:.1f} ms (with a copy of every constant table each call,"
        f" on an NVIDIA H100 80GB HBM3 at 700 W: 265.0 and 696.5 ms)"
    )
    return launches


def phase9_picard_condensed(direct_iterations: int) -> None:
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    gj_inverse.launches = 0
    mass_edge.launches = 0
    iters, err, wall, _, _ = _require_no_uploads(
        9, "the solve, after phase 5's of the same orders", lambda: _navier_stokes("schur_direct")
    )
    print(
        f"phase 9: Navier-Stokes Re=10 16x16 p=5 schur_direct: {iters} Picard"
        f" iterations (direct: {direct_iterations}), velocity error {err:.3e},"
        f" wall {wall:.3f} s"
    )
    _require_launches(9, gj_inverse=gj_inverse.launches, mass_edge=mass_edge.launches)
    if abs(iters - direct_iterations) > 1:
        raise RuntimeError("schur_direct Picard iterations differ from direct by > 1")


def phase10_streamed_table() -> tuple[int, int, int]:
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    card = mass_edge.card(torch.device("cuda", 0))
    plans = {e: mass_edge.launch_plan(110, 110, 196, torch.float64, e, card) for e in (256, 16)}
    route = gj_inverse.route(320, torch.float64)
    for e, plan in plans.items():
        print(
            f"  p=10 f64, E={e}: M1 on the {_route(plan)}, {plan.smem_bytes} bytes of"
            f" shared memory"
        )
    print(f"  n=320 blocks take the {route} route")
    # The Poisson solve's E=256 streams the whole table on the element
    # route; the Navier-Stokes solve's E=16 takes the panel route.
    streamed = plans[256].route == "element" and plans[256].stages > 1
    if not streamed or plans[16].route != "panel" or route != "streamed":
        raise RuntimeError(
            "phase 10 does not reach M1's streamed table and panel route and the inverse's"
            " streamed route"
        )
    gj_inverse.launches = 0
    mass_edge.launches = 0
    _mixed_poisson_at_size(16, 10, "schur_direct", phase=10)
    launches = mass_edge.launches
    _require_launches(10, gj_inverse=gj_inverse.launches, mass_edge=launches)

    # Navier-Stokes at p=10 (element blocks n = 121 + 220 + 100 = 441), on
    # a 4x4 mesh.
    route = gj_inverse.route(441, torch.float64)
    if route != "streamed":
        raise RuntimeError(f"the n=441 blocks take the {route} route, not the streamed one")
    gj_inverse.launches = 0
    mass_edge.launches = 0
    iters, err, wall, _, _ = _navier_stokes("schur_direct", n=4, p=10)
    print(
        f"phase 10: Navier-Stokes Re=10 4x4 p=10 schur_direct: {iters} Picard"
        f" iterations, velocity error {err:.3e}, wall {wall:.3f} s; n=441 blocks"
        f" take the {route} route"
    )
    _require_launches(10, gj_inverse=gj_inverse.launches, mass_edge=mass_edge.launches)
    return launches, mass_edge.launches, gj_inverse.launches


# The JAX package's Picard iterations for phase 13's setup, taken on the CPU
# (mfv2d_tpu.solve_system_2d with JAX_PLATFORMS=cpu and the same settings:
# Navier-Stokes Re=10, 4x4, p=16, "schur_direct", relaxation 0.7; velocity
# error 1.291e-09).
JAX_P16_PICARD_ITERATIONS = 17


def phase13_p16() -> tuple[int, int]:
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.tracing import tracer

    # Element blocks of n = 289 + 544 + 256 = 1089; M1 of 2 x 16 x 17 edges
    # on (16 + 4)^2 quadrature points.
    plan = gj_inverse.launch_plan(1089, torch.float64)
    m1 = mass_edge.launch_plan(
        272, 272, 400, torch.float64, 16, mass_edge.card(torch.device("cuda", 0))
    )
    print(
        f"  p=16 f64: n=1089 blocks take the {plan.route} route, {plan.panel} columns"
        f" a panel over a cluster of {plan.blocks} blocks ({plan.spill} rows spilled);"
        f" M1 at E=16 on the {_route(m1)}"
    )
    if plan.route != "streamed" or plan.blocks < 2 or m1.route != "panel":
        raise RuntimeError("phase 13 does not reach the clustered panel and M1's panel route")
    gj_inverse.launches = 0
    mass_edge.launches = 0
    tracer.enable()
    tracer.reset()
    torch.cuda.reset_peak_memory_stats()
    iters, err, wall, stats, _ = _navier_stokes("schur_direct", n=4, p=16)
    tracer.disable()
    print(
        f"phase 13: Navier-Stokes Re=10 4x4 p=16 schur_direct: {stats.n_total_dofs}"
        f" unknowns, {iters} Picard iterations (the JAX package on the CPU:"
        f" {JAX_P16_PICARD_ITERATIONS}), velocity error {err:.3e}, wall {wall:.3f} s"
    )
    for name, (calls, total) in sorted(tracer.stages.items(), key=lambda kv: -kv[1][1]):
        print(f"  stage {name:28s} {total:9.4f} s ({calls} calls)")
    _require_launches(13, gj_inverse=gj_inverse.launches, mass_edge=mass_edge.launches)
    _print_memory(13)
    if iters != JAX_P16_PICARD_ITERATIONS:
        raise RuntimeError(
            f"p=16 Picard took {iters} iterations, the JAX package {JAX_P16_PICARD_ITERATIONS}"
        )
    launches = mass_edge.launches, gj_inverse.launches
    _p13_first_assembly()
    return launches


def _p13_first_assembly() -> None:
    """Phase 13's first assembly (the "assembly+constraints" stage: forcing,
    element matrices, constraints) once more on a fresh discretization,
    warm, under torch.profiler."""
    import mfv2d_torch as mf
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.models import flow
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator, compute_linear_system

    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(4, 4, 16)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    settings = mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)])
    system = settings.system

    def fresh():
        """The stage on a discretization of its own (the evaluator keeps
        what it assembled)."""
        disc = discretize_mesh(
            mesh, system.unknown_forms, FemCache(settings.over_integration_order), "cuda"
        )
        evaluator = SystemEvaluator(system.unknown_forms, CompiledSystem(system), disc)
        return lambda: compute_linear_system(
            disc, system, evaluator, settings.constrained_forms,
            settings.boundary_conditions, None,
        )

    profile = _require_no_uploads(13, "the first assembly again, warm, profiled", lambda: (
        _device_profile("phase 13, the first assembly again, warm", fresh())
    ))
    print(
        f"  phase 13 warm first assembly: wall {profile['wall_s']:.4f} s, H2D"
        f" {profile['HtoD']:.4f} s (with a copy of every constant table each call, on an"
        f" NVIDIA H100 80GB HBM3 at 700 W: 0.438 and 0.3514 s)"
    )
    # The host's share by Python function, from one more run.
    profiler = cProfile.Profile()
    profiler.runcall(fresh())
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(profiler).stats.items(), key=lambda kv: -kv[1][2])[:10]
    print("  the same stage once more on the host, by function (own time, with callees):")
    for (path, line, name), (_, calls, own, total, _) in rows:
        print(f"    {own:8.4f} s {total:8.4f} s {calls:7d}  {name} ({Path(path).name}:{line})")


# The JAX package's Newton iterations for phase 11's setups, taken on the CPU
# (mfv2d_tpu.solve_system_2d with JAX_PLATFORMS=cpu and the same settings).
JAX_NEWTON_ITERATIONS = {"direct": 2, "schur_direct": 2, "dense 8x8": 2}


def _newton_evaluator(n: int, p: int):
    """A fresh evaluator of phase 5's Navier-Stokes system on the card."""
    import mfv2d_torch as mf
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.models import flow
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator

    system = flow.navier_stokes(10.0).system
    mesh = mf.examples.unit_square_mesh(n, n, p)
    disc = discretize_mesh(mesh, system.unknown_forms, FemCache(3), device="cuda")
    return SystemEvaluator(disc.form_spec, CompiledSystem(system), disc)


def _check_jacobians() -> None:
    """Phase 11's Jacobians: the first call computes the masses (the kernels
    run there, outside the transform), a call after it launches no kernel;
    each Jacobian agrees with a central difference of the residual."""
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    n, p = 16, 5
    evaluator = _newton_evaluator(n, p)
    batch = evaluator.disc.buckets[0].batch
    rng = np.random.default_rng(11)
    u = torch.tensor(rng.normal(size=evaluator.disc.buckets[0].gather.shape), device="cuda")
    counts = []
    for _ in range(2):
        gj_inverse.launches = 0
        mass_edge.launches = 0
        t0 = time.perf_counter()
        jac = evaluator.bucket_jacobians(0, u)
        torch.cuda.synchronize()
        counts.append((mass_edge.launches, gj_inverse.launches, time.perf_counter() - t0))
    (first_mass, _, first_s), (warm_mass, warm_inverse, warm_s) = counts
    du = torch.tensor(rng.normal(size=u.shape), device="cuda")
    h = 1e-6
    diff = (evaluator.bucket_residual(0, u + h * du) - evaluator.bucket_residual(0, u - h * du)) / (2 * h)
    err = rel_err(torch.einsum("eij,ej->ei", jac, du), diff)
    print(
        f"  Jacobians {n}x{n} p={p} (E={batch.n_elements}, N={jac.shape[1]}):"
        f" first call {first_s:.3f} s with {first_mass} mass_edge launches, after"
        f" warm-up {warm_s:.3f} s with {warm_mass} mass_edge and {warm_inverse}"
        f" gj_inverse launches; J du against a central difference: rel err {err:.3e}"
    )
    if first_mass <= 0 or warm_mass or warm_inverse:
        raise RuntimeError("a Jacobian after warm-up launched a kernel, or warm-up none")
    if not (torch.isfinite(jac).all() and err <= 1e-6):
        raise RuntimeError(f"the Jacobians disagree with a central difference: {err:.3e}")


def phase11_newton(picard_iterations: int) -> dict:
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    launches = {}
    # The coarser dense mesh's error: 1.599e-08 in the JAX package (CPU).
    cases = [("direct", 16, 1e-8), ("schur_direct", 16, 1e-8), ("dense", 8, 1e-7)]
    for linear_solver, n, max_err in cases:
        gj_inverse.launches = 0
        mass_edge.launches = 0
        iters, err, wall, stats, grid = _navier_stokes(
            linear_solver, n=n, method="newton", max_err=max_err
        )
        key = linear_solver if n == 16 else f"{linear_solver} {n}x{n}"
        if key == "direct":
            REFERENCES["phase 11"] = (iters, grid)
        dense = ""
        if linear_solver == "dense":
            dense = f", dense saddle {stats.n_total_dofs}^2 f64 = {stats.n_total_dofs**2 * 8} bytes"
        print(
            f"phase 11: Navier-Stokes Re=10 {n}x{n} p=5 Newton, {linear_solver}:"
            f" {iters} iterations (Picard at 16x16: {picard_iterations}; the JAX"
            f" package on the CPU: {JAX_NEWTON_ITERATIONS[key]}), residuals"
            f" {stats.residual_history.tolist()}, velocity error {err:.3e},"
            f" wall {wall:.3f} s{dense}"
        )
        counts = {"mass_edge": mass_edge.launches}
        if linear_solver == "schur_direct":
            counts["gj_inverse"] = gj_inverse.launches
        _require_launches(11, **counts)
        launches[key] = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
        if iters != JAX_NEWTON_ITERATIONS[key]:
            raise RuntimeError(f"Newton ({key}) took {iters} iterations, the JAX package {JAX_NEWTON_ITERATIONS[key]}")
    _check_jacobians()
    return launches


# BASELINE config 2, the gallery's mixed heat march (examples/unsteady/heat_mixed.py).
HEAT_ALPHA, HEAT_BETA, HEAT_T_END, HEAT_NT = 0.02, 1.0, 2.0, 16


def _heat_steady(x, y):
    return np.cos(np.pi * x / 2) * np.cos(np.pi * y / 2)


def _heat_march(n: int, p: int, linear_solver: str, nt: int = HEAT_NT, solvers=None):
    """BASELINE config 2's march on the card, M1's and sn_trsv's launch
    counters and the tracer reset for it (the tracer's counts are read after
    it); each frozen solver it makes is appended to the list ``solvers``."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import transport
    from mfv2d_torch.ops.kernels import mass_edge, supernodal
    from mfv2d_torch.solver.solve import FrozenSaddleSolver
    from mfv2d_torch.tracing import tracer

    system_module = importlib.import_module("mfv2d_torch.solve_system_2d")

    class Recording(FrozenSaddleSolver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            solvers.append(self)

    model = transport.heat_mixed(HEAT_ALPHA, HEAT_BETA, _heat_steady)
    mesh = mf.examples.unit_square_mesh(n, n, p)
    mass_edge.launches = 0
    supernodal.launches = 0
    if solvers is not None:
        system_module.FrozenSaddleSolver = Recording
    tracer.enable()
    tracer.reset()
    t0 = time.perf_counter()
    try:
        grids, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0), linear_solver=linear_solver),
            time_settings=mf.TimeSettings(
                dt=HEAT_T_END / HEAT_NT, nt=nt,
                time_march_relations=model.time_march_relations,
            ),
            recon_order=p,
            device="cuda",
        )
    finally:
        system_module.FrozenSaddleSolver = FrozenSaddleSolver
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.disable()
    t_end = float(grids[-1].field_data["time"][0])
    decay = 1 - np.exp(-HEAT_BETA * t_end)
    err = _l2_point_error(grids[-1], "u", lambda x, y: _heat_steady(x, y) * decay)
    times = [float(g.field_data["time"][0]) for g in grids]
    t_want = HEAT_T_END / HEAT_NT * nt
    if len(grids) != nt + 1 or not np.isclose(t_end, t_want) or times != sorted(times):
        raise RuntimeError(f"heat march grids: {len(grids)}, times {times}")
    return stats, err, wall, mass_edge.launches, dict(tracer.stages), grids


# The JAX bench's heat cell (bench_solve.py, "heat implicit march 16x16
# p=4"): u_t = lap u in mixed form, 64 steps of 1e-2, here from
# u_0 = cos(pi x / 2) cos(pi y / 2), so u = exp(-pi^2 t / 2) u_0.  The flux
# starts at q_0 = grad u_0 too: the trapezoidal start reads the initial
# time derivative from the initial state, and with q_0 = 0 it would be zero.
LINEAR_HEAT_DT, LINEAR_HEAT_NT = 1e-2, 64


def _heat_steady_gradient(x, y):
    return np.stack(
        (
            -np.pi / 2 * np.sin(np.pi * x / 2) * np.cos(np.pi * y / 2),
            -np.pi / 2 * np.cos(np.pi * x / 2) * np.sin(np.pi * y / 2),
        ),
        axis=-1,
    )


def _linear_heat_problem(nt: int):
    """(mesh, system settings, solver settings, time settings) of the
    linear heat march to ``nt`` steps."""
    import mfv2d_torch as mf

    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    system = mf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == 0,
        u.weight @ q.derivative == 0,
    )
    return (
        mf.examples.unit_square_mesh(16, 16, 4),
        mf.SystemSettings(system, initial_conditions={u: _heat_steady, q: _heat_steady_gradient}),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0), linear_solver="dense"),
        mf.TimeSettings(
            dt=LINEAR_HEAT_DT, nt=nt, time_march_relations={u.weight: u},
            sample_rate=LINEAR_HEAT_NT,
        ),
    )


def _linear_heat_march(nt: int = LINEAR_HEAT_NT, checkpoint_settings=None):
    """The "dense" linear heat march (to ``nt`` steps), saving its state
    where ``checkpoint_settings`` says.  Returns
    the statistics, the error at the end, the wall, M1's launches and the
    last grid."""
    import mfv2d_torch as mf
    from mfv2d_torch.ops.kernels import mass_edge

    mass_edge.launches = 0
    t0 = time.perf_counter()
    mesh, settings, solver, time_settings = _linear_heat_problem(nt)
    grids, stats, _ = mf.solve_system_2d(
        mesh,
        settings,
        solver,
        time_settings=time_settings,
        recon_order=4,
        device="cuda",
        checkpoint_settings=checkpoint_settings,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t_end = float(grids[-1].field_data["time"][0])
    if not np.isclose(t_end, LINEAR_HEAT_DT * nt):
        raise RuntimeError(f"linear heat march ends at t={t_end}")
    decay = np.exp(-np.pi**2 * t_end / 2)
    err = _l2_point_error(grids[-1], "u", lambda x, y: _heat_steady(x, y) * decay)
    return stats, err, wall, mass_edge.launches, grids[-1]


# Phase 12's heat march's frozen solver and its sweeps' launches, which
# phase 12b reads (and releases).
HEAT_SOLVER: dict = {}


def _p12_heat_direct() -> int:
    """Phase 12's heat march by "direct", its frozen solver kept for phase
    12b; returns M1's launches."""
    from mfv2d_torch.ops.kernels import supernodal
    from mfv2d_torch.tracing import tracer

    solvers: list = []
    stats, err, wall, count, stages, grids = _heat_march(64, 4, "direct", solvers=solvers)
    sweeps = supernodal.launches
    host, card = tracer.total("frozen_solve_host"), tracer.total("frozen_solve_card")
    REFERENCES["phase 12 heat"] = (grids, err)
    print(
        f"phase 12: heat march (BASELINE config 2) 64x64 p=4 direct: {stats.n_total_dofs}"
        f" unknowns, {HEAT_NT} steps of dt={HEAT_T_END / HEAT_NT}, iterations per"
        f" step {stats.iter_history.tolist()}, L2 point error at t={HEAT_T_END}"
        f" {err:.3e}, wall {wall:.3f} s, mass_edge launches {count}; frozen solves"
        f" {host} on the host and {card} on the card, sn_trsv launches {sweeps}"
    )
    for name, (calls, total) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        print(f"  stage {name:28s} {total:9.4f} s ({calls} calls)")
    _require_launches(12, mass_edge=count, sn_trsv=sweeps)
    if not err <= 1e-3:
        raise RuntimeError(f"heat march error {err:.3e} > 1e-3")
    if len(solvers) != 1 or solvers[0]._card is None:
        raise RuntimeError(f"the heat march made {len(solvers)} frozen solvers, none on the card")
    # The card's solves, and the one run outside the graph that loads the
    # kernel before the graph is captured.
    per_solve = solvers[0]._card.level_launches
    if host + card != int(np.sum(stats.iter_history)) or sweeps != (card + 1) * per_solve:
        raise RuntimeError(
            f"heat march: {host} + {card} frozen solves for {stats.iter_history.tolist()}"
            f" iterations, {sweeps} sn_trsv launches for {per_solve} a solve"
        )
    HEAT_SOLVER.update(solver=solvers[0], launches=sweeps, card_solves=card)
    return count


def phase12_marches() -> dict:
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow
    from mfv2d_torch.ops.kernels import mass_edge

    launches = {"heat 64x64 direct": _p12_heat_direct()}
    _device_profile(
        "phase 12, heat march 64x64 p=4 direct, first 4 steps, warm",
        lambda: _heat_march(64, 4, "direct", nt=4),
    )

    stats16, err16, wall16, count, REFERENCES["phase 12"] = _linear_heat_march()
    print(
        f"phase 12: dense linear heat march 16x16 p=4: {stats16.n_total_dofs}"
        f" unknowns (dense saddle {stats16.n_total_dofs**2 * 8} bytes),"
        f" {LINEAR_HEAT_NT} steps of dt={LINEAR_HEAT_DT}, L2 point error"
        f" {err16:.3e}, wall {wall16:.3f} s, mass_edge launches {count}"
    )
    _require_launches(12, mass_edge=count)
    launches["linear heat 16x16 dense"] = count
    if not err16 <= 5e-5:
        raise RuntimeError(f"linear heat march error {err16:.3e} > 5e-5")

    def lid(x, y):
        on = np.isclose(y, 1.0)
        return np.stack((np.where(on, 1.0, 0.0), np.zeros_like(y)), axis=-1)

    # The gallery's cavity (examples/unsteady/cavity_flow.py: Re=25, dt=0.25,
    # Picard relaxation 0.8) on 16x16, p=4, four steps.
    model = flow.cavity_flow(25.0, lid)
    finals = {}
    for method, relaxation in (("picard", 0.8), ("newton", 1.0)):
        mesh = mf.examples.unit_square_mesh(16, 16, 4)
        bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, lid)
        mass_edge.launches = 0
        t0 = time.perf_counter()
        grids, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
            mf.SolverSettings(
                mf.ConvergenceSettings(30, 1e-8, 0), relaxation=relaxation,
                linear_solver="dense", method=method,
            ),
            time_settings=mf.TimeSettings(
                dt=0.25, nt=4, time_march_relations=model.time_march_relations
            ),
            recon_order=4,
            device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vel = grids[-1].point_data["vel"]
        finals[method] = vel
        print(
            f"phase 12: cavity Re=25 16x16 p=4 dense {method} march:"
            f" {stats.n_total_dofs} unknowns (dense saddle"
            f" {stats.n_total_dofs**2 * 8} bytes), iterations per step"
            f" {stats.iter_history.tolist()}, last residuals"
            f" {stats.residual_history.tolist()}, max speed"
            f" {float(np.max(np.linalg.norm(vel, axis=-1))):.6f}, wall {wall:.3f} s,"
            f" mass_edge launches {mass_edge.launches}"
        )
        _require_launches(12, mass_edge=mass_edge.launches)
        launches[f"cavity 16x16 dense {method}"] = mass_edge.launches
        if not np.isfinite(vel).all() or int(stats.iter_history.max()) >= 30:
            raise RuntimeError(f"the cavity {method} march did not converge")
    gap = float(np.abs(finals["picard"] - finals["newton"]).max())
    print(f"  cavity: Picard and Newton end states differ by {gap:.3e}")
    if not gap <= 1e-6:
        raise RuntimeError(f"the cavity marches disagree: {gap:.3e}")
    return launches


# The sweeps on the card against SciPy's solve and their plain version:
# the same operations summed in another order.
SN_TRSV_TOL = 1e-12


def _tensor_bytes(obj) -> int:
    """The bytes of the tensors a dataclass holds, its nested ones too."""
    total = 0
    for value in vars(obj).values():
        if isinstance(value, torch.Tensor):
            total += value.numel() * value.element_size()
        elif hasattr(value, "__dataclass_fields__"):
            total += _tensor_bytes(value)
    return total


def phase12b_sn_trsv() -> dict:
    """Phase 12's frozen LU on the card (see the module's docstring)."""
    from mfv2d_torch.ops.kernels import supernodal

    solver = HEAT_SOLVER.pop("solver")
    lu, card = solver._decomp, solver._card
    s = card.schedule
    device = s.perm_in.device
    lmat, umat = lu.L, lu.U
    n, nnz_l, nnz_u = lmat.shape[0], lmat.nnz, umat.nnz

    def rel(mine, ref) -> float:
        return float(np.abs(mine - ref).max() / np.abs(ref).max())

    rng = np.random.default_rng(12)
    sides = [rng.normal(size=n) * 10.0**k for k in (-3, 0, 3)]
    refs = [lu.solve(b) for b in sides]
    rel_scipy = 0.0
    for b, ref in zip(sides, refs):
        x = card.solve(b)
        rel_scipy = max(rel_scipy, rel(x, ref))
        if not np.array_equal(card.solve(b), x):
            raise RuntimeError("12b: two card solves of one right side differ")
    t0 = time.perf_counter()
    plain = supernodal.solve_plain(s, torch.as_tensor(sides[0], device=device)).cpu().numpy()
    plain_s = time.perf_counter() - t0
    rel_plain = rel(card.solve(sides[0]), plain)

    ms = _median_ms(card._graph.replay)
    walls, host = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        card.solve(sides[1])
        walls.append(time.perf_counter() - t0)
    for _ in range(5):
        t0 = time.perf_counter()
        lu.solve(sides[1])
        host.append(time.perf_counter() - t0)
    wall_ms, host_ms = 1e3 * float(np.median(walls)), 1e3 * float(np.median(host))

    def csr(matrix):
        matrix = matrix.tocsr()
        return torch.sparse_csr_tensor(
            torch.as_tensor(matrix.indptr, dtype=torch.int64, device=device),
            torch.as_tensor(matrix.indices, dtype=torch.int64, device=device),
            torch.as_tensor(matrix.data, device=device),
            size=matrix.shape,
        )

    lower, upper = csr(lmat), csr(umat)
    rhs = torch.as_tensor(sides[1], device=device)

    def library():
        z = rhs[s.perm_in][:, None]
        y = torch.triangular_solve(z, lower, upper=False, unitriangular=True).solution
        return torch.triangular_solve(y, upper, upper=True).solution[:, 0][s.perm_out]

    rel_library = rel(library().cpu().numpy(), refs[1])
    library_ms = _median_ms(library, reps=3, warmup=1)
    del lower, upper, lmat, umat

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    again = supernodal.build_schedule(lu, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - base
    schedule_bytes = _tensor_bytes(again)
    del again
    values = nnz_l - n + nnz_u  # L's unit diagonal is not stored
    bound, bound_by = bound_s(8 * values + 16 * n, 2 * values)
    bound_ms = bound * 1e3
    levels = [len(s.lower.launches), len(s.upper.launches)]
    print(
        f"phase 12b: the heat march's frozen LU (n {n}, L {nnz_l} and U {nnz_u} non-zeros,"
        f" {s.n_blocks} blocks, L {levels[0]} and U {levels[1]} levels, {card.level_launches}"
        f" launches a solve): sn_trsv within {rel_scipy:.3e} of SciPy (3 right sides) and"
        f" {rel_plain:.3e} of its plain version ({plain_s:.2f} s), bitwise repeatable;"
        f" median a solve: kernel {ms:.4f} ms (graph replay), {wall_ms:.4f} ms wall with"
        f" the copies, SciPy {host_ms:.3f} ms, torch.triangular_solve on CSR"
        f" {library_ms:.3f} ms (within {rel_library:.3e}), bound {bound_ms:.4f} ms"
        f" ({bound_by}: {8 * values + 16 * n} bytes); the build again {build_s:.4f} s, peak"
        f" {build_peak} bytes above its start for a schedule of {schedule_bytes} bytes"
    )
    if not (rel_scipy <= SN_TRSV_TOL and rel_plain <= SN_TRSV_TOL):
        raise RuntimeError(f"12b: sn_trsv {rel_scipy:.3e} from SciPy, {rel_plain:.3e} from plain")
    report = {
        "n": n, "L_nnz": nnz_l, "U_nnz": nnz_u, "blocks": s.n_blocks, "levels": levels,
        "launches_per_solve": card.level_launches, "ms": ms, "wall_ms": wall_ms,
        "host_ms": host_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "plain_s": plain_s, "rel_scipy": rel_scipy,
        "rel_plain": rel_plain, "rel_library": rel_library, "build_s": build_s,
        "build_peak_bytes": build_peak, "schedule_bytes": schedule_bytes,
        "launches": HEAT_SOLVER["launches"], "card_solves": HEAT_SOLVER["card_solves"],
    }
    del solver, card, s
    HEAT_SOLVER.clear()
    torch.cuda.empty_cache()
    return report


# Phase 14: hp refinement of the gallery's advection-diffusion system
# (examples/refinement/advdif_hp.py: nu = -0.05, its wind, exact solution and
# source) on 32x32 at p=4, three rounds of the local-inverse estimator.  The
# h refinement ratio makes every round both split and p-raise elements, so
# the phase drives both branches of the refinement; on this smooth solution
# splits do not pay, and users would not refine it so.
HP_NU, HP_H_RATIO = -0.05, 3e-7
# The JAX package's rounds, taken on the CPU by tools/hp_reference_rounds.py
# (the same settings, linear_solver="direct", recon_order=4): element
# orders, unknowns and the L2 point error of u on each round's mesh, then on
# the mesh the third round returns.  A split halves a (4, 4) element's
# orders, so the error on the first refined mesh is above the first
# round's; it falls again by the final mesh.
JAX_HP_ROUNDS = [
    ({(4, 4): 1024}, 65280, 6.00807606499014e-08),
    ({(2, 2): 56, (4, 4): 921, (5, 5): 89}, 68298, 9.274984153023474e-05),
    ({(2, 2): 60, (4, 4): 903, (5, 5): 17, (6, 6): 89}, 72170, 9.441646151550937e-05),
]
JAX_HP_FINAL = (
    {(2, 2): 60, (3, 3): 356, (4, 4): 902, (5, 5): 1, (6, 6): 17}, 74967, 8.238467060483821e-05
)
# The sum and the largest value of each round's error_estimate and
# h_ref_cost_estimate cell data in the JAX package (the same tool).
JAX_HP_ESTIMATES = [
    (3.9749933674104883, 0.01551671001497418, 1.39823388071382e-05, 5.054865646198419e-08),
    (3.975113046325623, 0.015491412799922593, 1.8677966572915708e-05, 2.2715670863349044e-07),
    (3.9751254212964633, 0.015491412172977767, 1.801670741670464e-05, 2.491904141122855e-07),
]


def _hp_wind(x, y):
    return np.stack(((3 * y - x), (2 - y + 0 * x)), axis=-1)


def _hp_u(x, y):
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def _hp_q(x, y):
    return np.stack(
        (
            -np.pi * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def _hp_source(x, y):
    return np.sum(_hp_wind(x, y) * _hp_q(x, y), axis=-1) - HP_NU * np.pi**2 * _hp_u(x, y) / 2


def _hp_solve(mesh, linear_solver: str, refine: bool):
    import mfv2d_torch as mf
    from mfv2d_torch.models import transport
    from mfv2d_torch.tracing import tracer

    model = transport.linear_advection_diffusion(HP_NU, _hp_wind, _hp_u, _hp_source)
    settings = None
    if refine:
        settings = mf.RefinementSettings(
            mf.ErrorEstimateLocalInverse(model.u, 1),
            mf.RefinementLimitElementCount(0.1, 128),
            h_refinement_ratio=HP_H_RATIO,
            upper_order_limit=8,
        )
    tracer.enable()
    tracer.reset()
    t0 = time.perf_counter()
    grids, stats, out = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(100, 1e-10, 0), linear_solver=linear_solver),
        refinement_settings=settings,
        recon_order=4,
        device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.disable()
    err = _l2_point_error(grids[-1], "u", _hp_u)
    return grids[-1], stats, out, err, wall, dict(tracer.stages), model


def phase14_hp() -> dict:
    import mfv2d_torch as mf
    orchestrator = importlib.import_module("mfv2d_torch.solve_system_2d")
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator

    # Every M1 launch of the phase, by shape (orders, quadrature points, E):
    # the inputs of its first launch, and its launches inside the refinement
    # stage (the estimator's fine batches) and outside it (the solves).  Each
    # shape is held against the plain version and timed after the rounds.
    shapes: dict[tuple[int, int, int, int], dict] = {}
    stage = ["solve"]
    in_refinement = []
    launch_m1 = mass_edge.mass_edge
    perform = orchestrator.perform_mesh_refinement

    def recording_m1(tb, jac):
        key = (tb.p1, tb.p2, tb.w.size, jac.det.shape[0])
        entry = shapes.setdefault(key, {"inputs": (tb, jac), "refinement": 0, "solve": 0})
        before = mass_edge.launches
        out = launch_m1(tb, jac)
        entry[stage[0]] += mass_edge.launches - before
        return out

    def counting_refinement(*args, **kwargs):
        before = mass_edge.launches
        stage[0] = "refinement"
        try:
            result = perform(*args, **kwargs)
        finally:
            stage[0] = "solve"
        torch.cuda.synchronize()
        in_refinement.append(mass_edge.launches - before)
        return result

    mass_edge.mass_edge = recording_m1
    orchestrator.perform_mesh_refinement = counting_refinement
    mass_edge.launches = 0
    gj_inverse.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mesh = mf.examples.unit_square_mesh(32, 32, 4)
    errors, walls, finals = [], {}, {}
    inverse_launches = 0
    try:
        for i, (orders, n_total, jax_err) in enumerate(JAX_HP_ROUNDS, start=1):
            grid, stats, mesh, err, wall, stages, _ = _hp_solve(mesh, "direct", refine=True)
            cost = grid.cell_data["h_ref_cost_estimate"]
            estimate = grid.cell_data["error_estimate"]
            digest = (
                float(estimate.sum()), float(estimate.max()), float(cost.sum()), float(cost.max())
            )
            print(
                f"phase 14: hp round {i}: {stats.element_orders}, {stats.n_total_dofs}"
                f" unknowns, u error {err!r} (the JAX package on the CPU: {jax_err!r}),"
                f" estimates (sum, max; cost sum, max) {digest!r} (the JAX package:"
                f" {JAX_HP_ESTIMATES[i - 1]!r}), wall {wall:.3f} s, mass_edge launches"
                f" in the refinement stage {in_refinement[-1]}, refined mesh"
                f" {mesh.leaf_count} leaves"
            )
            for name, (calls, total) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
                print(f"  stage {name:28s} {total:9.4f} s ({calls} calls)")
            walls[f"round {i}"] = {"wall_s": wall, **{k: v[1] for k, v in stages.items()}}
            if stats.element_orders != orders or stats.n_total_dofs != n_total:
                raise RuntimeError(
                    f"hp round {i}: {stats.element_orders}, {stats.n_total_dofs} unknowns;"
                    f" the JAX package {orders}, {n_total}"
                )
            # 1e-8 relative, with a floor of 1e-12: the two packages' u agree
            # to round-off, a few 1e-15 of |u| <= 2, which is already 2e-8 of
            # the first round's error of 6e-8.
            if not abs(err - jax_err) <= 1e-8 * jax_err + 1e-12:
                raise RuntimeError(f"hp round {i}: u error {err!r}, the JAX package {jax_err!r}")
            if estimate.shape != (stats.n_leaves,) or not np.isfinite(estimate).all():
                raise RuntimeError(f"hp round {i}: error estimates {estimate.shape}")
            if not all(
                abs(x - ref) <= 1e-8 * abs(ref) for x, ref in zip(digest, JAX_HP_ESTIMATES[i - 1])
            ):
                raise RuntimeError(
                    f"hp round {i}: estimates {digest!r}, the JAX package"
                    f" {JAX_HP_ESTIMATES[i - 1]!r}"
                )
            errors.append(err)
            if i == 1:
                REFERENCES["phase 14 round 1"] = (stats, mesh, digest)
        orchestrator.perform_mesh_refinement = perform

        for linear_solver in ("direct", "schur_direct"):
            before = gj_inverse.launches
            grid, stats, _, err, wall, stages, model = _hp_solve(mesh, linear_solver, refine=False)
            finals[linear_solver] = grid
            print(
                f"phase 14: final mesh, {linear_solver}: {stats.element_orders},"
                f" {stats.n_total_dofs} unknowns, u error {err!r} (the JAX package on the"
                f" CPU: {JAX_HP_FINAL[2]!r}), wall {wall:.3f} s, gj_inverse launches"
                f" {gj_inverse.launches - before}"
            )
            walls[f"final {linear_solver}"] = {
                "wall_s": wall, **{k: v[1] for k, v in stages.items()}
            }
            if (stats.element_orders, stats.n_total_dofs) != JAX_HP_FINAL[:2]:
                raise RuntimeError(f"hp final mesh: {stats.element_orders}, {stats.n_total_dofs}")
            if not abs(err - JAX_HP_FINAL[2]) <= 1e-8 * JAX_HP_FINAL[2]:
                raise RuntimeError(f"hp final u error {err!r}, the JAX package {JAX_HP_FINAL[2]!r}")
            if linear_solver == "schur_direct":
                inverse_launches = gj_inverse.launches - before
    finally:
        orchestrator.perform_mesh_refinement = perform
        mass_edge.mass_edge = launch_m1
    _print_memory("14 (hp rounds and final solves)")
    phase_launches = {"mass_edge": mass_edge.launches, "gj_inverse": inverse_launches}
    gap = max(
        float(np.abs(finals["schur_direct"].point_data[k] - finals["direct"].point_data[k]).max()
              / np.abs(finals["direct"].point_data[k]).max())
        for k in ("u", "q")
    )
    REFERENCES["phase 14"] = (mesh, finals["schur_direct"])
    print(f"  final mesh: direct and schur_direct differ by {gap:.3e} (relative)")
    if not gap <= 1e-10:
        raise RuntimeError(f"the final hp solves disagree: {gap:.3e}")
    # On this smooth solution a split halves a leaf's orders, so the first
    # refined mesh is less accurate than the uniform one; the rounds after it
    # must win some of that back.
    if not err < errors[1]:
        raise RuntimeError(f"hp: the final u error {err!r} is not below the first refined mesh's")
    _require_launches(
        14, mass_edge_in_refinement=min(in_refinement), gj_inverse_schur_direct=inverse_launches
    )

    # M1 at every shape the phase launched it on, against the plain version.
    mass_timing = []
    for (p1, p2, nq, e), entry in sorted(shapes.items()):
        tb, jac = entry["inputs"]
        timing = _time_mass_edge(
            tb, jac, f"p=({p1},{p2}) nq={nq} E={e}",
            "phase 14 (three hp rounds and the final solves)", phase=14,
        )
        timing["launches"] = entry["refinement"] + entry["solve"]
        timing["launches_refinement_stage"] = entry["refinement"]
        mass_timing.append(timing)
    if not all(t["launches"] > 0 for t in mass_timing):
        raise RuntimeError("phase 14 recorded an M1 shape with no launch")
    _device_profile(
        "phase 14, hp round 1 again, warm",
        lambda: _hp_solve(mf.examples.unit_square_mesh(32, 32, 4), "direct", refine=True),
    )

    # The inverse of each bucket's element blocks, as "schur_direct" gives them.
    compiled = CompiledSystem(model.system)
    disc = discretize_mesh(mesh, model.system.unknown_forms, FemCache(3), device="cuda")
    blocks = SystemEvaluator(disc.form_spec, compiled, disc).element_matrices(compiled.lhs_blocks)
    inverse_timing = []
    for bucket, block in zip(disc.buckets, blocks):
        p1 = bucket.orders[0]
        e = bucket.batch.n_elements
        a = torch.tensor(block, device="cuda")
        out, ref = gj_inverse.gj_inverse(a), torch.linalg.inv(a)
        err = rel_err(out, ref)
        if not err <= INVERSE_TOL[torch.float64]:
            raise RuntimeError(f"inverse kernel disagrees at p={p1}: {err:.3e}")
        inverse = _time_inverse(a, f"hp p={p1} blocks n={a.shape[1]} E={e}", phase=14)
        inverse["max_abs_err"] = float((out - ref).abs().max())
        inverse_timing.append(inverse)
    print(f"phase 14: walls by stage (s): {json.dumps(walls)}")
    return {"launches": phase_launches, "in_refinement": in_refinement, "mass_edge": mass_timing,
            "gj_inverse": inverse_timing}


# Phase 15: VMS.  The JAX package's values on the CPU, printed by
# `JAX_PLATFORMS=cpu python3 tools/vms_reference.py` (its docstring says
# what each is): 15a's (iterations, u error, max |vms-u|) by branch, and
# 15c's hp round with ErrorEstimateVMS.
JAX_VMS_SMALL = {
    "direct LU": (13, 5.58820878145713e-06, 1.0173060008001211e-13),
    "matrix-free": (13, 5.588208781356068e-06, 1.2834049060894272e-13),
}
JAX_VMS_ESTIMATE = {
    "iterations": 10,
    "unknowns": 2448,
    "raised": [0, 7, 54, 55, 56, 62, 63],
    "digest": (
        3.7092318877119004e-06, 2.6251514775513866e-06, 0.0026134088056780544,
        0.00012584223044841242,
    ),
}
# BASELINE config 5 (bench_vms.py) as the JAX package reached it (BENCH.md
# section 4b; its accuracy only): 13 Picard iterations with Anderson, 17
# without; u error 4.677495414331449e-13 (its runs 3.34e-13 to 2.28e-12);
# max |vms-u| 9.25e-12 to 6.6e-11.  Phase 15b holds the port to plain
# Picard's iterations and to these bounds.
JAX_CONFIG5 = {"iterations": 13, "u_error": 4.677495414331449e-13}
CONFIG5_MESH, CONFIG5_ORDER, CONFIG5_FINE_ORDER = 64, 8, 10
CONFIG5_MAX_ITERATIONS = 17
CONFIG5_MAX_U_ERROR = 1e-11
CONFIG5_MAX_VMS = 1e-9
# This flow's fine scales are round-off (the linear part of its advection is
# the symmetric operator, which G' annihilates on resolved residuals): 15a
# holds them to the JAX package's to this absolute amount.
VMS_ROUND_OFF = 1e-12
VMS_NU = -1.0


def _vms_u(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def _vms_source(x, y):
    qx = -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y)
    qy = -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y)
    return qx**2 + qy**2 - VMS_NU * np.pi**2 * _vms_u(x, y) / 2


def _vms_u_skew(x, y):
    return _vms_u(x, y) * np.exp(0.4 * x + 0.2 * y)


def _vms_source_skew(x, y):
    return np.exp(0.5 * x + 0.25 * y)


def _vms_systems(u_bc, source):
    """bench_vms.py's nonlinear flow and its symmetric (diffusion) system."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import transport

    model = transport.nonlinear_flow(VMS_NU, u_bc, source)
    u, q = model.u, model.q
    symmetric = mf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == q.weight ^ u_bc,
        VMS_NU * (u.weight @ q.derivative) == -(u.weight @ source),
    )
    return model, symmetric


def _vms_solve(n: int, p: int, matrix_free: bool, keep_grid: bool = False):
    """bench_vms.py's solve on an n x n mesh at order p, +2 fine (BASELINE
    config 5 at n=64, p=8), on the card, traced; with ``keep_grid`` also
    its last grid."""
    import mfv2d_torch as mf
    from mfv2d_torch.ops import device_tables
    from mfv2d_torch.tracing import tracer

    model, symmetric = _vms_systems(_vms_u, _vms_source)
    tracer.enable()
    tracer.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grids, stats, _ = mf.solve_system_2d(
        mf.examples.unit_square_mesh(n, n, p),
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
        device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.disable()
    vms = grids[-1].point_data["vms-u"]
    run = {
        "iterations": int(stats.iter_history[0]),
        "u_error": _l2_point_error(grids[-1], "u", _vms_u),
        "vms_max": float(np.abs(vms).max()) if np.isfinite(vms).all() else float("nan"),
        "unknowns": int(stats.n_total_dofs),
        "wall_s": wall,
        "stages": {k: v[1] for k, v in tracer.stages.items()},
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "device_tables_bytes": device_tables.resident_bytes("cuda"),
    }
    return (run, grids[-1]) if keep_grid else run


class _KernelRecorder:
    """While active, counts both kernels' launches by shape under the label
    in ``part`` and keeps the first inputs of each shape; while ``part`` is
    None it records nothing."""

    # The recorders in use, the outermost first.
    active: list["_KernelRecorder"] = []

    def __init__(self) -> None:
        self.mass_edge: dict[tuple, dict] = {}  # (p1, p2, nq, E)
        self.gj_inverse: dict[tuple, dict] = {}  # (n, E)
        self.part = ""

    def _recording(self, module, launch, table, key_of):
        def recording(*args):
            if self.part is None:
                return launch(*args)
            entry = table.setdefault(key_of(*args), {"inputs": args, "launches": {}})
            before = module.launches
            out = launch(*args)
            counts = entry["launches"]
            counts[self.part] = counts.get(self.part, 0) + module.launches - before
            return out

        return recording

    def __enter__(self):
        from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
        from mfv2d_torch.parallel import sharding
        from mfv2d_torch.solver import iterative

        self._saved = [
            (mass_edge, "mass_edge", mass_edge.mass_edge),
            (gj_inverse, "gj_inverse", gj_inverse.gj_inverse),
            (iterative, "gj_inverse", iterative.gj_inverse),
            (sharding, "gj_inverse", sharding.gj_inverse),
        ]
        mass_edge.mass_edge = self._recording(
            mass_edge, mass_edge.mass_edge, self.mass_edge,
            lambda tb, jac: (tb.p1, tb.p2, tb.w.size, jac.det.shape[0]),
        )
        inv = self._recording(
            gj_inverse, gj_inverse.gj_inverse, self.gj_inverse, lambda a: (a.shape[-1], a.shape[0])
        )
        gj_inverse.gj_inverse = inv
        iterative.gj_inverse = inv
        sharding.gj_inverse = inv
        _KernelRecorder.active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _KernelRecorder.active.remove(self)
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def phase15_vms() -> dict:
    import mfv2d_torch as mf
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    runs = {}
    with _KernelRecorder() as rec:
        # 15a: agreement with the JAX package through both Green's branches.
        for name, matrix_free in (("direct LU", False), ("matrix-free", True)):
            rec.part = f"15a {name}"
            mass_edge.launches = 0
            gj_inverse.launches = 0
            run = _vms_solve(8, 4, matrix_free)
            run["launches"] = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
            runs[rec.part] = run
            REFERENCES[f"phase 15a {name}"] = run
            iters, err, vms = JAX_VMS_SMALL[name]
            print(
                f"phase 15a: VMS nonlinear flow 8x8 p=4 +2, {name}: {run['iterations']} Picard"
                f" iterations, u error {run['u_error']!r}, max |vms-u| {run['vms_max']!r} (the"
                f" JAX package on the CPU: {iters}, {err!r}, {vms!r}), wall {run['wall_s']:.3f} s"
            )
            _require_launches(15, **run["launches"])
            if run["iterations"] != iters:
                raise RuntimeError(f"15a {name}: {run['iterations']} iterations, JAX {iters}")
            if not abs(run["u_error"] - err) <= 1e-8 * err:
                raise RuntimeError(f"15a {name}: u error {run['u_error']!r}, JAX {err!r}")
            if not (0 < run["vms_max"] and abs(run["vms_max"] - vms) <= VMS_ROUND_OFF):
                raise RuntimeError(f"15a {name}: max |vms-u| {run['vms_max']!r}, JAX {vms!r}")

        # 15b: BASELINE config 5 at full size.
        rec.part = "15b config 5"
        mass_edge.launches = 0
        gj_inverse.launches = 0
        run = _vms_solve(CONFIG5_MESH, CONFIG5_ORDER, True)
        run["launches"] = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
        runs[rec.part] = run
        print(
            f"phase 15b: BASELINE config 5, VMS nonlinear flow 64x64 p=8 +2 matrix-free:"
            f" {run['unknowns']} unknowns, {run['iterations']} Picard iterations (the JAX"
            f" package: {JAX_CONFIG5['iterations']}, plain Picard {CONFIG5_MAX_ITERATIONS}),"
            f" u error {run['u_error']!r} (JAX {JAX_CONFIG5['u_error']!r}), max |vms-u|"
            f" {run['vms_max']!r} (JAX 9.25e-12 to 6.6e-11), wall {run['wall_s']:.3f} s,"
            f" max_memory_allocated {run['peak_bytes']} bytes, device tables resident"
            f" {run['device_tables_bytes']} bytes"
        )
        for stage, total in sorted(run["stages"].items(), key=lambda kv: -kv[1]):
            print(f"  stage {stage:60s} {total:9.4f} s")
        _require_launches(15, **run["launches"])
        if run["iterations"] > CONFIG5_MAX_ITERATIONS:
            raise RuntimeError(f"config 5 took {run['iterations']} Picard iterations")
        if not run["u_error"] <= CONFIG5_MAX_U_ERROR:
            raise RuntimeError(f"config 5 u error {run['u_error']!r} > {CONFIG5_MAX_U_ERROR}")
        if not 0 < run["vms_max"] <= CONFIG5_MAX_VMS:
            raise RuntimeError(f"config 5 max |vms-u| {run['vms_max']!r}")

        # 15c: one hp round with the VMS estimator.
        rec.part = "15c hp round"
        mass_edge.launches = 0
        gj_inverse.launches = 0
        model, symmetric = _vms_systems(_vms_u_skew, _vms_source_skew)
        estimate = mf.ErrorEstimateVMS(model.u, symmetric, model.system, 1, 20, 1e-12, 1e-10)
        t0 = time.perf_counter()
        grids, stats, mesh = mf.solve_system_2d(
            mf.examples.unit_square_mesh(8, 8, 3),
            mf.SystemSettings(model.system, over_integration_order=3),
            mf.SolverSettings(mf.ConvergenceSettings(40, 1e-9, 0)),
            refinement_settings=mf.RefinementSettings(
                estimate, mf.RefinementLimitElementCount(0.1, 128)
            ),
            recon_order=4,
            device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e = grids[-1].cell_data["error_estimate"]
        c = grids[-1].cell_data["h_ref_cost_estimate"]
        digest = (float(e.sum()), float(e.max()), float(c.sum()), float(c.max()))
        orders = [tuple(mesh.get_leaf_orders(int(i))) for i in mesh.get_leaf_indices()]
        raised = [i for i, o in enumerate(orders) if o != (3, 3)]
        runs[rec.part] = {
            "iterations": int(stats.iter_history[0]),
            "unknowns": int(stats.n_total_dofs),
            "raised": raised,
            "digest": digest,
            "wall_s": wall,
            "launches": {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches},
        }
        print(
            f"phase 15c: hp round with ErrorEstimateVMS, 8x8 p=3 +1:"
            f" {runs[rec.part]['iterations']} Picard iterations, {stats.n_total_dofs} unknowns,"
            f" raised leaves {raised}, estimates (sum, max; cost sum, max) {digest!r} (the JAX"
            f" package on the CPU: {JAX_VMS_ESTIMATE!r}), wall {wall:.3f} s"
        )
        _require_launches(15, **runs[rec.part]["launches"])
        expected = {k: JAX_VMS_ESTIMATE[k] for k in ("iterations", "unknowns", "raised")}
        if {k: runs[rec.part][k] for k in expected} != expected or not all(
            o in ((3, 3), (4, 4)) for o in orders
        ):
            raise RuntimeError(f"15c: {runs[rec.part]}, JAX {JAX_VMS_ESTIMATE}")
        if not all(abs(x - r) <= 1e-8 * abs(r) for x, r in zip(digest, JAX_VMS_ESTIMATE["digest"])):
            raise RuntimeError(f"15c: estimates {digest!r}, JAX {JAX_VMS_ESTIMATE['digest']!r}")

    # Config 5 must have run both kernels at its own shapes: M1 on the
    # coarse (p=8) and fine (p=10) batches, the inverse on the fine blocks
    # (n=320, streamed) and on the main and Galerkin coarse blocks (n=208,
    # blocked), all at E=4096.
    e5 = CONFIG5_MESH**2
    orders = (CONFIG5_FINE_ORDER, CONFIG5_ORDER)
    m1_keys = [k for k in rec.mass_edge if k[3] == e5 and k[0] == k[1] and k[0] in orders]
    inverse_keys = [(2 * p * (p + 1) + p * p, e5) for p in orders]
    for table, keys in ((rec.mass_edge, m1_keys), (rec.gj_inverse, inverse_keys)):
        if len(keys) < 2 or not all(
            table.get(k, {}).get("launches", {}).get("15b config 5") for k in keys
        ):
            raise RuntimeError(f"config 5 did not launch a kernel at {keys}: {list(table)}")

    # Both kernels held against their plain versions and timed at every
    # shape phase 15 launched them on.
    mass_timing = []
    for (p1, p2, nq, e), entry in sorted(rec.mass_edge.items()):
        tb, jac = entry["inputs"]
        timing = _time_mass_edge(
            tb, jac, f"p=({p1},{p2}) nq={nq} E={e}", f"phase {', '.join(entry['launches'])}",
            phase=15, plain_max=KERNEL_MAX_BATCH_HIGH if max(p1, p2) > 8 else None,
        )
        timing["m1_shape"] = [p1, p2, nq, e]
        timing["launches"] = sum(entry["launches"].values())
        timing["launches_by_run"] = entry["launches"]
        mass_timing.append(timing)
    inverse_timing = []
    for (n, e), entry in sorted(rec.gj_inverse.items()):
        (a,) = entry["inputs"]
        out, ref = gj_inverse.gj_inverse(a), torch.linalg.inv(a)
        err = rel_err(out, ref)
        if not err <= INVERSE_TOL[torch.float64]:
            raise RuntimeError(f"inverse kernel disagrees at n={n}, E={e}: {err:.3e}")
        timing = _time_inverse(a, f"phase-15 blocks n={n} E={e}", phase=15)
        timing["max_abs_err"] = float((out - ref).abs().max())
        timing["launches"] = sum(entry["launches"].values())
        timing["launches_by_run"] = entry["launches"]
        timing["launches_in"] = f"phase {', '.join(entry['launches'])}"
        inverse_timing.append(timing)
        del out, ref
    for run in runs.values():
        run.pop("stages", None)
    return {"runs": runs, "mass_edge": mass_timing, "gj_inverse": inverse_timing}


# Phase 16: the element-sharded steady solve over torch.distributed.  The
# ranks are spawned processes; they build their models by name and size.
P16_MESH, P16_ORDER = 64, 8  # 16a and 16b: phase 8's setup, BASELINE config 5's mesh and order
P16_CUT = 6  # 16e: Picard iterations before the cut
P16_TOL = 1e-8
# The JAX package's Picard iterations for phase 5's setup (CPU).
JAX_NS_PICARD_ITERATIONS = 17
# Grids and meshes of earlier phases that phase 16 compares with; a phase
# that did not run (--probe parallel) is run again for them.
REFERENCES: dict = {}
# Every torch.distributed.all_reduce a phase-16 rank makes, however it is
# called (the rank counts them at the function itself).
P16_RAW_REDUCES = [0]


def _p16_problem(name: str, hp_mesh=None):
    """(mesh, system settings, solver settings without device_mesh, recon
    order, field, exact) of a phase-16 problem, built by name."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow, poisson, transport

    if name == "poisson":
        model = poisson.mixed_poisson()
        return (
            mf.examples.unit_square_mesh(P16_MESH, P16_MESH, P16_ORDER),
            mf.SystemSettings(model.system),
            mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
            P16_ORDER, "u", poisson.u_exact,
        )
    if name == "ns":
        model = flow.navier_stokes(10.0)
        mesh = mf.examples.unit_square_mesh(16, 16, 5)
        bc = mf.BoundaryCondition2DSteady(
            model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
        )
        return (
            mesh,
            mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
            mf.SolverSettings(
                mf.ConvergenceSettings(80, 1e-8, 0.0), relaxation=0.7, linear_solver="gmres"
            ),
            10, "vel", flow.ns_velocity_exact,
        )
    # Advection makes the trace Schur complement nonsymmetric: GMRES.
    model = transport.linear_advection_diffusion(HP_NU, _hp_wind, _hp_u, _hp_source)
    return (
        hp_mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(100, 1e-10, 0), linear_solver="gmres"),
        4, "u", _hp_u,
    )


def _p16_job(mesh, problem: str, hp_mesh=None, max_iters=None, path=None, resume=None):
    """One sharded solve on this rank, with what it launched and reduced."""
    from dataclasses import replace

    import mfv2d_torch as mf
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.parallel.sharding import TraceComm
    from mfv2d_torch.tracing import tracer

    comm = TraceComm(mesh)
    fe_mesh, settings, solver, recon, field, exact = _p16_problem(problem, hp_mesh)
    conv = solver.convergence
    if max_iters is not None:
        conv = replace(conv, maximum_iterations=max_iters)
    solver = replace(solver, convergence=conv, device_mesh=comm)
    ckpt = None if path is None else mf.CheckpointSettings(path, every=1, resume_from=resume)
    raw_before = P16_RAW_REDUCES[0]
    with _KernelRecorder() as rec:
        rec.part = problem
        mass_edge.launches = 0
        gj_inverse.launches = 0
        tracer.enable()
        tracer.reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids, stats, _ = mf.solve_system_2d(
            fe_mesh, settings, solver, recon_order=recon, checkpoint_settings=ckpt
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tracer.disable()
        launches = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
    grid = grids[-1]
    return {
        "device": str(comm.device),
        "backend": comm.backend,
        "checkpointing": ckpt is not None,
        "buckets": len(stats.element_orders),
        "raw_reduces": P16_RAW_REDUCES[0] - raw_before,
        "points": grid.point_data[field],
        "fields": {k: v for k, v in grid.point_data.items()},
        "error": _l2_point_error(grid, field, exact),
        "iterations": int(stats.iter_history[0]),
        "unknowns": int(stats.n_total_dofs),
        "multipliers": int(stats.n_lagrange),
        "counts": dict(comm.counts),
        "matvecs": comm.matvecs,
        "krylov": list(comm.krylov),
        "wall_s": wall,
        "stages": {k: v[1] for k, v in tracer.stages.items()},
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "m1_shapes": {k: sum(v["launches"].values()) for k, v in rec.mass_edge.items()},
        "inverse_shapes": {k: sum(v["launches"].values()) for k, v in rec.gj_inverse.items()},
    }


def _p16_rank(mesh, jobs, time_kernels=False) -> dict:
    """A rank's job in a phase-16 or -17 group (spawned by
    ``examples_torch.common.spawn_ranks``): run ``jobs`` in order (each by
    the function its ``job`` names, ``_p16_job`` by default) with the raw
    ``all_reduce`` calls counted and the kernel launches recorded.  With
    ``time_kernels`` rank 0 then holds both kernels against their plain
    versions and times them at every shape its jobs launched them on."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    all_reduce = dist.all_reduce

    def counted_all_reduce(*args, **kwargs):
        P16_RAW_REDUCES[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted_all_reduce
    # Each job ends in a collective (the DoF gather), so every rank is past
    # its last one when it leaves the group.
    results = {}
    with _KernelRecorder() as rec:
        for name, kwargs in jobs:
            kwargs = dict(kwargs)
            rec.part = name
            results[name] = globals()[kwargs.pop("job", "_p16_job")](mesh, **kwargs)
        rec.part = None
    if time_kernels and dist.get_rank() == 0:
        results["kernels"] = _p17_time_recorded(rec)
    return results


def _field_rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / np.abs(ref).max())


def _p16_references() -> None:
    """Run again the earlier phases whose grids phase 16 compares with."""
    if "phase 5" not in REFERENCES:
        iters, err, _, _, grid = _navier_stokes("direct")
        REFERENCES["phase 5"] = (iters, err, grid)
    if "phase 8" not in REFERENCES:
        REFERENCES["phase 8"] = _mixed_poisson_at_size(P16_MESH, P16_ORDER, "schur_direct", 16)
    if "phase 12" not in REFERENCES:
        REFERENCES["phase 12"] = _linear_heat_march()[4]
    if "phase 14" not in REFERENCES:
        import mfv2d_torch as mf

        mesh = mf.examples.unit_square_mesh(32, 32, 4)
        for _ in JAX_HP_ROUNDS:
            mesh = _hp_solve(mesh, "direct", refine=True)[2]
        REFERENCES["phase 14"] = (mesh, _hp_solve(mesh, "schur_direct", refine=False)[0])


def _p16_print(label: str, ranks: list[dict]) -> None:
    r0 = ranks[0]
    print(
        f"phase {label}: {len(ranks)} rank(s), backend {r0['backend']}, devices"
        f" {[r['device'] for r in ranks]}: {r0['unknowns']} unknowns ({r0['multipliers']}"
        f" multipliers), {r0['iterations']} residual evaluations, Krylov"
        f" {r0['krylov']}, error {r0['error']!r}, wall {r0['wall_s']:.3f} s"
    )
    for rank, r in enumerate(ranks):
        print(
            f"  rank {rank}: all_reduce calls {r['counts']} ({r['raw_reduces']} in all),"
            f" trace matvecs {r['matvecs']},"
            f" launches {r['launches']}, peak {r['peak_bytes']} bytes, M1 by (p1, p2, nq, E)"
            f" {r['m1_shapes']}, inverse by (n, E) {r['inverse_shapes']}"
        )
    for stage, total in sorted(r0["stages"].items(), key=lambda kv: -kv[1]):
        print(f"  stage {stage:40s} {total:9.4f} s")


def _p16_check_ranks(label: str, ranks: list[dict]) -> None:
    """Every rank returns the same answer, reduces once per trace matvec
    and launches both kernels."""
    for rank, r in enumerate(ranks):
        if not np.array_equal(r["points"], ranks[0]["points"]):
            raise RuntimeError(f"{label}: rank {rank} returned another answer")
        # Beside the trace matvecs: two reduces a residual evaluation (the
        # trace value and the norm), one a Picard update (its Schur
        # right-hand side), one a bucket at set-up, and the DoF gathers (one
        # at the end, one an update when checkpointing).  No other reduce
        # is made, so what is left of the total is one a matvec.
        counts, evals, updates = r["counts"], r["iterations"], len(r["krylov"])
        others = {"setup": r["buckets"], "residual": evals, "norm": evals, "rhs": updates,
                  "gather": 1 + (updates if r["checkpointing"] else 0)}
        want = {**others, "schur": r["matvecs"]}
        if (
            counts != {tag: n for tag, n in want.items() if n}
            or r["raw_reduces"] != sum(counts.values())
            or r["raw_reduces"] - sum(others.values()) != r["matvecs"]
            or (updates and r["matvecs"] <= 0)
        ):
            raise RuntimeError(
                f"{label}: rank {rank}: {counts} ({r['raw_reduces']} in all) for"
                f" {r['matvecs']} matvecs, {evals} evaluations, {updates} updates"
            )
        if not (r["launches"]["mass_edge"] > 0 and r["launches"]["gj_inverse"] > 0):
            raise RuntimeError(f"{label}: rank {rank} launched {r['launches']}")


def phase16_parallel() -> dict:
    import shutil

    from examples_torch.common import spawn_ranks

    import mfv2d_torch as mf

    _p16_references()
    work = ROOT / "build" / "phase16"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cut, resumed = str(work / "cut.npz"), str(work / "resumed.npz")
    hp_mesh, hp_ref = REFERENCES["phase 14"]
    two_cards = torch.cuda.device_count() >= 2
    backend = "nccl" if two_cards else "gloo"
    print(
        f"  phase 16: {torch.cuda.device_count()} card(s) visible; 2 ranks on {backend}"
        + ("" if two_cards else " with both ranks on cuda:0 (NCCL takes one rank a card)")
    )

    # 16b, 16d and 16c on 2 ranks, 16c cut after P16_CUT iterations and
    # resumed from its file (the sharded part of 16e); then 16a and the
    # world-size-1 resume from the 2-rank file on 1 rank.
    two = spawn_ranks(_p16_rank, [
        ("16b", {"problem": "poisson"}),
        ("16d", {"problem": "hp", "hp_mesh": hp_mesh}),
        ("16c cut", {"problem": "ns", "max_iters": P16_CUT, "path": cut}),
        ("16c resumed", {"problem": "ns", "path": resumed, "resume": cut}),
    ], world=2, backend=backend)
    one = spawn_ranks(_p16_rank, [
        ("16a", {"problem": "poisson"}),
        ("16e world 1", {"problem": "ns", "path": str(work / "world1.npz"), "resume": resumed}),
    ], world=1)
    by_job = {name: [r[name] for r in two] for name in two[0]}
    by_job.update({name: [r[name] for r in one] for name in one[0]})

    # 16a: world size 1 against phase 8's static condensation.
    a = by_job["16a"][0]
    _p16_print("16a", by_job["16a"])
    ref8 = REFERENCES["phase 8"]
    gap_a = max(_field_rel(a["fields"][k], ref8.point_data[k]) for k in ("u", "q"))
    print(f"  16a against phase 8's schur_direct: {gap_a:.3e} (relative)")
    if not (gap_a <= P16_TOL and a["error"] <= 1e-8):
        raise RuntimeError(f"16a: {gap_a:.3e} from phase 8, error {a['error']!r}")
    # 16b: 2 ranks against 16a, each rank at half the elements.
    _p16_print("16b", by_job["16b"])
    gap_b = max(_field_rel(by_job["16b"][0]["fields"][k], a["fields"][k]) for k in ("u", "q"))
    print(f"  16b against 16a: {gap_b:.3e} (relative)")
    if not gap_b <= P16_TOL:
        raise RuntimeError(f"16b: {gap_b:.3e} from 16a")
    half = P16_MESH**2 // 2
    n208 = 2 * P16_ORDER * (P16_ORDER + 1) + P16_ORDER**2
    for rank, r in enumerate(by_job["16b"]):
        m1 = [k for k, v in r["m1_shapes"].items() if k[3] == half and v > 0]
        if not m1 or r["inverse_shapes"].get((n208, half), 0) <= 0:
            raise RuntimeError(f"16b: rank {rank} did not launch both kernels at E={half}")
    for job in ("16a", "16b", "16c cut", "16c resumed", "16d", "16e world 1"):
        _p16_check_ranks(job, by_job[job])

    # 16c: Navier-Stokes at 2 ranks through trace GMRES, cut and resumed,
    # against phase 5.
    _p16_print("16c cut", by_job["16c cut"])
    _p16_print("16c resumed", by_job["16c resumed"])
    c_cut, c = by_job["16c cut"][0], by_job["16c resumed"][0]
    iters5, err5, grid5 = REFERENCES["phase 5"]
    updates = len(c_cut["krylov"]) + len(c["krylov"])
    gap_c = _field_rel(c["points"], grid5.point_data["vel"])
    print(
        f"  16c: {len(c_cut['krylov'])} + {len(c['krylov'])} Picard updates (phase 5:"
        f" {iters5}; the JAX package: {JAX_NS_PICARD_ITERATIONS}), velocity error"
        f" {c['error']!r} (phase 5: {err5!r}, {abs(c['error'] - err5) / err5:.3e}"
        f" relative), velocity against phase 5: {gap_c:.3e} (relative)"
    )
    if updates != iters5 or not (gap_c <= P16_TOL and c["error"] <= 1e-8):
        raise RuntimeError(f"16c: {updates} updates, {gap_c:.3e} from phase 5")

    # 16d: phase 14's final hp mesh at 2 ranks.
    d = by_job["16d"][0]
    _p16_print("16d", by_job["16d"])
    gap_d = max(_field_rel(d["fields"][k], hp_ref.point_data[k]) for k in ("u", "q"))
    print(f"  16d against phase 14's schur_direct: {gap_d:.3e} (relative)")
    if d["unknowns"] != JAX_HP_FINAL[1] or not gap_d <= P16_TOL:
        raise RuntimeError(f"16d: {d['unknowns']} unknowns, {gap_d:.3e} from phase 14")

    # 16e: checkpoints on the card.
    checkpoints = _p16_checkpoints(work, iters5, grid5)
    e_one = by_job["16e world 1"][0]
    from mfv2d_torch.checkpoint import load_steady_state

    files = [load_steady_state(f)["iteration"] for f in (cut, resumed)]
    gap_one = _field_rel(e_one["points"], c["points"])
    print(
        f"phase 16e: 2 ranks, cut after {c_cut['iterations']} residual evaluations and"
        f" resumed for {c['iterations']} (files at iterations {files}); the 2-rank file"
        f" resumes 1 rank in {e_one['iterations']} evaluation(s), {gap_one:.3e} from 16c"
    )
    # The sharded branch counts residual evaluations, the cut's P16_CUT and
    # the resumed run's updates + 1: phase 5's iterations + 1 in all.
    if (
        files != [P16_CUT, iters5 + 1]
        or c_cut["iterations"] + c["iterations"] != iters5 + 1
        or e_one["iterations"] > 1
        or not gap_one <= 1e-12
    ):
        raise RuntimeError("16e: the sharded resume does not add up")

    shapes = _p16_kernels(by_job["16b"][0])
    return {
        "gaps": {"16a": gap_a, "16b": gap_b, "16c": gap_c, "16d": gap_d, "16e": gap_one},
        "checkpoints": checkpoints,
        "runs": {
            job: {
                **{k: v for k, v in rs[0].items() if k not in ("points", "fields")},
                "m1_shapes": {str(k): v for k, v in rs[0]["m1_shapes"].items()},
                "inverse_shapes": {str(k): v for k, v in rs[0]["inverse_shapes"].items()},
            }
            for job, rs in by_job.items()
        },
        **shapes,
    }


def _p16_checkpoints(work, iters5: int, grid5) -> dict:
    """16e on one card: the linear heat march cut and resumed, and phase
    5's Navier-Stokes solve cut and resumed, both on the host loops."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow

    path = str(work / "heat.npz")
    half = LINEAR_HEAT_NT // 2
    _linear_heat_march(half, mf.CheckpointSettings(path, every=16))
    stats, _, wall, _, resumed = _linear_heat_march(
        LINEAR_HEAT_NT, mf.CheckpointSettings(path, every=16, resume_from=path)
    )
    _, _, _, _, whole = _linear_heat_march(
        LINEAR_HEAT_NT, mf.CheckpointSettings(str(work / "heat-whole.npz"), every=16)
    )
    gap_host = float(np.abs(resumed.point_data["u"] - whole.point_data["u"]).max())
    gap_dense = _field_rel(resumed.point_data["u"], REFERENCES["phase 12"].point_data["u"])
    print(
        f"phase 16e: linear heat march 16x16 p=4, {half} steps then resumed to"
        f" {LINEAR_HEAT_NT} (every=16): against the uninterrupted host march"
        f" {gap_host:.3e}, against phase 12's dense march {gap_dense:.3e} (relative)"
    )
    if not (gap_host <= 1e-13 and gap_dense <= 1e-10):
        raise RuntimeError("16e: the resumed heat march disagrees")

    model = flow.navier_stokes(10.0)
    path = str(work / "ns.npz")
    iterations = []
    for max_iter, resume in ((P16_CUT, None), (80, path)):
        mesh = mf.examples.unit_square_mesh(16, 16, 5)
        bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, flow.ns_velocity_exact)
        grids, stats, _ = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
            mf.SolverSettings(mf.ConvergenceSettings(max_iter, 1e-8, 0.0), relaxation=0.7),
            recon_order=10,
            device="cuda",
            checkpoint_settings=mf.CheckpointSettings(path, every=1, resume_from=resume),
        )
        iterations.append(int(stats.iter_history[0]))
    gap_ns = _field_rel(grids[-1].point_data["vel"], grid5.point_data["vel"])
    print(
        f"phase 16e: Navier-Stokes 16x16 p=5 direct, {iterations[0]} iterations then"
        f" {iterations[1]} resumed (phase 5: {iters5}), against phase 5 {gap_ns:.3e}"
    )
    if sum(iterations) != iters5 or not gap_ns <= 1e-12:
        raise RuntimeError("16e: the resumed Navier-Stokes solve disagrees")
    return {"heat_vs_host": gap_host, "heat_vs_dense": gap_dense, "ns_iterations": iterations,
            "ns_vs_phase5": gap_ns}


def _p16_kernels(run: dict) -> dict:
    """Both kernels at 16b's per-rank shapes, on rank 0's own elements of
    the 64x64 p=8 mesh, held against their plain versions and timed."""
    import mfv2d_torch as mf
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.evaluation import ElementBatch, compute_element_matrices
    from mfv2d_torch.models import poisson
    from mfv2d_torch.ops.basis import FemCache
    from mfv2d_torch.ops.kernels import gj_inverse
    from mfv2d_torch.solver.discretization import discretize_mesh

    system = poisson.mixed_poisson().system
    disc = discretize_mesh(
        mf.examples.unit_square_mesh(P16_MESH, P16_MESH, P16_ORDER), system.unknown_forms,
        FemCache(3), device="cuda",
    )
    bucket = disc.buckets[0]
    e = bucket.batch.n_elements // 2
    batch = ElementBatch(bucket.batch.basis, bucket.batch.corners_np[:e], "cuda")
    key_m1 = (batch.tb.p1, batch.tb.p2, batch.tb.w.size, e)
    m1 = _time_mass_edge(batch.tb, batch.jac, f"p={P16_ORDER} E={e} (a rank's half)",
                         "phase 16b", phase=16)
    m1["launches"] = run["m1_shapes"][key_m1]
    blocks = compute_element_matrices(disc.form_spec, CompiledSystem(system).linear_blocks, batch)
    out, ref = gj_inverse.gj_inverse(blocks), torch.linalg.inv(blocks)
    err = rel_err(out, ref)
    if not err <= INVERSE_TOL[torch.float64]:
        raise RuntimeError(f"16b: the inverse kernel disagrees at E={e}: {err:.3e}")
    inverse = _time_inverse(blocks, f"phase-16b blocks n={blocks.shape[1]} E={e}", phase=16)
    inverse["max_abs_err"] = float((out - ref).abs().max())
    inverse["launches"] = run["inverse_shapes"][(blocks.shape[1], e)]
    inverse["launches_in"] = "phase 16b"
    return {"mass_edge": m1, "gj_inverse": inverse}


def _p16_kernel_entries(parallel: dict) -> list[dict]:
    m1, inverse = parallel["mass_edge"], parallel["gj_inverse"]
    return [
        {
            "name": "mass_edge",
            "route": "cuda",
            "source": "mfv2d_torch/csrc/mass_edge.cu",
            "replaces": "mfv2d_tpu/ops/pallas_mass.py:113",
            **m1,
        },
        {
            **inverse,
            "name": "gj_inverse",
            "route": "cuda",
            "inverse_route": inverse["route"],
            "source": "mfv2d_torch/csrc/gj_inverse.cu",
            "replaces": "mfv2d_tpu/ops/pallas_factor.py:136",
            "plain_ms": inverse["library_ms"],
        },
    ]


def _p16_report(parallel: dict) -> dict:
    """Phase 16 alone (--probe parallel): its runs and its kernel entries."""
    return {"runs": parallel["runs"], "gaps": parallel["gaps"],
            "checkpoints": parallel["checkpoints"], "kernels": _p16_kernel_entries(parallel)}


# Phase 17: the rest of the element-sharded solver (Newton, the three
# marches and their checkpoints, refinement, VMS) over torch.distributed.
# The ranks are spawned as in phase 16 and build their problems by name.
# 17c: steps of each sharded cavity march, and the Picard march's cap of
# iterations a step (its 14 to convergence take over 60 s at 2 ranks on
# one card, 2.4 ms a GMRES iteration); the dense references take the same.
P17_CAVITY_NT, P17_CAVITY_PICARD_CAP = 1, 8
# 17f: config 5's orders at 1 rank on this mesh, the largest of 16x16,
# 32x32 and 64x64 under the time the phase allows (16x16 took 2.9 s).
P17_VMS_MESH = 32
P17_TOL = 1e-8


def _p17_problem(name: str, nt: int | None = None):
    """(mesh, system settings, solver settings without device_mesh, extra
    solve_system_2d arguments, recon order, field, exact or None) of a
    phase-17 problem, built by name."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow, transport

    def lid(x, y):
        on = np.isclose(y, 1.0)
        return np.stack((np.where(on, 1.0, 0.0), np.zeros_like(y)), axis=-1)

    if name == "ns newton":  # phase 11's Navier-Stokes by Newton
        model = flow.navier_stokes(10.0)
        mesh = mf.examples.unit_square_mesh(16, 16, 5)
        bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices,
                                          flow.ns_velocity_exact)
        return (mesh, mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
                mf.SolverSettings(mf.ConvergenceSettings(80, 1e-8, 0.0), linear_solver="gmres",
                                  method="newton"),
                {}, 10, "vel", flow.ns_velocity_exact)
    if name == "heat":  # BASELINE config 2, phase 12's march
        model = transport.heat_mixed(HEAT_ALPHA, HEAT_BETA, _heat_steady)
        return (mf.examples.unit_square_mesh(64, 64, 4), mf.SystemSettings(model.system),
                mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0)),
                {"time_settings": mf.TimeSettings(
                    dt=HEAT_T_END / HEAT_NT, nt=HEAT_NT,
                    time_march_relations=model.time_march_relations)},
                4, "u", None)
    if name in ("cavity picard", "cavity newton"):  # phase 12's cavity
        model = flow.cavity_flow(25.0, lid)
        mesh = mf.examples.unit_square_mesh(16, 16, 4)
        bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, lid)
        newton = name == "cavity newton"
        return (mesh, mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
                mf.SolverSettings(mf.ConvergenceSettings(30 if newton else P17_CAVITY_PICARD_CAP,
                                                         1e-8, 0),
                                  relaxation=1.0 if newton else 0.8, linear_solver="gmres",
                                  method="newton" if newton else "picard"),
                {"time_settings": mf.TimeSettings(
                    dt=0.25, nt=P17_CAVITY_NT, time_march_relations=model.time_march_relations)},
                4, "vel", None)
    if name == "linear heat":  # phase 16e's checkpointed march
        mesh, settings, solver, time_settings = _linear_heat_problem(nt)
        return mesh, settings, solver, {"time_settings": time_settings}, 4, "u", None
    if name == "hp round":  # phase 14's first round
        model = transport.linear_advection_diffusion(HP_NU, _hp_wind, _hp_u, _hp_source)
        return (mf.examples.unit_square_mesh(32, 32, 4), mf.SystemSettings(model.system),
                mf.SolverSettings(mf.ConvergenceSettings(100, 1e-10, 0), linear_solver="gmres"),
                {"refinement_settings": mf.RefinementSettings(
                    mf.ErrorEstimateLocalInverse(model.u, 1),
                    mf.RefinementLimitElementCount(0.1, 128),
                    h_refinement_ratio=HP_H_RATIO, upper_order_limit=8)},
                4, "u", _hp_u)
    # "vms N p": _vms_solve's setup (phase 15) on an N x N mesh at order p.
    _, n, p = name.split()
    model, symmetric = _vms_systems(_vms_u, _vms_source)
    return (mf.examples.unit_square_mesh(int(n), int(n), int(p)),
            mf.SystemSettings(model.system, over_integration_order=3),
            mf.SolverSettings(mf.ConvergenceSettings(40, 1e-9, 0), linear_solver="schur_direct",
                              anderson_m=3),
            {"vms_settings": mf.VMSSettings(
                symmetric_system=symmetric, nonsymmetric_system=model.system, order_increase=2,
                fine_scale_convergence=mf.ConvergenceSettings(10, 1e-10, 1e-8),
                matrix_free=True)},
            8, "u", _vms_u)


def _p17_job(mesh, problem: str, nt=None, path=None, every=None, resume=None) -> dict:
    """One sharded solve of phase 17 on this rank, with what it launched
    and reduced; the estimator of a refining solve is not recorded (it
    runs on every element on each rank, at the shapes phase 14 timed)."""
    import hashlib
    from dataclasses import replace

    import mfv2d_torch as mf
    from mfv2d_torch.checkpoint import mesh_to_arrays
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.parallel.sharding import TraceComm
    from mfv2d_torch.tracing import tracer

    orchestrator = importlib.import_module("mfv2d_torch.solve_system_2d")
    comm = TraceComm(mesh)
    fe_mesh, settings, solver, extra, recon, field, exact = _p17_problem(problem, nt)
    solver = replace(solver, device_mesh=comm)
    if path is not None:
        extra["checkpoint_settings"] = mf.CheckpointSettings(path, every=every, resume_from=resume)
    if resume is not None:
        from mfv2d_torch.checkpoint import load_march_state

        fe_mesh = load_march_state(resume)["mesh"]
    outer = _KernelRecorder.active[0]
    perform = orchestrator.perform_mesh_refinement

    def unrecorded_refinement(*args, **kwargs):
        part, outer.part = outer.part, None
        try:
            return perform(*args, **kwargs)
        finally:
            outer.part = part

    raw_before = P16_RAW_REDUCES[0]
    orchestrator.perform_mesh_refinement = unrecorded_refinement
    try:
        with _KernelRecorder() as rec:
            rec.part = problem
            mass_edge.launches = 0
            gj_inverse.launches = 0
            tracer.enable()
            tracer.reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grids, stats, out_mesh = mf.solve_system_2d(
                fe_mesh, settings, solver, recon_order=recon, **extra
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tracer.disable()
            launches = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
    finally:
        orchestrator.perform_mesh_refinement = perform
    fields = [dict(g.point_data) for g in grids]
    digest = hashlib.sha256()
    for f in fields:
        for key in sorted(f):
            digest.update(np.ascontiguousarray(f[key]).tobytes())
    refine = "refinement_settings" in extra
    return {
        "device": str(comm.device),
        "backend": comm.backend,
        "digest": digest.hexdigest(),
        # Rank 0 sends the grids; the others send their digest.
        "fields": fields if comm.rank == 0 else None,
        "times": [float(g.field_data["time"][0]) for g in grids],
        "error": None if exact is None else _l2_point_error(grids[-1], field, exact),
        "iterations": stats.iter_history.tolist(),
        "residuals": stats.residual_history.tolist(),
        "unknowns": int(stats.n_total_dofs),
        "multipliers": int(stats.n_lagrange),
        "element_orders": dict(stats.element_orders),
        "buckets": len(stats.element_orders),
        "mesh": mesh_to_arrays(out_mesh) if refine else None,
        "estimate": grids[-1].cell_data["error_estimate"] if refine else None,
        "counts": dict(comm.counts),
        "matvecs": comm.matvecs,
        "krylov": list(comm.krylov),
        "raw_reduces": P16_RAW_REDUCES[0] - raw_before,
        "wall_s": wall,
        "stages": {k: v[1] for k, v in tracer.stages.items()},
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "m1_shapes": {k: sum(v["launches"].values()) for k, v in rec.mass_edge.items()},
        "inverse_shapes": {k: sum(v["launches"].values()) for k, v in rec.gj_inverse.items()},
    }


def _p17_time_recorded(rec, phase="17", where=" on a rank") -> dict:
    """Both kernels held against their plain versions and timed at every
    shape the recorder's runs launched them on, with the launches of each
    run."""
    from mfv2d_torch.ops.kernels import gj_inverse

    mass_timing = []
    for (p1, p2, nq, e), entry in sorted(rec.mass_edge.items()):
        tb, jac = entry["inputs"]
        timing = _time_mass_edge(
            tb, jac, f"p=({p1},{p2}) nq={nq} E={e}{where}",
            f"phase {', '.join(entry['launches'])}", phase=phase,
            plain_max=KERNEL_MAX_BATCH_HIGH if max(p1, p2) > 8 else None,
        )
        timing["m1_shape"] = [p1, p2, nq, e]
        timing["launches"] = sum(entry["launches"].values())
        timing["launches_by_run"] = entry["launches"]
        mass_timing.append(timing)
    inverse_timing = []
    for (n, e), entry in sorted(rec.gj_inverse.items()):
        (a,) = entry["inputs"]
        out, ref = gj_inverse.gj_inverse(a), torch.linalg.inv(a)
        err = rel_err(out, ref)
        if not err <= INVERSE_TOL[torch.float64]:
            raise RuntimeError(f"{phase}: the inverse kernel disagrees at n={n}, E={e}: {err:.3e}")
        timing = _time_inverse(a, f"phase-{phase} blocks n={n} E={e}{where}", phase=phase)
        timing["max_abs_err"] = float((out - ref).abs().max())
        timing["launches"] = sum(entry["launches"].values())
        timing["launches_by_run"] = entry["launches"]
        timing["launches_in"] = f"phase {', '.join(entry['launches'])}"
        inverse_timing.append(timing)
        del out, ref
    return {"mass_edge": mass_timing, "gj_inverse": inverse_timing}


def _p17_references(work) -> None:
    """Run again the earlier phases whose results phase 17 compares with,
    and the single-device runs that only phase 17 needs."""
    from dataclasses import replace

    import mfv2d_torch as mf

    if "phase 11" not in REFERENCES:
        iters, _, _, _, grid = _navier_stokes("direct", method="newton")
        REFERENCES["phase 11"] = (iters, grid)
    if "phase 12 heat" not in REFERENCES:
        _, err, _, _, _, grids = _heat_march(64, 4, "direct")
        REFERENCES["phase 12 heat"] = (grids, err)
    if "phase 12" not in REFERENCES:
        REFERENCES["phase 12"] = _linear_heat_march()[4]
    if "phase 14 round 1" not in REFERENCES:
        grid, stats, mesh, _, _, _, _ = _hp_solve(mf.examples.unit_square_mesh(32, 32, 4),
                                                  "direct", refine=True)
        e, c = grid.cell_data["error_estimate"], grid.cell_data["h_ref_cost_estimate"]
        REFERENCES["phase 14 round 1"] = (
            stats, mesh, (float(e.sum()), float(e.max()), float(c.sum()), float(c.max()))
        )
    if "phase 15a matrix-free" not in REFERENCES:
        REFERENCES["phase 15a matrix-free"] = _vms_solve(8, 4, True)
    # The single-device dense cavity marches over 17c's steps.
    for method in ("picard", "newton"):
        fe_mesh, settings, solver, extra, recon, _, _ = _p17_problem(f"cavity {method}")
        grids, stats, _ = mf.solve_system_2d(
            fe_mesh, settings, replace(solver, linear_solver="dense"), recon_order=recon,
            device="cuda", **extra,
        )
        REFERENCES[f"17c dense {method}"] = (stats.iter_history.tolist(),
                                             grids[-1].point_data["vel"])
    # 17f: the single-device VMS solves of config 5's orders on 17f's meshes.
    for mesh_n in (16, P17_VMS_MESH):
        run, grid = _vms_solve(mesh_n, CONFIG5_ORDER, True, keep_grid=True)
        REFERENCES[f"17f single {mesh_n}"] = (run, grid.point_data["u"], grid.point_data["vms-u"])
    # 17d: the single-device host march to the cut, and uninterrupted.
    half = LINEAR_HEAT_NT // 2
    _linear_heat_march(half, mf.CheckpointSettings(str(work / "single-cut.npz"), every=half))
    REFERENCES["17d single whole"] = _linear_heat_march(
        LINEAR_HEAT_NT,
        mf.CheckpointSettings(str(work / "single-whole.npz"), every=LINEAR_HEAT_NT),
    )[4].point_data["u"]


def _p17_expected_counts(r: dict, kind: str) -> dict:
    """The all_reduce calls by tag, less the trace matvecs', that a rank of
    a phase-17 solve must make.  A residual evaluation reduces the trace
    value and the norm, a correction the Schur right-hand side; each bucket
    reduces once at set-up and once more a Newton step (the inverses of its
    Jacobians); a march reduces the scale of each nonlinear step's
    tolerance and gathers its samples once, and the host march gathers
    three times a checkpoint (``checkpoints``)."""
    iters, buckets = r["iterations"], r["buckets"]
    updates = len(r["krylov"])
    if kind == "newton steady":
        evals = iters[0]
        return {"setup": buckets * updates, "residual": evals, "norm": evals,
                "rhs": updates, "gather": 1}
    if kind == "linear march":
        nt = len(iters)
        return {"setup": buckets, "residual": nt, "rhs": nt, "gather": 1}
    if kind == "picard march":
        # A step that stops at its cap of corrections (``cap``) evaluates
        # no residual after its last one.
        nt, corrections = len(iters), sum(iters)
        evals = sum(i + (i < r.get("cap", float("inf"))) for i in iters)
        return {"setup": buckets, "magnitude": nt, "residual": evals, "norm": evals,
                "rhs": corrections, "gather": 1}
    if kind == "picard steady":
        evals = iters[0]
        return {"setup": buckets, "residual": evals, "norm": evals, "rhs": updates,
                "gather": 1}
    # The host march: iterations count residual evaluations (none in the
    # steps a resumed march skips); Newton rebuilds from a step's second
    # correction on.
    nt, evals = sum(1 for i in iters if i), sum(iters)
    rebuilds = sum(max(0, i - 2) for i in iters) if kind == "newton march" else 0
    return {"setup": buckets * (1 + rebuilds), "magnitude": nt, "residual": evals,
            "norm": evals, "rhs": updates, "gather": 1 + 3 * r.get("checkpoints", 0)}


def _p17_check_ranks(label: str, ranks: list[dict], kind: str | None) -> None:
    """Every rank returns the same answer, and its all_reduce calls add up:
    every one is tagged, the matvecs make one each and, where the solve's
    shape fixes them (``kind``), the others are the ones it must make."""
    for rank, r in enumerate(ranks):
        if r["digest"] != ranks[0]["digest"]:
            raise RuntimeError(f"{label}: rank {rank} returned another answer")
        counts = r["counts"]
        others = {tag: n for tag, n in counts.items() if tag != "schur"}
        ok = (
            r["raw_reduces"] == sum(counts.values())
            and counts.get("schur", 0) == r["matvecs"]
            and r["raw_reduces"] - sum(others.values()) == r["matvecs"]
        )
        if kind is not None:
            want = {tag: n for tag, n in _p17_expected_counts(r, kind).items() if n}
            ok = ok and others == want
        if not ok:
            raise RuntimeError(
                f"{label}: rank {rank}: {counts} ({r['raw_reduces']} in all) for"
                f" {r['matvecs']} matvecs, {r['iterations']} iterations,"
                f" {len(r['krylov'])} updates" + ("" if kind is None else f"; want {want}")
            )
        if not (r["launches"]["mass_edge"] > 0 and r["launches"]["gj_inverse"] > 0):
            raise RuntimeError(f"{label}: rank {rank} launched {r['launches']}")


def _p17_print(label: str, ranks: list[dict]) -> None:
    r0 = ranks[0]
    krylov = [k for _, k in r0["krylov"]]
    print(
        f"phase {label}: {len(ranks)} rank(s), backend {r0['backend']}, devices"
        f" {[r['device'] for r in ranks]}: {r0['unknowns']} unknowns ({r0['multipliers']}"
        f" multipliers), iterations {r0['iterations']}, trace Krylov solves {len(krylov)}"
        f" ({sum(krylov)} iterations, {r0['krylov'][0][0] if krylov else '-'}), error"
        f" {r0['error']!r}, wall {r0['wall_s']:.3f} s, peak {r0['peak_bytes']} bytes a rank"
    )
    for rank, r in enumerate(ranks):
        print(
            f"  rank {rank}: all_reduce calls {r['counts']} ({r['raw_reduces']} in all),"
            f" trace matvecs {r['matvecs']}, launches {r['launches']}, M1 by (p1, p2, nq, E)"
            f" {r['m1_shapes']}, inverse by (n, E) {r['inverse_shapes']}"
        )
    for stage, total in sorted(r0["stages"].items(), key=lambda kv: -kv[1]):
        print(f"  stage {stage:40s} {total:9.4f} s")


def phase17_parallel() -> dict:
    import shutil

    from examples_torch.common import spawn_ranks

    import mfv2d_torch as mf
    from mfv2d_torch.checkpoint import load_march_state

    work = ROOT / "build" / "phase17"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    _p17_references(work)
    two_cards = torch.cuda.device_count() >= 2
    backend = "nccl" if two_cards else "gloo"
    half = LINEAR_HEAT_NT // 2
    cut, resumed = str(work / "cut.npz"), str(work / "resumed.npz")
    single_cut = str(work / "single-cut.npz")
    two = spawn_ranks(_p16_rank, [
        ("17a", {"job": "_p17_job", "problem": "ns newton"}),
        ("17b 2 ranks", {"job": "_p17_job", "problem": "heat"}),
        ("17b linear", {"job": "_p17_job", "problem": "linear heat", "nt": LINEAR_HEAT_NT}),
        ("17c picard", {"job": "_p17_job", "problem": "cavity picard"}),
        ("17c newton", {"job": "_p17_job", "problem": "cavity newton"}),
        ("17d cut", {"job": "_p17_job", "problem": "linear heat", "nt": half, "path": cut,
                     "every": half}),
        ("17d resumed", {"job": "_p17_job", "problem": "linear heat", "nt": LINEAR_HEAT_NT,
                         "path": resumed, "every": LINEAR_HEAT_NT, "resume": cut}),
        ("17d whole", {"job": "_p17_job", "problem": "linear heat", "nt": LINEAR_HEAT_NT,
                       "path": str(work / "whole.npz"), "every": LINEAR_HEAT_NT}),
        ("17d from single", {"job": "_p17_job", "problem": "linear heat",
                             "nt": LINEAR_HEAT_NT, "path": str(work / "from-single.npz"),
                             "every": LINEAR_HEAT_NT, "resume": single_cut}),
        ("17e", {"job": "_p17_job", "problem": "hp round"}),
        ("17f 8x8", {"job": "_p17_job", "problem": "vms 8 4"}),
        ("17f config 5 orders 2 ranks", {"job": "_p17_job",
                                         "problem": f"vms 16 {CONFIG5_ORDER}"}),
    ], True, world=2, backend=backend)
    one = spawn_ranks(_p16_rank, [
        ("17b 1 rank", {"job": "_p17_job", "problem": "heat"}),
        ("17f config 5 orders", {"job": "_p17_job",
                                 "problem": f"vms {P17_VMS_MESH} {CONFIG5_ORDER}"}),
    ], True, world=1)
    by_job = {name: [r[name] for r in two] for name in two[0] if name != "kernels"}
    by_job.update({name: [r[name] for r in one] for name in one[0] if name != "kernels"})
    for name, ranks in by_job.items():
        _p17_print(name, ranks)
    gaps = {}

    # 17a: Newton at 2 ranks against phase 11's "direct" Newton.
    a = by_job["17a"][0]
    iters11, grid11 = REFERENCES["phase 11"]
    gaps["17a"] = _field_rel(a["fields"][-1]["vel"], grid11.point_data["vel"])
    n121 = 121
    e_rank = _p17_problem("ns newton")[0].leaf_count // 2
    print(
        f"  17a: {len(a['krylov'])} Newton corrections (phase 11: {iters11}; the JAX package:"
        f" {JAX_NEWTON_ITERATIONS['direct']}), velocity against phase 11: {gaps['17a']:.3e}"
    )
    for rank, r in enumerate(by_job["17a"]):
        if r["inverse_shapes"].get((n121, e_rank), 0) != len(r["krylov"]):
            raise RuntimeError(f"17a: rank {rank} inverted {r['inverse_shapes']}, not once a"
                               f" Newton step at n={n121}, E={e_rank}")
    if len(a["krylov"]) != iters11 or not gaps["17a"] <= P17_TOL:
        raise RuntimeError(f"17a: {len(a['krylov'])} corrections, {gaps['17a']:.3e}")
    _p17_check_ranks("17a", by_job["17a"], "newton steady")

    # 17b: config 2's march at 1 and 2 ranks against phase 12's.  Its
    # reaction term sits on the right-hand side, so the JAX package's routing
    # (by the compiled system) takes it to the Picard march, as the
    # single-device path iterates each of its steps; the linear march runs
    # 16e's heat march, against phase 12's dense march.
    grids12, err12 = REFERENCES["phase 12 heat"]
    for name in ("17b 1 rank", "17b 2 ranks"):
        b = by_job[name][0]
        gap = max(
            max(float(np.abs(f[k] - g.point_data[k]).max()) for f, g in zip(b["fields"], grids12))
            / max(float(np.abs(g.point_data[k]).max()) for g in grids12)
            for k in ("u", "q")
        )
        t_end = b["times"][-1]
        err = _l2_point_error_fields(b["fields"][-1], grids12[-1], t_end)
        gaps[name] = gap
        cg = [k for _, k in b["krylov"]]
        print(
            f"  {name}: {len(b['fields'])} grids (phase 12: {len(grids12)}), every state"
            f" against phase 12's direct march {gap:.3e} (relative to the largest value),"
            f" error at t={t_end} {err!r} (phase 12: {err12!r}), Picard iterations a step"
            f" {b['iterations']}, {len(cg)} trace CG solves of {min(cg)}-{max(cg)}"
            f" iterations ({sum(cg)} in all)"
        )
        if len(b["fields"]) != len(grids12) or not gap <= P17_TOL:
            raise RuntimeError(f"{name}: {gap:.3e} from phase 12")
        if not abs(err - err12) <= P17_TOL * err12:
            raise RuntimeError(f"{name}: error {err!r}, phase 12 {err12!r}")
        _p17_check_ranks(name, by_job[name], "picard march")
    linear = by_job["17b linear"][0]
    gaps["17b linear"] = _field_rel(linear["fields"][-1]["u"],
                                    REFERENCES["phase 12"].point_data["u"])
    print(
        f"  17b linear: 16x16 p=4 heat march, {LINEAR_HEAT_NT} steps at 2 ranks, against"
        f" phase 12's dense march {gaps['17b linear']:.3e}"
    )
    if not gaps["17b linear"] <= P17_TOL:
        raise RuntimeError(f"17b linear: {gaps['17b linear']:.3e} from phase 12")
    _p17_check_ranks("17b linear", by_job["17b linear"], "linear march")
    e_half = _p17_problem("heat")[0].leaf_count // 2
    for rank, r in enumerate(by_job["17b 2 ranks"]):
        if not any(k[3] == e_half for k in r["m1_shapes"]) or r["inverse_shapes"].get(
            (56, e_half), 0
        ) <= 0:
            raise RuntimeError(f"17b: rank {rank} did not launch both kernels at E={e_half}")

    # 17c: the Picard and the Newton (host) marches against the single-device
    # dense ones.
    for method in ("picard", "newton"):
        c = by_job[f"17c {method}"][0]
        dense_iters, dense_vel = REFERENCES[f"17c dense {method}"]
        # The sharded host Newton march counts residual evaluations, one
        # more than the corrections the Picard and the single-device
        # marches count.
        want = [i + (method == "newton") for i in dense_iters]
        gaps[f"17c {method}"] = _field_rel(c["fields"][-1]["vel"], dense_vel)
        print(
            f"  17c {method}: iterations a step {c['iterations']} (dense {dense_iters}),"
            f" last residuals {c['residuals']}, velocity against the dense march"
            f" {gaps[f'17c {method}']:.3e}"
        )
        if c["iterations"] != want or not gaps[f"17c {method}"] <= P17_TOL:
            raise RuntimeError(f"17c {method}: {c['iterations']}, {gaps[f'17c {method}']:.3e}")
    for r in by_job["17c picard"]:
        r.update(cap=P17_CAVITY_PICARD_CAP)
    _p17_check_ranks("17c picard", by_job["17c picard"], "picard march")
    _p17_check_ranks("17c newton", by_job["17c newton"], "newton march")

    # 17d: the checkpointed sharded march, and its files across the paths.
    whole = by_job["17d whole"][0]["fields"][-1]["u"]
    res = by_job["17d resumed"][0]
    scale = float(np.abs(whole).max())
    gaps["17d resumed"] = float(np.abs(res["fields"][-1]["u"] - whole).max()) / scale
    gaps["17d from single"] = float(
        np.abs(by_job["17d from single"][0]["fields"][-1]["u"] - whole).max()) / scale
    _, _, _, _, to_single = _linear_heat_march(
        LINEAR_HEAT_NT,
        mf.CheckpointSettings(str(work / "to-single.npz"), every=LINEAR_HEAT_NT, resume_from=cut),
    )
    single_whole = REFERENCES["17d single whole"]
    gaps["17d to single"] = _field_rel(to_single.point_data["u"], single_whole)
    gaps["17d whole vs single"] = _field_rel(whole, single_whole)
    cut_state = load_march_state(cut)
    print(
        f"  17d: cut at step {cut_state['time_index']} and resumed to {LINEAR_HEAT_NT}:"
        f" {gaps['17d resumed']:.3e} from the uninterrupted 2-rank march; the single-device"
        f" cut file resumed at 2 ranks {gaps['17d from single']:.3e}; the 2-rank cut file"
        f" resumed on the single-device host loop {gaps['17d to single']:.3e} from its"
        f" uninterrupted march (the 2-rank march {gaps['17d whole vs single']:.3e} from it)"
    )
    if not (
        cut_state["time_index"] == half
        and np.isclose(res["times"][0], half * LINEAR_HEAT_DT)
        and gaps["17d resumed"] <= 1e-12
        and max(gaps["17d from single"], gaps["17d to single"],
                gaps["17d whole vs single"]) <= 1e-10
    ):
        raise RuntimeError(f"17d: {gaps}")
    for name in ("17d cut", "17d resumed", "17d whole", "17d from single"):
        for r in by_job[name]:
            r.update(checkpoints=1)
        _p17_check_ranks(name, by_job[name], "picard host march")

    # 17e: phase 14's first round at 2 ranks.
    e = by_job["17e"][0]
    stats14, mesh14, digest14 = REFERENCES["phase 14 round 1"]
    from mfv2d_torch.checkpoint import mesh_from_arrays

    refined = mesh_from_arrays(e["mesh"])
    orders = {}
    for i in refined.get_leaf_indices():
        o = tuple(int(v) for v in refined.get_leaf_orders(int(i)))
        orders[o] = orders.get(o, 0) + 1
    ref_orders = [tuple(mesh14.get_leaf_orders(int(i))) for i in mesh14.get_leaf_indices()]
    mine = [tuple(refined.get_leaf_orders(int(i))) for i in refined.get_leaf_indices()]
    est = e["estimate"]
    digest = (float(est.sum()), float(est.max()))
    print(
        f"  17e: {e['element_orders']}, {e['unknowns']} unknowns (phase 14 round 1:"
        f" {stats14.element_orders}, {stats14.n_total_dofs}), refined to {orders}"
        f" ({refined.leaf_count} leaves; phase 14: {mesh14.leaf_count}; the JAX package"
        f" {JAX_HP_ROUNDS[1][0]}), estimate (sum, max) {digest!r} (phase 14:"
        f" {digest14[:2]!r}), every rank's mesh alike:"
        f" {all(_same_mesh(r['mesh'], e['mesh']) for r in by_job['17e'])}"
    )
    if (
        e["element_orders"] != stats14.element_orders
        or e["unknowns"] != stats14.n_total_dofs
        or orders != JAX_HP_ROUNDS[1][0]
        or mine != ref_orders
        or not all(_same_mesh(r["mesh"], e["mesh"]) for r in by_job["17e"])
        or not all(abs(x - y) <= P17_TOL * abs(y) for x, y in zip(digest, digest14))
    ):
        raise RuntimeError("17e: the sharded round refines otherwise than phase 14")
    _p17_check_ranks("17e", by_job["17e"], "picard steady")

    # 17f: VMS at 2 ranks against 15a, and config 5's orders at 1 rank
    # against the single-device solve of the same setup.
    f8 = by_job["17f 8x8"][0]
    run15 = REFERENCES["phase 15a matrix-free"]
    vms8 = float(np.abs(f8["fields"][-1]["vms-u"]).max())
    print(
        f"  17f 8x8 p=4 +2, 2 ranks: {f8['iterations'][0]} residual evaluations (15a:"
        f" {run15['iterations']} Picard iterations), u error {f8['error']!r} (15a:"
        f" {run15['u_error']!r}), max |vms-u| {vms8!r} (15a: {run15['vms_max']!r})"
    )
    if (
        abs(f8["iterations"][0] - (run15["iterations"] + 1)) > 1
        or not abs(f8["error"] - run15["u_error"]) <= P17_TOL * run15["u_error"]
        or not (np.isfinite(vms8) and vms8 > 0)
    ):
        raise RuntimeError("17f: the 2-rank VMS solve disagrees with 15a")
    # The sharded branch's vms-u is the dual projection of the recovered
    # fine scales, the single-device branch's that of the unresolved-scale
    # forcing (in both packages), so the two maxima are printed, not held
    # to each other; tests/test_torch_parallel_vms.py holds the sharded one
    # to the JAX package's sharded solve.
    for name, mesh_n in (("17f config 5 orders 2 ranks", 16),
                         ("17f config 5 orders", P17_VMS_MESH)):
        f5 = by_job[name][0]
        run_s, u_s, vms_s = REFERENCES[f"17f single {mesh_n}"]
        gaps[name] = _field_rel(f5["fields"][-1]["u"], u_s)
        vms5 = float(np.abs(f5["fields"][-1]["vms-u"]).max())
        print(
            f"  {name}: {mesh_n}x{mesh_n} p=8 +2, {f5['iterations'][0]} residual evaluations"
            f" (single device: {run_s['iterations']} Picard iterations), u against the"
            f" single-device solve {gaps[name]:.3e}, u error {f5['error']!r} (single device"
            f" {run_s['u_error']!r}), max |vms-u| {vms5!r} (single device, the unresolved"
            f" forcing's: {float(np.abs(vms_s).max())!r}), wall {f5['wall_s']:.3f} s (single"
            f" device {run_s['wall_s']:.3f} s)"
        )
        if (
            abs(f5["iterations"][0] - (run_s["iterations"] + 1)) > 1
            or not gaps[name] <= P17_TOL
            or not np.isfinite(vms5)
        ):
            raise RuntimeError(f"{name}: the VMS solve disagrees with the single-device one")
    for name in ("17f 8x8", "17f config 5 orders 2 ranks", "17f config 5 orders"):
        _p17_check_ranks(name, by_job[name], None)

    kernels = {key: two[0]["kernels"][key] + one[0]["kernels"][key]
               for key in ("mass_edge", "gj_inverse")}
    runs = {
        job: {k: v for k, v in rs[0].items() if k not in ("fields", "mesh", "estimate", "digest")}
        | {"m1_shapes": {str(k): v for k, v in rs[0]["m1_shapes"].items()},
           "inverse_shapes": {str(k): v for k, v in rs[0]["inverse_shapes"].items()},
           "element_orders": {str(k): v for k, v in rs[0]["element_orders"].items()}}
        for job, rs in by_job.items()
    }
    return {"gaps": gaps, "runs": runs, **kernels}


def _same_mesh(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _l2_point_error_fields(fields: dict, grid, t_end: float) -> float:
    """Phase 12's error at ``t_end`` (config 2's exact solution) of the
    point data ``fields``, reconstructed on ``grid``'s points."""
    decay = 1 - np.exp(-HEAT_BETA * t_end)
    x, y = grid.points[:, 0], grid.points[:, 1]
    return float(np.sqrt(np.mean((fields["u"] - _heat_steady(x, y) * decay) ** 2)))


def _p17_kernel_entries(parallel: dict) -> list[dict]:
    """The kernel-line entries of phase 17 (and 18, 18b): both kernels at
    every shape its runs launched them on."""
    entries = [
        {"name": "mass_edge", "route": "cuda", "source": "mfv2d_torch/csrc/mass_edge.cu",
         "replaces": "mfv2d_tpu/ops/pallas_mass.py:113", **timing}
        for timing in parallel["mass_edge"]
    ]
    entries += [
        {**timing, "name": "gj_inverse", "route": "cuda", "inverse_route": timing["route"],
         "source": "mfv2d_torch/csrc/gj_inverse.cu",
         "replaces": "mfv2d_tpu/ops/pallas_factor.py:136", "plain_ms": timing["library_ms"]}
        for timing in parallel["gj_inverse"]
    ]
    return entries


# Phase 18: the port's example gallery (examples_torch/), every script at
# its own size on the card.  The JAX gallery's report values on the CPU, at
# full precision, printed by `JAX_PLATFORMS=cpu python3
# tools/gallery_reference.py` (the card has no jax): by script, its report
# titles and values in order.
JAX_GALLERY = {
    'parallel/multichip_poisson.py': [
        ('multichip_poisson p=3 devices=1', {
            'l2_u': 0.0011865683739414074, 'h1_q': 0.001503190235298439,
        }),
        ('multichip_poisson p=4 devices=1', {
            'l2_u': 5.4590592818686986e-05, 'h1_q': 6.24413352304707e-05,
        }),
    ],
    'parallel/multichip_vms.py': [
        ('multichip_vms 4x4 p=4+2 devices=1', {
            'l2_u': 0.00010051389238820752, 'picard_iters': 20.0,
            'final_residual': 3.6477645428483503e-10, 'max_fine_scale': 1.1900584090673849e-05,
        }),
    ],
    'refinement/advdif_hp.py': [
        ('advdif_hp round=0', {'err': 0.07280522512513271, 'dofs': 144.0, 'leaves': 9.0}),
        ('advdif_hp round=1', {'err': 0.058860188457781196, 'dofs': 195.0, 'leaves': 9.0}),
        ('advdif_hp round=2', {'err': 0.049935257047890876, 'dofs': 246.0, 'leaves': 9.0}),
        ('advdif_hp round=3', {'err': 0.046181431748856694, 'dofs': 326.0, 'leaves': 9.0}),
    ],
    'refinement/advdif_hp_projection.py': [
        ('advdif_hp_projection final', {
            'p_err': 0.00062282867383568, 'hp_err': 0.0004836825114700663,
            'h_err': 0.008295406978584406,
        }),
    ],
    'refinement/direct_poisson_refined.py': [
        ('explicit round=0', {'err': 0.01968618618561526, 'dofs': 336.0, 'leaves': 16.0}),
        ('explicit round=1', {'err': 0.004852365424325188, 'dofs': 431.0, 'leaves': 16.0}),
        ('explicit round=2', {'err': 0.004480566755279371, 'dofs': 556.0, 'leaves': 16.0}),
        ('explicit round=3', {'err': 0.004425737072153231, 'dofs': 711.0, 'leaves': 16.0}),
        ('order_reduction round=0', {'err': 0.01968618618561526, 'dofs': 336.0, 'leaves': 16.0}),
        ('order_reduction round=1', {'err': 0.004852365424325187, 'dofs': 431.0, 'leaves': 16.0}),
        ('order_reduction round=2', {'err': 0.00427457470640668, 'dofs': 550.0, 'leaves': 16.0}),
        ('order_reduction round=3', {'err': 0.0021004018456124676, 'dofs': 645.0, 'leaves': 16.0}),
        ('local_inverse round=0', {'err': 0.01968618618561526, 'dofs': 336.0, 'leaves': 16.0}),
        ('local_inverse round=1', {'err': 0.028090661737292247, 'dofs': 391.0, 'leaves': 31.0}),
        ('local_inverse round=2', {'err': 0.01691304649478192, 'dofs': 469.0, 'leaves': 31.0}),
        ('local_inverse round=3', {'err': 0.02482653459413779, 'dofs': 539.0, 'leaves': 43.0}),
    ],
    'refinement/poisson_hp_strategies.py': [
        ('poisson_hp_strategies final', {
            'p_err': 0.0006017741049349605, 'hp_err': 0.0006017741049349605,
            'h_err': 0.007925619598638923,
        }),
    ],
    'steady/direct_poisson.py': [
        ('direct_poisson p=1', {'l2_u': 0.02872195005897609}),
        ('direct_poisson p=2', {'l2_u': 0.0013105768678966132}),
        ('direct_poisson p=3', {'l2_u': 4.586584818851172e-05}),
        ('direct_poisson p=4', {'l2_u': 1.3874872180982068e-06}),
        ('direct_poisson p=5', {'l2_u': 3.6535887473573134e-08}),
        ('direct_poisson p=6', {'l2_u': 8.491285433115592e-10}),
    ],
    'steady/linear_adv_dif.py': [
        ('linear_adv_dif p=2', {'l2_u': 0.03938643560777691}),
        ('linear_adv_dif p=3', {'l2_u': 0.0028706411668760886}),
        ('linear_adv_dif p=4', {'l2_u': 0.00016202526730300576}),
        ('linear_adv_dif p=5', {'l2_u': 6.912266801406809e-06}),
    ],
    'steady/mixed_poisson.py': [
        ('mixed_poisson p=1', {'l2_u': 0.39216627959890954, 'h1_q': 0.36704856859755014}),
        ('mixed_poisson p=2', {'l2_u': 0.01985027765752812, 'h1_q': 0.027462326787966482}),
        ('mixed_poisson p=3', {'l2_u': 0.001133160041063963, 'h1_q': 0.0014367047171939837}),
        ('mixed_poisson p=4', {'l2_u': 5.125286621069403e-05, 'h1_q': 5.8817321242751336e-05}),
        ('mixed_poisson p=5', {'l2_u': 1.8763920041767378e-06, 'h1_q': 2.000048617196399e-06}),
        ('mixed_poisson p=6', {'l2_u': 5.864531203033873e-08, 'h1_q': 5.814660400220041e-08}),
    ],
    'steady/navier_stokes.py': [
        ('navier_stokes Re=10.0 iters=18', {
            'err_vel': 5.107046837265608e-07, 'err_vor': 5.859642399811938e-08,
        }),
    ],
    'steady/stokes_flow.py': [
        ('stokes p=2', {
            'err_vel': 0.00714039451252582, 'err_vor': 0.0008564784737874957,
            'div_max': 1.078932413231471e-15,
        }),
        ('stokes p=4', {
            'err_vel': 1.174339477586483e-05, 'err_vor': 5.907655279327018e-07,
            'div_max': 8.480262568752255e-15,
        }),
        ('stokes p=6', {
            'err_vel': 7.324256212738104e-09, 'err_vor': 2.035283325132041e-10,
            'div_max': 3.139129912028664e-14,
        }),
    ],
    'unsteady/cavity_flow.py': [
        ('cavity_flow', {'max_speed': 1.018806347154015, 'kinetic_energy': 0.061647560120770654}),
    ],
    'unsteady/forced_heat.py': [
        ('forced_heat nt=  8', {'max_err': 0.0002626978357074261}),
        ('forced_heat nt= 16', {'max_err': 6.552947857252356e-05}),
        ('forced_heat nt= 32', {'max_err': 1.9669489449980482e-05}),
    ],
    'unsteady/heat_direct.py': [
        ('heat_direct nt=4', {'dt': 0.5, 'err': 0.0028660627693435138}),
        ('heat_direct nt=8', {'dt': 0.25, 'err': 0.000706317977103994}),
        ('heat_direct nt=16', {'dt': 0.125, 'err': 0.00017528162740728132}),
        ('heat_direct nt=32', {'dt': 0.0625, 'err': 4.45026682160512e-05}),
        ('heat_direct nt=64', {'dt': 0.03125, 'err': 1.63725262046298e-05}),
    ],
    'unsteady/heat_mixed.py': [
        ('heat_mixed nt=8', {'dt': 0.25, 'err': 0.0008377037453601754}),
        ('heat_mixed nt=16', {'dt': 0.125, 'err': 0.00044415804351221114}),
        ('heat_mixed nt=32', {'dt': 0.0625, 'err': 0.00039938057834263687}),
    ],
    'unsteady/reaction.py': [
        ('reaction nt=8', {'err': 0.0010054621232673533}),
        ('reaction nt=16', {'err': 0.00027278720982193416}),
        ('reaction nt=32', {'err': 9.01476598736961e-05}),
        ('reaction nt=64', {'err': 5.3677855983425005e-05}),
    ],
    'unsteady/reaction_mixed.py': [
        ('reaction_mixed nt=8', {'err': 0.000658123285070448}),
        ('reaction_mixed nt=32', {'err': 0.0003939005348993298}),
    ],
    'unsteady/unsteady_bc.py': [
        ('unsteady-bc nt=  8', {'max_err': 0.00013089299092139406}),
        ('unsteady-bc nt= 16', {'max_err': 3.270057447135599e-05}),
        ('unsteady-bc nt= 32', {'max_err': 8.337930984536612e-06}),
        ('resumed nt=32', {'max_err': 8.337930984536612e-06}),
    ],
    'unsteady/vector_reaction.py': [
        ('vector_reaction nt=16', {'err': 0.00047134111676550017}),
        ('vector_reaction nt=64', {'err': 0.00026881390983996}),
    ],
}

# Each value is held to the JAX package's absolutely, at the fields' scale:
# to round-off through a direct solve, to the stopping tolerance through a
# Krylov solve (the multi-device scripts' trace CG and GMRES).
GALLERY_TOL = 1e-10
GALLERY_KRYLOV_TOL = 1e-8
# Report lines held to their titles only: direct_poisson_refined.py's
# local-inverse rounds after the first refine by estimates that are
# round-off of a singular element problem in both packages (1e24 to 1e27;
# ROADMAP section 3), so which leaves split depends on the LU.
GALLERY_TITLES_ONLY = {
    "refinement/direct_poisson_refined.py": {f"local_inverse round={i}" for i in (1, 2, 3)},
}
# The kernels each script's path launches, by the port's code (a rehearsal
# of this phase on the CPU with the wrappers counting their plain
# versions): every script has a 1-form mass (a 1-form unknown, or the
# derivative of a 0-form), so every script launches M1; only the element-
# sharded solves (the multi-device scripts' trace CG and VMS Green's
# saddles) invert element blocks.  The single-card scripts solve by host
# SuperLU, and the local-inverse estimator by torch.linalg.solve.
GALLERY_KERNELS = {
    rel: ("mass_edge", "gj_inverse") if rel.startswith("parallel/") else ("mass_edge",)
    for rel in JAX_GALLERY
}


def _p18_check_reports(rel: str, reports: list, devices: int = 1) -> float:
    """``rel``'s report lines against the JAX gallery's; their largest gap."""
    want = JAX_GALLERY[rel]
    titles = [t.replace("devices=1", f"devices={devices}") for t, _ in want]
    if [t for t, _ in reports] != titles:
        raise RuntimeError(f"18: {rel} reported {[t for t, _ in reports]}, the JAX gallery {titles}")
    tol = GALLERY_KRYLOV_TOL if rel.startswith("parallel/") else GALLERY_TOL
    worst = 0.0
    for (title, mine), (_, ref) in zip(reports, want):
        if mine.keys() != ref.keys():
            raise RuntimeError(f"18: {rel} [{title}] reports {sorted(mine)}, not {sorted(ref)}")
        if title in GALLERY_TITLES_ONLY.get(rel, ()):
            continue
        for key, value in ref.items():
            gap = abs(mine[key] - value)
            worst = max(worst, gap)
            if not gap <= tol:
                raise RuntimeError(
                    f"18: {rel} [{title}] {key}={mine[key]!r}, the JAX gallery {value!r}"
                    f" (gap {gap:.3e} > {tol:.0e})"
                )
    return worst


def _p18_capture_reports(module) -> list:
    """The report calls of the script ``module``, at full precision, as they
    print."""
    reports, report = [], module.report

    def capturing(title, **values):
        reports.append((title, {k: float(v) for k, v in values.items()}))
        report(title, **values)

    module.report = capturing
    return reports


def _p18_rank(device_mesh, script: str) -> dict:
    """A rank of a multi-device gallery script: its ``run`` with the kernel
    launches counted by shape, its reports, and on rank 0 both kernels held
    and timed at every shape it launched them on."""
    import torch.distributed as dist
    from examples_torch.common import load_script
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    rel = str(Path(script).relative_to(ROOT / "examples_torch"))
    module = load_script(script)
    reports = _p18_capture_reports(module)
    with _KernelRecorder() as rec:
        mass_edge.launches = 0
        gj_inverse.launches = 0
        rec.part = f"18 {rel}"
        t0 = time.perf_counter()
        module.run(device_mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec.part = None
    counts = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
    kernels = _p17_time_recorded(rec, "18", " on a rank") if dist.get_rank() == 0 else None
    return {"reports": reports, "wall": wall, "launches": counts, "kernels": kernels}


def phase18_gallery() -> dict:
    """Every script of examples_torch/ on the card, its reports against the
    JAX gallery's and its kernel launches counted; then both kernels held
    and timed at every shape the scripts launched them on."""
    from examples_torch.common import DEVICE, load_script, spawn_ranks
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    scripts = sorted((ROOT / "examples_torch").glob("*/*.py"))
    rels = [str(s.relative_to(ROOT / "examples_torch")) for s in scripts]
    if sorted(rels) != sorted(JAX_GALLERY):
        raise RuntimeError(f"18: the gallery has {rels}, the JAX gallery {sorted(JAX_GALLERY)}")
    print(f"phase 18: {len(scripts)} gallery scripts on {DEVICE}")
    per_script, failures, rank_kernels = {}, [], []
    with _KernelRecorder() as rec:
        for script, rel in zip(scripts, rels):
            mass_edge.launches = 0
            gj_inverse.launches = 0
            t0 = time.perf_counter()
            try:
                if rel.startswith("parallel/"):
                    rec.part = None
                    ranks = spawn_ranks(_p18_rank, str(script))
                    reports, counts = ranks[0]["reports"], ranks[0]["launches"]
                    rank_kernels.append(ranks[0]["kernels"])
                    devices = len(ranks)
                    # The script's run on rank 0; with the spawn, the group's
                    # start and rank 0's kernel timing beside it.
                    wall = ranks[0]["wall"]
                    extra = {"with_spawn_s": round(time.perf_counter() - t0, 3)}
                else:
                    module = load_script(script)
                    reports = _p18_capture_reports(module)
                    rec.part = f"18 {rel}"
                    module.main()
                    torch.cuda.synchronize()
                    rec.part = None
                    counts = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
                    devices = 1
                    wall, extra = time.perf_counter() - t0, {}
                gap = _p18_check_reports(rel, reports, devices)
            except Exception:  # one script's failure is reported, the rest still run
                import traceback

                rec.part = None
                failures.append(rel)
                print(f"phase 18: FAIL {rel}\n{traceback.format_exc()}")
                continue
            per_script[rel] = {"wall_s": round(wall, 3), **extra, "largest_gap": gap, **counts}
            print(
                f"phase 18: OK {rel}: {len(reports)} reports within {gap:.3e} of the JAX"
                f" gallery's, wall {wall:.3f} s {extra or ''}, launches {counts}"
            )
            missing = [k for k in GALLERY_KERNELS[rel] if counts[k] <= 0]
            if missing:
                failures.append(rel)
                print(f"phase 18: FAIL {rel} launched no {missing}")
    if failures:
        raise RuntimeError(f"18: gallery scripts failed: {failures}")
    kernels = _p17_time_recorded(rec, "18", "")
    for timed in rank_kernels:
        for name in ("mass_edge", "gj_inverse"):
            kernels[name] += timed[name]
    losing = [
        (t["n"], t["E"], t["ms"], t["library_ms"])
        for t in kernels["gj_inverse"] if t["ms"] > t["library_ms"]
    ]
    print(f"phase 18: inverse shapes slower than torch.linalg.inv (n, E, ms, library ms): {losing}")
    return {"scripts": per_script, **kernels}


# Phase 18b: BASELINE config 3, the Stokes flow in VVP form (vorticity,
# velocity, pressure; stokes_flow's divergence unknown left out) on 32x32
# at p=8 through static condensation: element blocks of n = (2p+1)^2 = 289
# on the inverse's streamed route, M1 at p=8, E=1024.  The JAX package's
# unknowns, Picard iterations and errors at this size on the CPU
# (tools/gallery_reference.py); the errors are round-off, so a wrong solve
# shows as a gap far above the tolerance.
CONFIG3_MESH, CONFIG3_ORDER = 32, 8
JAX_CONFIG3 = {'n_total_dofs': 328703,
               'iterations': 1,
               'err_vel': 2.4687864398145233e-14,
               'err_vor': 5.189369199879501e-14,
               'err_prs': 1.4065406051269863e-14}


def phase18b_stokes() -> dict:
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.tracing import tracer

    n = (2 * CONFIG3_ORDER + 1) ** 2
    route = gj_inverse.route(n, torch.float64)
    print(f"  n={n} f64 blocks take the {route} route")
    if route != "streamed":
        raise RuntimeError(f"the n={n} blocks take the {route} route, not the streamed one")
    model = flow.stokes_flow(with_divergence=False)
    mesh = mf.examples.unit_square_mesh(CONFIG3_MESH, CONFIG3_MESH, CONFIG3_ORDER)

    def solve():
        out = mf.solve_system_2d(
            mesh,
            mf.SystemSettings(model.system),
            mf.SolverSettings(
                mf.ConvergenceSettings(absolute_tolerance=1e-10, relative_tolerance=0),
                linear_solver="schur_direct",
            ),
            recon_order=CONFIG3_ORDER,
            device="cuda",
        )
        torch.cuda.synchronize()
        return out

    with _KernelRecorder() as rec:
        mass_edge.launches = 0
        gj_inverse.launches = 0
        tracer.enable()
        tracer.reset()
        torch.cuda.reset_peak_memory_stats()
        rec.part = "18b"
        t0 = time.perf_counter()
        grids, stats, _ = solve()
        wall = time.perf_counter() - t0
        rec.part = None
        tracer.disable()
    counts = {"mass_edge": mass_edge.launches, "gj_inverse": gj_inverse.launches}
    peak = torch.cuda.max_memory_allocated()
    grid = grids[-1]
    x, y = grid.points[:, 0], grid.points[:, 1]
    vel = grid.point_data["vel"] - flow.stokes_velocity_exact(x, y)
    got = {
        "n_total_dofs": int(stats.n_total_dofs),
        "iterations": int(stats.iter_history[-1]),
        "err_vel": float(np.sqrt(np.mean(np.sum(vel**2, axis=-1)))),
        "err_vor": float(
            np.sqrt(np.mean((grid.point_data["vor"] - flow.stokes_vorticity_exact(x, y)) ** 2))
        ),
        "err_prs": float(np.sqrt(np.mean(grid.point_data["prs"] ** 2))),
    }
    print(
        f"phase 18b: Stokes {CONFIG3_MESH}x{CONFIG3_MESH} p={CONFIG3_ORDER} schur_direct:"
        f" {got} (the JAX package on the CPU: {JAX_CONFIG3}), wall {wall:.3f} s, peak device"
        f" memory {peak} bytes, launches {counts}"
    )
    for name, (calls, total) in sorted(tracer.stages.items(), key=lambda kv: -kv[1][1]):
        print(f"  stage {name:28s} {total:9.4f} s ({calls} calls)")
    for key in ("n_total_dofs", "iterations"):
        if got[key] != JAX_CONFIG3[key]:
            raise RuntimeError(f"18b: {key} {got[key]}, the JAX package {JAX_CONFIG3[key]}")
    for key in ("err_vel", "err_vor", "err_prs"):
        if not abs(got[key] - JAX_CONFIG3[key]) <= GALLERY_TOL:
            raise RuntimeError(f"18b: {key} {got[key]!r}, the JAX package {JAX_CONFIG3[key]!r}")
    _require_launches("18b", **counts)
    if (n, CONFIG3_MESH**2) not in rec.gj_inverse:
        raise RuntimeError(f"18b: no inverse of the n={n} blocks: {sorted(rec.gj_inverse)}")
    _require_no_uploads("18b", "the solve again, warm", solve)
    kernels = _p17_time_recorded(rec, "18b", "")
    stages = {k: v[1] for k, v in tracer.stages.items()}
    return {"wall_s": wall, "peak_bytes": peak, "stages": stages, **got, **kernels}


def _sn_trsv_entry(timing: dict) -> dict:
    """The kernel report's entry of the frozen LU's sweeps (phase 12b),
    with the launches of phase 12's heat march."""
    return {
        "name": "sn_trsv",
        "route": "cuda",
        "source": "mfv2d_torch/csrc/sn_trsv.cu",
        # The JAX package solves its frozen saddle systems with SciPy on the host.
        "replaces": None,
        "launches_in": "phase 12 (heat march 64x64 p=4 direct)",
        **timing,
    }


# Wall seconds of each phase after the build, printed before the reports.
PHASE_WALLS: dict[str, float] = {}


def _timed(phase: str, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    PHASE_WALLS[phase] = round(time.perf_counter() - t0, 1)
    return result


def main() -> int:
    import mfv2d_torch  # noqa: F401  (fails outside a checkout of the repo)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--probe",
        nargs="?",
        const="inverse",
        choices=("inverse", "mass", "hp", "vms", "parallel", "gallery", "trsv"),
        help="phases 0 and 1, then only phase 6 (inverse, the default), 2 (mass),"
        " 14 (hp), 15 (vms), 16 and 17 (parallel), 18 and 18b (gallery) or phase"
        " 12's heat march and 12b (trsv)",
    )
    args = parser.parse_args()

    phase0_device()
    phase1_build()
    if args.probe == "gallery":
        gallery = _timed("18", phase18_gallery)
        stokes = _timed("18b", phase18b_stokes)
        print(f"phase walls (s): {PHASE_WALLS}")
        kernels = _p17_kernel_entries(gallery) + _p17_kernel_entries(stokes)
        print(json.dumps({"phase 18": gallery["scripts"], "kernels": kernels}))
        return 0
    if args.probe == "hp":
        print(json.dumps(phase14_hp()))
        return 0
    if args.probe == "vms":
        print(json.dumps(phase15_vms()))
        return 0
    if args.probe == "parallel":
        report = _p16_report(_timed("16", phase16_parallel))
        parallel17 = _timed("17", phase17_parallel)
        print(f"phase walls (s): {PHASE_WALLS}")
        report["phase 17"] = {"runs": parallel17["runs"], "gaps": parallel17["gaps"]}
        report["kernels"] += _p17_kernel_entries(parallel17)
        print(json.dumps(report))
        return 0
    if args.probe == "inverse":
        print(json.dumps(phase6_inverse_vs_plain()))
        return 0
    if args.probe == "trsv":
        _timed("12", _p12_heat_direct)
        trsv = _timed("12b", phase12b_sn_trsv)
        print(f"phase walls (s): {PHASE_WALLS}")
        print(json.dumps({"kernels": [_sn_trsv_entry(trsv)]}))
        return 0
    mass_timing = _timed("2", phase2_kernel_vs_plain)
    if args.probe == "mass":
        print(json.dumps(mass_timing))
        return 0
    _timed("3", phase3_golden)
    # M1's launches on each path that KERNEL_TIMED names.
    mass_launches = {"phase 4": _timed("4", phase4_main_path)}
    direct_iterations = _timed("5", phase5_picard)
    inverse_timing = _timed("6", phase6_inverse_vs_plain)
    inverse_launches = _timed("7", phase7_schur_cg)
    mass_launches["phase 8"] = _timed("8", phase8_static_condensation)
    _timed("9", phase9_picard_condensed, direct_iterations)
    (
        mass_launches["phase 10 Poisson"],
        mass_launches["phase 10 Navier-Stokes"],
        phase10_inverse_launches,
    ) = _timed("10", phase10_streamed_table)
    newton_launches = _timed("11", phase11_newton, direct_iterations)
    march_launches = _timed("12", phase12_marches)
    trsv = _timed("12b", phase12b_sn_trsv)
    mass_launches["phase 13"], p16_inverse_launches = _timed("13", phase13_p16)
    hp = _timed("14", phase14_hp)
    vms = _timed("15", phase15_vms)
    parallel = _timed("16", phase16_parallel)
    parallel17 = _timed("17", phase17_parallel)
    gallery = _timed("18", phase18_gallery)
    stokes = _timed("18b", phase18b_stokes)
    print(f"phase walls (s): {PHASE_WALLS}")
    # The VMS inclusion's reference element: its launches run by run, as
    # phases 15 and 17 counted them at its shape.
    inclusion = {
        run: n
        for timing in (*vms["mass_edge"], *parallel17["mass_edge"])
        if timing["m1_shape"] == VMS_INCLUSION
        for run, n in timing["launches_by_run"].items()
    }
    if not sum(inclusion.values()):
        raise RuntimeError(f"no run of phases 15 and 17 launched M1 at {VMS_INCLUSION}")
    mass_launches["phases 15b and 17f"] = sum(inclusion.values())
    mass_timing[KERNEL_TIMED.index(((10, 10), 1, "phases 15b and 17f"))][
        "launches_by_run"
    ] = inclusion
    # One mass_edge entry per timed shape, each with the launches of the
    # path its "launches_in" names: phases 4, 8, 10 and 13, and the VMS
    # inclusion's runs (null for the shapes timed only).  The inverse's
    # launches are phase 7's (register route) and, for the streamed route,
    # phase 10's Navier-Stokes solve and, for its clustered panel, phase
    # 13's.  Phases 11 and 12 launch M1 at p=4 and p=5; their counts ride on
    # the p=4 entry.
    mass_timing[0]["launches_phase11"] = {k: c["mass_edge"] for k, c in newton_launches.items()}
    mass_timing[0]["launches_phase12"] = march_launches
    report = {
        "kernels": [
            *(
                {
                    "name": "mass_edge",
                    "route": "cuda",
                    "source": "mfv2d_torch/csrc/mass_edge.cu",
                    "replaces": "mfv2d_tpu/ops/pallas_mass.py:113",
                    "launches": (
                        None
                        if timing["launches_in"] == TIMED_ONLY
                        else mass_launches[timing["launches_in"]]
                    ),
                    **timing,
                }
                for timing in mass_timing
            ),
            {
                "name": "gj_inverse",
                "route": "cuda",
                "source": "mfv2d_torch/csrc/gj_inverse.cu",
                "replaces": "mfv2d_tpu/ops/pallas_factor.py:136",
                "launches": inverse_launches,
                "launches_streamed_phase10": phase10_inverse_launches,
                "launches_clustered_phase13": p16_inverse_launches,
                "launches_newton_phase11": {
                    k: c["gj_inverse"] for k, c in newton_launches.items()
                },
                **inverse_timing,
            },
            _sn_trsv_entry(trsv),
            # Phase 14: M1 at each shape the hp rounds and the final solves
            # launched it on, with that shape's launches (those inside the
            # refinement stage apart); the inverse at each bucket of the final
            # mesh, with the launches of its "schur_direct" solve.
            *(
                {
                    "name": "mass_edge",
                    "route": "cuda",
                    "source": "mfv2d_torch/csrc/mass_edge.cu",
                    "replaces": "mfv2d_tpu/ops/pallas_mass.py:113",
                    "launches_phase14": hp["launches"]["mass_edge"],
                    "launches_refinement_stage_by_round": hp["in_refinement"],
                    **timing,
                }
                for timing in hp["mass_edge"]
            ),
            *(
                {
                    **timing,
                    "name": "gj_inverse",
                    "route": "cuda",
                    "inverse_route": timing["route"],
                    "source": "mfv2d_torch/csrc/gj_inverse.cu",
                    "replaces": "mfv2d_tpu/ops/pallas_factor.py:136",
                    "launches": hp["launches"]["gj_inverse"],
                    "launches_in": "phase 14 (hp final mesh, schur_direct)",
                    "plain_ms": timing["library_ms"],
                }
                for timing in hp["gj_inverse"]
            ),
            # Phase 15: both kernels at each shape its VMS runs launched them
            # on, with the launches of each run (config 5 is "15b").
            *(
                {
                    "name": "mass_edge",
                    "route": "cuda",
                    "source": "mfv2d_torch/csrc/mass_edge.cu",
                    "replaces": "mfv2d_tpu/ops/pallas_mass.py:113",
                    **timing,
                }
                for timing in vms["mass_edge"]
            ),
            *(
                {
                    **timing,
                    "name": "gj_inverse",
                    "route": "cuda",
                    "inverse_route": timing["route"],
                    "source": "mfv2d_torch/csrc/gj_inverse.cu",
                    "replaces": "mfv2d_tpu/ops/pallas_factor.py:136",
                    "plain_ms": timing["library_ms"],
                }
                for timing in vms["gj_inverse"]
            ),
            # Phase 16: both kernels at the per-rank shapes of 16b (half of
            # the 64x64 p=8 mesh a rank), with rank 0's launches there.
            *_p16_kernel_entries(parallel),
            # Phase 17: both kernels at every shape its runs launched them
            # on, with rank 0's launches of each.
            *_p17_kernel_entries(parallel17),
            # Phases 18 and 18b: both kernels at every shape the gallery
            # scripts and config 3 launched them on, with the launches of
            # each script.
            *_p17_kernel_entries(gallery),
            *_p17_kernel_entries(stokes),
        ],
        "phase 18": gallery["scripts"],
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
