#!/usr/bin/env python3
"""Route choices of csrc/gj_inverse.cu and where the streamed route's time goes, on one GPU.

Run from the repository root:

    python3 tools/gj_inverse_ablation.py [--sizes N ...] [--baseline OTHER.cu ...]

Builds copies of ``mfv2d_torch/csrc/gj_inverse.cu`` into
``build/mfv2d_torch/ablation/`` (one nvcc each, in parallel):

- ``kernel``: the source as it is; each run hands its C entry point a
  layout (route, panel width and panel blocks a matrix, whose rows beyond
  their registers go to L2): ``launch_plan``'s
  (``ops/kernels/gj_inverse.py``) or one forced here, so one library times
  every route and layout at every n it takes;
- one copy per ``--baseline`` file, named after it: another source, for
  instance an earlier revision's
  (``git show cf75c8c:mfv2d_torch/csrc/gj_inverse.cu > build/cf75c8c.cu``).
  One whose C entry point chooses its route itself
  (``mfv2d_gj_inverse_f64(a, out, info, E, n, stream)``, before the
  streamed route) runs on its own route; one that takes a route and a
  panel width but no panel blocks (before the clustered panel) runs on the
  streamed route at the plan's width, and is left out above n = 1024,
  where its streamed route did not go;
- ``no-mma``: the streamed update's products cut out (its loads, copies
  and stores only): the pass floor;
- ``no-sweep``: the streamed panel's pivot steps cut out (panel loads and
  stores, updates and column swaps only), so the time it loses is the
  sweep chain's;
- ``launches-only``: every streamed kernel returns at once: the launches'
  own cost.

Every copy but the cut ones computes the inverse and is held against
``torch.linalg.inv`` (1e-10 in f64, 1e-3 in f32).  For each case (n, E,
saddle matrices in f64 or f32) it prints ``torch.linalg.inv``'s CUDA-event
median and each run twice, timed in turns (A B B A); at E <= 16 a time is
per call of ten calls back to back.  The cases:

- n=1056 and 1089 (E=16, the p=16 Navier-Stokes batch) and n=2401 (E=4),
  f64: the panel layouts above n = 1024, each at its own width: the plan's
  cluster of ceil(n / 512) blocks holding 32 columns in registers; one
  block of 16 columns and two blocks of 32 columns, each with the rows
  past 1,024 in L2; and the cut copies at the plan's layout;
- n=460, E=1000 and n=441, E=16 (the phase-10 batch), f64: the streamed
  route against the baseline, panels of 16 columns, and the cut copies;
- n=208 (E=4096 and 1000), 224, 240 and 256 (E=1000) in f64, and n=208
  and 224 (E=1000) in f32: the blocked route (which takes n <= 256)
  against the streamed one, the measurement behind the boundary between
  them (``launch_plan`` in ``ops/kernels/gj_inverse.py``);
- the copies ``stages-2`` (a ring of two stages), ``rows-64`` (chunks of 64
  rows, 8 warps) and ``warps-2`` (2 warps, each 16 rows by the whole tile)
  at n=460 and 441: other shapes of the update;
- at n=460, ``L2 waves``: the source as it is, called on successive slices
  of 25 matrices (42 MB, which stay in the 50 MB L2 across a slice's
  panels) in place of the whole batch.

``--sizes`` keeps the cases of those n only.  A copy whose text no longer
matches the source stops the script with the substitution that failed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mfv2d_torch.ops.kernels import _build  # noqa: E402
from mfv2d_torch.ops.kernels import gj_inverse  # noqa: E402

OUT = ROOT / "build" / "mfv2d_torch" / "ablation"
TOL = {torch.float64: 1e-10, torch.float32: 1e-3}

NO_MMA = [
    (
        "  for (int s = 0; s < kB; s += 4) {\n    const double a0",
        "  for (int s = 0; s < 0; s += 4) {\n    const double a0",
    )
]
NO_SWEEP = [
    (
        "  for (int t = 0; t < bk; ++t) {\n    const int k = k0 + t;",
        "  for (int t = 0; t < 0; ++t) {\n    const int k = k0 + t;",
    )
]
LAUNCHES_ONLY = [
    (f"  if (info[e] != 0) return;  // {why}", f"  return;  // {why}")
    for why in (
        "an earlier panel of this matrix failed",
        "this matrix's panel failed",
        "the matrix is singular",
    )
]
STAGES_2 = [("constexpr int kStreamStages = 3;", "constexpr int kStreamStages = 2;")]
ROWS_64 = [
    (
        "constexpr int kStreamThreads = 128;\nconstexpr int kStreamRows = 32;",
        "constexpr int kStreamThreads = 256;\nconstexpr int kStreamRows = 64;",
    )
]
WARPS_2 = [("constexpr int kStreamThreads = 128;", "constexpr int kStreamThreads = 64;")]
COPIES = {
    "kernel": [],
    "no-mma": NO_MMA,
    "no-sweep": NO_SWEEP,
    "launches-only": LAUNCHES_ONLY,
    "stages-2": STAGES_2,
    "rows-64": ROWS_64,
    "warps-2": WARPS_2,
}
CUT = ("no-mma", "no-sweep", "launches-only")

# A run: (label, copy, layout of (n, dtype) as (route, panel columns,
# panel blocks), matrices a call or None for the whole batch); "baseline"
# stands for each --baseline copy.
def planned(n, dtype):
    plan = gj_inverse.launch_plan(n, dtype)
    return plan.route, plan.panel, plan.blocks


def blocked(n, dtype):
    return "blocked", 0, 1


def streamed(n, dtype):  # the streamed route's one-block layout, below its n too
    return "streamed", 32 if n <= 512 else 16, 1


def panel_16(n, dtype):
    return "streamed", 16, 1


def two_blocks(n, dtype):
    return "streamed", 32, 2


STREAMED = ("streamed", "kernel", streamed, None)
BLOCKED = ("blocked", "kernel", blocked, None)
PARTS = [
    STREAMED,
    ("baseline", "baseline", planned, None),
    ("streamed b=16", "kernel", panel_16, None),
    ("no-mma", "no-mma", planned, None),
    ("no-sweep", "no-sweep", planned, None),
    ("launches-only", "launches-only", planned, None),
    ("stages-2", "stages-2", planned, None),
    ("rows-64", "rows-64", planned, None),
    ("warps-2", "warps-2", planned, None),
]
LARGE = [
    ("cluster (plan)", "kernel", planned, None),
    ("1 block b=16 +L2", "kernel", panel_16, None),
    ("2 blocks +L2", "kernel", two_blocks, None),
    ("no-mma", "no-mma", planned, None),
    ("no-sweep", "no-sweep", planned, None),
    ("launches-only", "launches-only", planned, None),
]
L2_WAVES = ("L2 waves", "kernel", planned, 25)
CASES = [
    (1056, 16, torch.float64, LARGE),
    (1089, 16, torch.float64, LARGE),
    (2401, 4, torch.float64, LARGE),
    (460, 1000, torch.float64, [*PARTS, L2_WAVES]),
    (441, 16, torch.float64, PARTS),
    (208, 4096, torch.float64, (BLOCKED, STREAMED)),
    (208, 1000, torch.float64, (BLOCKED, STREAMED)),
    (224, 1000, torch.float64, (BLOCKED, STREAMED)),
    (240, 1000, torch.float64, (BLOCKED, STREAMED)),
    (256, 1000, torch.float64, (BLOCKED, STREAMED)),
    (208, 1000, torch.float32, (BLOCKED, STREAMED)),
    (224, 1000, torch.float32, (BLOCKED, STREAMED)),
]


def build(name: str, baselines: dict[str, Path]) -> tuple[ctypes.CDLL, int]:
    """The copy's library, and how many ints its entry point takes."""
    if name in baselines:
        text = baselines[name].read_text()
    else:
        text = (_build.CSRC / "gj_inverse.cu").read_text()
    for old, new in COPIES.get(name, []):
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    source = OUT / f"{name}.cu"
    source.write_text(text)
    target = OUT / f"lib{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(target))
    # The entry point's arguments after the pointers: (E, n), (E, n, route,
    # panel) or (E, n, route, panel, blocks).
    ints = 5 if "int panel, int blocks" in text else 4 if "int* scratch" in text else 2
    for fn in (lib.mfv2d_gj_inverse_f64, lib.mfv2d_gj_inverse_f32):
        fn.argtypes = [ctypes.c_void_p] * (3 if ints == 2 else 4) + [ctypes.c_int] * ints
        fn.argtypes += [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, ints


def saddle_batch(n: int, e: int, seed: int) -> torch.Tensor:
    """E saddle matrices [[M, B^T], [B, 0]] (up to 16 distinct, repeated), as
    in chip_smoke.py: M SPD with eigenvalues in [1, 10], B of full row rank."""
    rng = np.random.default_rng(seed)
    n_b = n // 3
    n_m = n - n_b
    pool = np.empty((min(16, e), n, n))
    for c in range(pool.shape[0]):
        q, _ = np.linalg.qr(rng.normal(size=(n_m, n_m)))
        m = (q * rng.uniform(1.0, 10.0, n_m)) @ q.T
        v, _ = np.linalg.qr(rng.normal(size=(n_m, n_m)))
        b = rng.uniform(1.0, 3.0, n_b)[:, None] * v[:n_b]
        pool[c] = np.block([[m, b.T], [b, np.zeros((n_b, n_b))]])
    pool_t = torch.tensor(pool, device="cuda")
    return pool_t.repeat(-(-e // pool.shape[0]), 1, 1)[:e].contiguous()


def median_ms(fn, reps: int = 10, calls: int = 1) -> float:
    for _ in range(2):
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", type=Path, nargs="+", default=[],
        help="earlier gj_inverse.cu files, each timed beside the source",
    )
    parser.add_argument(
        "--sizes", type=int, nargs="+", default=None, help="time the cases of these n only"
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gj_inverse_ablation: no CUDA device.", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    OUT.mkdir(parents=True, exist_ok=True)
    baselines = {f"baseline {path.stem}": path for path in args.baseline}
    names_built = [*COPIES, *baselines]
    with ThreadPoolExecutor(len(names_built)) as pool:
        libs = dict(
            zip(names_built, pool.map(lambda name: build(name, baselines), names_built))
        )
    stream = torch.cuda.current_stream().cuda_stream
    for n, e, dtype, runs in CASES:
        if args.sizes and n not in args.sizes:
            continue
        runs = [
            (name, name, *rest) if copy == "baseline" else (label, copy, *rest)
            for label, copy, *rest in runs
            for name in (baselines if copy == "baseline" else [copy])
            if copy != "baseline" or n <= 1024 or libs[name][1] != 4
        ]
        a = saddle_batch(n, e, seed=n).to(dtype)
        ref = torch.linalg.inv(a)
        out = torch.empty_like(a)
        info = torch.empty(e, dtype=torch.int32, device="cuda")
        scratch = torch.empty((2, e, n), dtype=torch.int32, device="cuda")
        suffix = "f64" if dtype == torch.float64 else "f32"
        calls = 10 if e <= 16 else 1
        print(
            f"n={n} E={e} {suffix}: torch.linalg.inv"
            f" {median_ms(lambda: torch.linalg.inv(a), calls=calls):.4f} ms"
            + (" (per call of ten back to back)" if calls > 1 else "")
        )

        def call(run):
            _, copy, plan_of, wave = run
            lib, ints = libs[copy]
            fn = getattr(lib, f"mfv2d_gj_inverse_{suffix}")
            route, panel, blocks = plan_of(n, dtype)
            layout = [gj_inverse.ROUTES.index(route), panel, blocks]
            step = wave or e
            for e0 in range(0, e, step):
                count = min(step, e - e0)
                ptrs = (a[e0:].data_ptr(), out[e0:].data_ptr(), info[e0:].data_ptr())
                if ints == 2:
                    rc = fn(*ptrs, count, n, ctypes.c_void_p(stream))
                else:
                    rc = fn(*ptrs, scratch.data_ptr(), count, n, *layout[: ints - 2],
                            ctypes.c_void_p(stream))
                if rc:
                    raise RuntimeError(f"{run[0]}: launch failed with CUDA error {rc}")

        times = {run[0]: [] for run in runs}
        for run in (*runs, *reversed(runs)):
            times[run[0]].append(median_ms(lambda: call(run), calls=calls))
        for run in runs:
            label = run[0]
            line = f"  {label:16s} {times[label][0]:9.4f} ms, again {times[label][1]:9.4f} ms"
            if run[1] not in CUT:
                call(run)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max() / ref.abs().max())
                if not err <= TOL[dtype] or bool(info.any()):
                    raise RuntimeError(f"{label} disagrees with torch.linalg.inv: {err:.3e}")
                line += f", rel err {err:.3e}"
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
