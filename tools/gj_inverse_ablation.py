#!/usr/bin/env python3
"""Route choices of csrc/gj_inverse.cu and where each route's time goes, on one GPU.

Run from the repository root:

    python3 tools/gj_inverse_ablation.py [--baseline OTHER.cu]

Builds copies of ``mfv2d_torch/csrc/gj_inverse.cu`` into
``build/mfv2d_torch/ablation/`` (one nvcc each, in parallel):

- ``kernel``: the source as it is (register route up to n = 64, then the
  blocked route, then the global one);
- ``baseline``: with ``--baseline``, another source with the same C entry
  points, for instance an earlier revision's
  (``git show REV:mfv2d_torch/csrc/gj_inverse.cu > build/baseline.cu``);
- ``register-ticks``: the source with ``clock64()`` read by thread 0 of
  block 0 at each phase boundary of the register route, and a query of the
  blocks of the n = 56 f64 register kernel resident per SM;
- ``no-update``: the blocked route's rank-32 tile updates cut out (panel
  sweeps, panel loads and stores, the final column swaps);
- ``memory-only``: the blocked route's pivot steps and update FMAs cut out
  (every load and store of the route, nothing else);
- ``ticks``: the source with ``clock64()`` read by thread 0 of block 0 at
  each phase boundary of the blocked route.

All but the two cut copies compute the inverse and are held against
``torch.linalg.inv``.  For each case (n, E, saddle matrices in f64 or f32)
it prints ``torch.linalg.inv``'s CUDA-event median and each of the case's
copies twice, timed in turns (A B B A):

- n=56, E=4096, f64: the register route, against the baseline where
  there is one, and its cycles by phase;
- n=65, 72, 85, 121 and 161 (E=4096) and n=121, E=256 (the phase-9 batch)
  in f64, and n=65, 121 and 208 (E=4096) in f32: the route n takes,
  against the baseline where there is one;
- n=208 (E=4096) and n=289 (E=1000), f64: the blocked route with its cut
  copies and its cycles by phase.

A copy whose text no longer matches the source stops the script with the
substitution that failed.
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

OUT = ROOT / "build" / "mfv2d_torch" / "ablation"
# (n, E, dtype, the copies timed on that case)
ROUTE_CHOICE = ("kernel", "baseline")
CASES = [
    (56, 4096, torch.float64, ("kernel", "baseline", "register-ticks")),
    (65, 4096, torch.float64, ROUTE_CHOICE),
    (72, 4096, torch.float64, ROUTE_CHOICE),
    (85, 4096, torch.float64, ROUTE_CHOICE),
    (121, 4096, torch.float64, ROUTE_CHOICE),
    (161, 4096, torch.float64, ROUTE_CHOICE),
    (121, 256, torch.float64, ROUTE_CHOICE),
    (65, 4096, torch.float32, ROUTE_CHOICE),
    (121, 4096, torch.float32, ROUTE_CHOICE),
    (208, 4096, torch.float32, ROUTE_CHOICE),
    (208, 4096, torch.float64, ("kernel", "no-update", "memory-only", "ticks")),
    (289, 1000, torch.float64, ("kernel", "no-update", "memory-only", "ticks")),
]
TOL = {torch.float64: 1e-10, torch.float32: 1e-3}
CUT = ("no-update", "memory-only")

NO_UPDATE = [
    (
        "    for (int j0 = 0; j0 < n; j0 += kPanel) {\n      if (j0 == k0) continue;",
        "    for (int j0 = 0; j0 < 0; j0 += kPanel) {\n      if (j0 == k0) continue;",
    )
]
MEMORY_ONLY = [
    (
        "    for (int t = 0; t < bk; ++t) {\n      const int k = k0 + t;",
        "    for (int t = 0; t < 0; ++t) {\n      const int k = k0 + t;",
    ),
    (
        "    for (int i = tid; i < n; i += kBlockedThreads) src[i] = i;\n    load_columns(",
        "    for (int i = tid; i < n; i += kBlockedThreads) {\n      src[i] = i;\n"
        "      perm[i] = i;\n    }\n    load_columns(",
    ),
    (
        "        for (int t = 0; t < bk; ++t) {\n          T m[kRowsPerThread];",
        "        for (int t = 0; t < 0; ++t) {\n          T m[kRowsPerThread];",
    ),
]
PHASES = [
    "panel load",
    "pivot steps: to the partial maxima",
    "pivot steps: to the pivot row",
    "pivot steps: the panel update",
    "panel store",
    "tile loads",
    "tile FMAs and stores",
    "final column swaps",
]
TICKS = [
    (
        "namespace {\n\nconstexpr int kWarp = 32;",
        "__device__ unsigned long long ablation_cycles[8];\n"
        "#define TICK(slot) do { if (blockIdx.x == 0 && threadIdx.x == 0) {"
        " const long long now_ = clock64(); ablation_cycles[slot] += now_ - last_tick;"
        " last_tick = now_; } } while (0)\n"
        "namespace {\n\nconstexpr int kWarp = 32;",
    ),
    (
        "  const int tr = tid / kTileColThreads;  // update: rows tr + 32 r of a chunk\n\n",
        "  const int tr = tid / kTileColThreads;  // update: rows tr + 32 r of a chunk\n"
        "  long long last_tick = clock64();\n\n",
    ),
    (
        "    load_columns(w, n, k0, bk, static_cast<const int*>(nullptr), panel, kPanelStride);\n"
        "    __syncthreads();\n",
        "    load_columns(w, n, k0, bk, static_cast<const int*>(nullptr), panel, kPanelStride);\n"
        "    __syncthreads();\n    TICK(0);\n",
    ),
    ("      __syncthreads();\n      key = red_key[0];", "      __syncthreads();\n      TICK(1);\n      key = red_key[0];"),
    (
        "      __syncthreads();\n#pragma unroll\n      for (int q = 0; q < kRows; ++q) {\n"
        "        const int i = tid + q * kBlockedThreads;\n        if (i == k) {",
        "      __syncthreads();\n      TICK(2);\n#pragma unroll\n      for (int q = 0; q < kRows; ++q) {\n"
        "        const int i = tid + q * kBlockedThreads;\n        if (i == k) {",
    ),
    ("    }\n    // The panel now holds M", "      TICK(3);\n    }\n    // The panel now holds M"),
    (
        "panel[i * kPanelStride + t]);\n    }\n",
        "panel[i * kPanelStride + t]);\n    }\n    TICK(4);\n",
    ),
    (
        "      load_columns(w, n, j0, wj, src, tile, kPanel);\n      __syncthreads();\n",
        "      load_columns(w, n, j0, wj, src, tile, kPanel);\n      __syncthreads();\n      TICK(5);\n",
    ),
    (
        "      __syncthreads();\n    }\n  }\n\n  // 3. Undo the row swaps",
        "      __syncthreads();\n      TICK(6);\n    }\n  }\n\n  // 3. Undo the row swaps",
    ),
    (
        "  if (tid == 0) info[e] = 0;\n}\n\n// The current device",
        "  TICK(7);\n  if (tid == 0) info[e] = 0;\n}\n\n// The current device",
    ),
]
REGISTER_PHASES = [
    "load",
    "rows into registers",
    "steps: shuffles and warp maxima",
    "steps: pivot row",
    "steps: update",
    "scatter and store",
]
REGISTER_TICKS = [
    TICKS[0],
    (
        "  const long long nn = static_cast<long long>(n) * n;\n\n  unsigned char* fixed",
        "  const long long nn = static_cast<long long>(n) * n;\n  long long last_tick = clock64();\n\n"
        "  unsigned char* fixed",
    ),
    (
        "    copy_async_wait();\n    group_sync<kThreads>(barrier_id);\n",
        "    copy_async_wait();\n    group_sync<kThreads>(barrier_id);\n    TICK(0);\n",
    ),
    ("    bool used = r >= n;", "    TICK(1);\n    bool used = r >= n;"),
    (
        "publishes the warp maxima.\n      group_sync<kThreads>(barrier_id);\n",
        "publishes the warp maxima.\n      group_sync<kThreads>(barrier_id);\n      TICK(2);\n",
    ),
    (
        "      const T inv_pivot = T(1) / piv;\n      group_sync<kThreads>(barrier_id);\n",
        "      const T inv_pivot = T(1) / piv;\n      group_sync<kThreads>(barrier_id);\n      TICK(3);\n",
    ),
    (
        "      u[kLen - 1] = pivot ? T(1) : -f;\n",
        "      u[kLen - 1] = pivot ? T(1) : -f;\n      TICK(4);\n",
    ),
    (
        "    if (r == 0) info[e] = 0;\n    group_sync<kThreads>(barrier_id);",
        "    if (r == 0) info[e] = 0;\n    group_sync<kThreads>(barrier_id);\n    TICK(5);",
    ),
]
REGISTER_ENTRIES = """
extern "C" int ablation_register_blocks_per_sm_56() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gj_inverse_register_kernel<double, 56>, kRegisterThreads,
      register_route_bytes<double>(56));
  return blocks;
}
"""
TICK_ENTRIES = """
extern "C" void ablation_reset() {
  unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(ablation_cycles, zero, sizeof(zero));
}
extern "C" void ablation_read(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, ablation_cycles, sizeof(ablation_cycles));
}
"""
COPIES = {
    "kernel": [],
    "no-update": NO_UPDATE,
    "memory-only": MEMORY_ONLY,
    "ticks": TICKS,
    "register-ticks": REGISTER_TICKS,
}


def build(name: str, baseline: Path | None) -> ctypes.CDLL:
    if name == "baseline":
        text = baseline.read_text()
    else:
        text = (_build.CSRC / "gj_inverse.cu").read_text()
    for old, new in COPIES.get(name, []):
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    if name in ("ticks", "register-ticks"):
        text += TICK_ENTRIES
    if name == "register-ticks":
        text += REGISTER_ENTRIES
    source = OUT / f"{name}.cu"
    source.write_text(text)
    target = OUT / f"lib{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(target))
    for fn in (lib.mfv2d_gj_inverse_f64, lib.mfv2d_gj_inverse_f32):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def saddle_batch(n: int, e: int, seed: int) -> torch.Tensor:
    """E saddle matrices [[M, B^T], [B, 0]] (16 distinct, repeated), as in
    chip_smoke.py: M SPD with eigenvalues in [1, 10], B of full row rank."""
    rng = np.random.default_rng(seed)
    n_b = n // 3
    n_m = n - n_b
    pool = np.empty((16, n, n))
    for c in range(16):
        q, _ = np.linalg.qr(rng.normal(size=(n_m, n_m)))
        m = (q * rng.uniform(1.0, 10.0, n_m)) @ q.T
        v, _ = np.linalg.qr(rng.normal(size=(n_m, n_m)))
        b = rng.uniform(1.0, 3.0, n_b)[:, None] * v[:n_b]
        pool[c] = np.block([[m, b.T], [b, np.zeros((n_b, n_b))]])
    pool_t = torch.tensor(pool, device="cuda")
    return pool_t.repeat(-(-e // 16), 1, 1)[:e].contiguous()


def median_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", type=Path, help="another gj_inverse.cu, timed beside the source"
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
    names_built = [*COPIES, "baseline"] if args.baseline else list(COPIES)
    with ThreadPoolExecutor(len(names_built)) as pool:
        libs = dict(
            zip(names_built, pool.map(lambda name: build(name, args.baseline), names_built))
        )
    stream = torch.cuda.current_stream().cuda_stream
    for n, e, dtype, names in CASES:
        names = tuple(name for name in names if name in libs)
        a = saddle_batch(n, e, seed=n).to(dtype)
        ref = torch.linalg.inv(a)
        out = torch.empty_like(a)
        info = torch.empty(e, dtype=torch.int32, device="cuda")
        suffix = "f64" if dtype == torch.float64 else "f32"
        print(
            f"n={n} E={e} {suffix}: torch.linalg.inv"
            f" {median_ms(lambda: torch.linalg.inv(a)):.4f} ms"
        )

        def run(name):
            rc = getattr(libs[name], f"mfv2d_gj_inverse_{suffix}")(
                a.data_ptr(), out.data_ptr(), info.data_ptr(), e, n, ctypes.c_void_p(stream)
            )
            if rc:
                raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")

        times = {name: [] for name in names}
        for name in (*names, *reversed(names)):
            times[name].append(median_ms(lambda: run(name)))
        for name in names:
            line = f"  {name:16s} {times[name][0]:9.4f} ms, again {times[name][1]:9.4f} ms"
            if name not in CUT:
                run(name)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max() / ref.abs().max())
                if not err <= TOL[dtype] or bool(info.any()):
                    raise RuntimeError(f"{name} disagrees with torch.linalg.inv: {err:.3e}")
                line += f", rel err {err:.3e}"
            print(line)
            if name in ("ticks", "register-ticks"):
                lib = libs[name]
                cycles = (ctypes.c_ulonglong * 8)()
                lib.ablation_reset()
                run(name)
                torch.cuda.synchronize()
                lib.ablation_read(cycles)
                total = sum(cycles)
                print(f"    block 0, one launch: {total} cycles")
                if name == "register-ticks":
                    lib.ablation_register_blocks_per_sm_56.restype = ctypes.c_int
                    blocks = lib.ablation_register_blocks_per_sm_56()
                    print(f"    blocks of {128} threads resident per SM: {blocks}")
                for phase, c in zip(PHASES if name == "ticks" else REGISTER_PHASES, cycles):
                    print(f"      {phase:36s} {c:10d} {100 * c / total:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
