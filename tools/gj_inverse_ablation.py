#!/usr/bin/env python3
"""Where the time of the blocked route of csrc/gj_inverse.cu goes, on one GPU.

Run from the repository root:  python3 tools/gj_inverse_ablation.py

Builds copies of ``mfv2d_torch/csrc/gj_inverse.cu`` into
``build/mfv2d_torch/ablation/`` (one nvcc each, in parallel):

- ``kernel``: the source as it is;
- ``no-update``: the rank-32 tile updates cut out (panel sweeps, panel
  loads and stores, the final column swaps);
- ``memory-only``: the pivot steps and the update's FMAs cut out (every
  load and store of the route, nothing else);
- ``ticks``: the source with ``clock64()`` read by thread 0 of block 0 at
  each phase boundary.

Only ``kernel`` and ``ticks`` compute the inverse; the cut copies time what
is left.  It prints the CUDA-event median of each copy at n=208 (E=4096)
and n=289 (E=1000), f64, beside ``torch.linalg.inv``, and the cycles block
0 spent in each phase of one launch.  A copy whose text no longer matches
the source stops the script with the substitution that failed.
"""

from __future__ import annotations

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
CASES = [(208, 4096), (289, 1000)]

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
        "  if (tid == 0) info[e] = 0;\n}\n\nint smem_optin",
        "  TICK(7);\n  if (tid == 0) info[e] = 0;\n}\n\nint smem_optin",
    ),
]
TICK_ENTRIES = """
extern "C" void ablation_reset() {
  unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(ablation_cycles, zero, sizeof(zero));
}
extern "C" void ablation_read(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, ablation_cycles, sizeof(ablation_cycles));
}
"""
COPIES = {"kernel": [], "no-update": NO_UPDATE, "memory-only": MEMORY_ONLY, "ticks": TICKS}


def build(name: str) -> ctypes.CDLL:
    text = (_build.CSRC / "gj_inverse.cu").read_text()
    for old, new in COPIES[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    if name == "ticks":
        text += TICK_ENTRIES
    source = OUT / f"{name}.cu"
    source.write_text(text)
    target = OUT / f"lib{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(target))
    lib.mfv2d_gj_inverse_f64.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.mfv2d_gj_inverse_f64.restype = ctypes.c_int
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
    if not torch.cuda.is_available():
        print("gj_inverse_ablation: no CUDA device.", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(COPIES)) as pool:
        libs = dict(zip(COPIES, pool.map(build, COPIES)))
    stream = torch.cuda.current_stream().cuda_stream
    for n, e in CASES:
        a = saddle_batch(n, e, seed=n)
        ref = torch.linalg.inv(a)
        out = torch.empty_like(a)
        info = torch.empty(e, dtype=torch.int32, device="cuda")
        print(f"n={n} E={e} f64: torch.linalg.inv {median_ms(lambda: torch.linalg.inv(a)):.4f} ms")
        for name, lib in libs.items():
            def run(fn=lib.mfv2d_gj_inverse_f64):
                rc = fn(a.data_ptr(), out.data_ptr(), info.data_ptr(), e, n, ctypes.c_void_p(stream))
                if rc:
                    raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")

            ms = median_ms(run)
            line = f"  {name:12s} {ms:9.4f} ms"
            if name in ("kernel", "ticks"):
                err = float((out - ref).abs().max() / ref.abs().max())
                if not err <= 1e-10:
                    raise RuntimeError(f"{name} disagrees with torch.linalg.inv: {err:.3e}")
                line += f", rel err {err:.3e}"
            print(line)
            if name == "ticks":
                cycles = (ctypes.c_ulonglong * 8)()
                lib.ablation_reset()
                run()
                torch.cuda.synchronize()
                lib.ablation_read(cycles)
                total = sum(cycles)
                print(f"    block 0, one launch: {total} cycles")
                for phase, c in zip(PHASES, cycles):
                    print(f"      {phase:36s} {c:10d} {100 * c / total:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
