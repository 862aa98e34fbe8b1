#!/usr/bin/env python3
"""Route choices of csrc/gj_inverse.cu and where the streamed route's time goes, on one GPU.

Run from the repository root:

    python3 tools/gj_inverse_ablation.py [--sizes N ...] [--baseline OTHER.cu ...]

Builds copies of ``mfv2d_torch/csrc/gj_inverse.cu`` into
``build/mfv2d_torch/ablation/`` (one nvcc each, in parallel):

- ``kernel``: the source as it is; each run hands its C entry point a
  layout (route, panel width, panel blocks a matrix, whose rows beyond
  their registers go to L2, and the row stride of the swept work matrix):
  ``launch_plan``'s (``ops/kernels/gj_inverse.py``) or one forced here, so
  one library times every route and layout at every n it takes; the
  stride n at odd n (``8-byte rows``) sweeps the output in place in
  8-byte copies and single stores, as the route did before its work
  matrix of 16-byte rows;
- one copy per ``--baseline`` file, named after it: another source, for
  instance an earlier revision's
  (``git show cf75c8c:mfv2d_torch/csrc/gj_inverse.cu > build/cf75c8c.cu``).
  One whose C entry point chooses its route itself
  (``mfv2d_gj_inverse_f64(a, out, info, E, n, stream)``, before the
  streamed route) runs on its own route; one that takes a route and a
  panel width but no panel blocks (before the clustered panel) runs on the
  streamed route at the plan's width, and is left out above n = 1024,
  where its streamed route did not go; one that takes no row stride
  (before the work matrix) sweeps in place;
- ``no-mma``: the streamed update's products cut out (its loads, copies
  and stores only): the pass floor;
- ``no-sweep``: the streamed panel's pivot steps cut out (panel loads and
  stores, updates and column swaps only), so the time it loses is the
  sweep chain's;
- ``launches-only``: every streamed kernel returns at once: the launches'
  own cost;
- ``two-barrier``: the clustered panel's pivot step as it was before its
  block barrier, two cluster barriers a step (the warp maxima of every
  block to every block; then the rows p and k).

Every copy but the cut ones computes the inverse and is held against
``torch.linalg.inv`` (1e-10 in f64, 1e-3 in f32).  For each case (n, E,
saddle matrices in f64 or f32) it prints ``torch.linalg.inv``'s CUDA-event
median and each run twice, timed in turns (A B B A); at E <= 16 a time is
per call of ten calls back to back.  The cases:

- n=1056 and 1089 (E=16, the p=16 Navier-Stokes batch) and n=2401 (E=4),
  f64: the panel layouts above n = 1024, each at its own width: the plan's
  cluster of ceil(n / 512) blocks holding 32 columns in registers; the
  ``two-barrier`` copy; one block of 16 columns and two blocks of 32
  columns, each with the rows past 1,024 in L2; and the cut copies at the
  plan's layout;
- n=460, E=1000 and n=441, E=16 (the phase-10 batch), f64: the streamed
  route against the baseline, panels of 16 columns, and the cut copies;
- odd n beside the even n + 1, which takes as many panels: n=289 and 290
  (E=1024, config 3's batch), 1089 and 1090 (E=16, with the large cases'
  runs), and n=441 (E=16), f64: the plan's 16-byte rows against ``8-byte
  rows`` and the cut copies; and the even n=320 (E=4096, config 5's fine
  blocks, and E=256, phase 10's) against the baseline;
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
matches the source stops the script with the substitution that failed
(a copy replaces a text, or the source from one text up to another).
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
# The clustered panel's step with two cluster barriers a step, as it was
# before the block barrier: lane r of every warp stores the warp's maximum
# in block r, each warp reduces all of them after the first barrier, and
# the warps that hold the rows p and k store them into every block before
# the second (regions of the source between two markers, replaced).
TWO_BARRIER = [
    (
        "  // A cluster's step publishes into one of two sets",
        "  int* src = reinterpret_cast<int*>(smem_raw);",
        """  constexpr int kSlots = (kCluster ? kMaxCluster : 1) * kBlockedWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T prow[kB];  // the pivot row, raw and rotated
  __shared__ T oldk[kB];  // row k before the swap, rotated
  __shared__ T red_key[kSlots];  // the warp maxima of every block
  __shared__ int red_idx[kSlots];
""",
    ),
    (
        "  // bk pivot steps, as in the blocked route, but with column k0 + t at",
        "  // A ragged last panel rotates on, without arithmetic, until each column",
        """  // bk pivot steps, each behind two barriers, as in the blocked route, but
  // with column k0 + t at v[q][0] in step t: each step rotates a row left
  // by one place, the eliminated column's new entry going to the last
  // place, so that no register is indexed by t (no select tree).  The
  // pivot row is broadcast raw and every thread scales by the pivot itself.
  for (int t = 0; t < bk; ++t) {
    const int k = k0 + t;
    T key = T(-1);
    int idx = n;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = row0 + tid + q * kBlockedThreads;
      if (i >= k && i < n) take_max(key, idx, pivot_key(v[q][0]), i);
    }
    if constexpr (kSpill) {
      for (int m = tid; m < count; m += kBlockedThreads) {
        const T x = sp[static_cast<long long>(m) * ld + t];
        if (first + m >= k) take_max(key, idx, pivot_key(x), first + m);
      }
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const T other_key = __shfl_xor_sync(0xffffffffu, key, off);
      const int other_idx = __shfl_xor_sync(0xffffffffu, idx, off);
      take_max(key, idx, other_key, other_idx);
    }
    // Lane b hands the warp's maximum to block b.
    if (lane < nb) {
      store_to<kCluster>(red_key + rank * kBlockedWarps + warp, key, lane);
      store_to<kCluster>(red_idx + rank * kBlockedWarps + warp, idx, lane);
    }
    sync_all<kCluster>();
    if constexpr (!kCluster) {
      key = red_key[0];
      idx = red_idx[0];
#pragma unroll
      for (int r = 1; r < kBlockedWarps; ++r) take_max(key, idx, red_key[r], red_idx[r]);
    } else {  // up to 64 maxima: two a lane, then a butterfly
      key = T(-1);
      idx = n;
      for (int r = lane; r < nb * kBlockedWarps; r += kWarp) {
        take_max(key, idx, red_key[r], red_idx[r]);
      }
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const T other_key = __shfl_xor_sync(0xffffffffu, key, off);
        const int other_idx = __shfl_xor_sync(0xffffffffu, idx, off);
        take_max(key, idx, other_key, other_idx);
      }
    }
    if (!(key > T(0) && key < T(INFINITY))) {  // the same in every thread of the cluster
      if (rank == 0 && tid == 0) info[e] = k + 1;
      return;
    }
    const int p = idx;
    // The rows p and k, rotated as the register rows are, go to prow and
    // oldk of every block: from the thread that holds them (one block), the
    // warp that holds them (a cluster: one entry a lane, so that each lane
    // stores `blocks` values) or, for a spilled row, the first kB threads.
    if constexpr (!kCluster) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = tid + q * kBlockedThreads;
        if (i == p) {
#pragma unroll
          for (int j = 0; j < kB; ++j) prow[j] = v[q][j];
        }
        if (i == k) {
#pragma unroll
          for (int j = 0; j < kB; ++j) oldk[j] = v[q][j];
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int rel = (s == 0 ? p : k) - row0;
        if (rel >= 0 && rel < kHeld && warp == rel % kBlockedThreads / kWarp) {
          const int q_own = rel / kBlockedThreads;
          T mine = T(0);
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            T x = v[0][j];
#pragma unroll
            for (int q = 1; q < kRows; ++q) x = q == q_own ? v[q][j] : x;
            x = __shfl_sync(0xffffffffu, x, rel % kWarp);
            if (lane == j) mine = x;
          }
          if (lane < kB) {
            for (int b = 0; b < nb; ++b) store_to<kCluster>((s == 0 ? prow : oldk) + lane, mine, b);
          }
        }
      }
    }
    if constexpr (kSpill) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int row = s == 0 ? p : k;
        if (row >= first && row < first + count && tid < kB) {
          const int c = (t + tid) & (kB - 1);
          const T x = c < bk ? sp[static_cast<long long>(row - first) * ld + c] : T(0);
          for (int b = 0; b < nb; ++b) store_to<kCluster>((s == 0 ? prow : oldk) + tid, x, b);
        }
      }
    }
    if (tid == 0) {
      const int s_k = src[k];
      src[k] = src[p];
      src[p] = s_k;
    }
    sync_all<kCluster>();
    const T inv_pivot = T(1) / prow[0];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = row0 + tid + q * kBlockedThreads;
      if (i == k) {
#pragma unroll
        for (int j = 0; j + 1 < kB; ++j) v[q][j] = inv_pivot * prow[j + 1];
        v[q][kB - 1] = inv_pivot;
      } else if (i < n) {
        if (i == p) {  // row p takes the old row k
#pragma unroll
          for (int j = 0; j < kB; ++j) v[q][j] = oldk[j];
        }
        const T f = v[q][0] * inv_pivot;
#pragma unroll
        for (int j = 0; j + 1 < kB; ++j) v[q][j] = fused_mul_add(-f, prow[j + 1], v[q][j + 1]);
        v[q][kB - 1] = -f;
      }
    }
    if constexpr (kSpill) {
      // The spilled rows, in natural order: column c is entry (c - t) mod
      // kB of the rotated rows.  Each is read and written by one thread.
      for (int m = tid; m < count; m += kBlockedThreads) {
        const int i = first + m;
        T* r = sp + static_cast<long long>(m) * ld;
        if (i == k) {
          for (int c = 0; c < bk; ++c) {
            r[c] = c == t ? inv_pivot : inv_pivot * prow[(c - t) & (kB - 1)];
          }
        } else {
          const bool moved = i == p;  // row p takes the old row k
          const T f = (moved ? oldk[0] : r[t]) * inv_pivot;
          for (int c = 0; c < bk; ++c) {
            const int j = (c - t) & (kB - 1);
            r[c] = c == t ? -f : fused_mul_add(-f, prow[j], moved ? oldk[j] : r[c]);
          }
        }
      }
    }
  }
""",
    ),
]
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
    "two-barrier": TWO_BARRIER,
}
CUT = ("no-mma", "no-sweep", "launches-only")

# A run: (label, copy, layout of (n, dtype) as (route, panel columns,
# panel blocks, row stride), matrices a call or None for the whole batch);
# "baseline" stands for each --baseline copy.
def _ld(n, dtype):  # n rounded up to 16 bytes
    vec = 128 // torch.finfo(dtype).bits
    return -(-n // vec) * vec


def planned(n, dtype):
    plan = gj_inverse.launch_plan(n, dtype)
    return plan.route, plan.panel, plan.blocks, plan.ld


def eight_byte_rows(n, dtype):  # the plan's layout, swept in place at stride n
    return (*planned(n, dtype)[:3], n)


def blocked(n, dtype):
    return "blocked", 0, 1, 0


def streamed(n, dtype):  # the streamed route's one-block layout, below its n too
    return "streamed", 32 if n <= 512 else 16, 1, _ld(n, dtype)


def panel_16(n, dtype):
    return "streamed", 16, 1, _ld(n, dtype)


def two_blocks(n, dtype):
    return "streamed", 32, 2, _ld(n, dtype)


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
    ("two-barrier", "two-barrier", planned, None),
    ("baseline", "baseline", planned, None),
    ("1 block b=16 +L2", "kernel", panel_16, None),
    ("2 blocks +L2", "kernel", two_blocks, None),
    ("no-mma", "no-mma", planned, None),
    ("no-sweep", "no-sweep", planned, None),
    ("launches-only", "launches-only", planned, None),
]
L2_WAVES = ("L2 waves", "kernel", planned, 25)
ODD = [
    ("16-byte rows", "kernel", planned, None),
    ("8-byte rows", "kernel", eight_byte_rows, None),
    ("baseline", "baseline", planned, None),
    ("no-mma", "no-mma", planned, None),
    ("no-sweep", "no-sweep", planned, None),
]
EVEN = [ODD[0], *ODD[2:]]
ODD_CLUSTER = [*ODD[:3], LARGE[1], *LARGE[3:]]
EVEN_CLUSTER = [ODD_CLUSTER[0], *ODD_CLUSTER[2:]]
CASES = [
    (289, 1024, torch.float64, ODD),
    (290, 1024, torch.float64, EVEN),
    (1089, 16, torch.float64, ODD_CLUSTER),
    (1090, 16, torch.float64, EVEN_CLUSTER),
    (441, 16, torch.float64, ODD),
    (320, 4096, torch.float64, EVEN),
    (320, 256, torch.float64, EVEN),
    (1056, 16, torch.float64, LARGE),
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
    for *old, new in COPIES.get(name, []):
        # (text, new), or (first, end, new): the text from first up to end
        for mark in old:
            if text.count(mark) != 1:
                raise SystemExit(f"{name}: the source no longer holds {mark!r}")
        first = text.index(old[0])
        end = text.index(old[-1]) + (len(old[0]) if len(old) == 1 else 0)
        if end < first:
            raise SystemExit(f"{name}: {old[-1]!r} comes before {old[0]!r}")
        text = text[:first] + new + text[end:]
    source = OUT / f"{name}.cu"
    source.write_text(text)
    target = OUT / f"lib{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(target))
    # The entry point's arguments after the pointers (a, out, info, then
    # scratch, then work): (E, n), (E, n, route, panel), (E, n, route,
    # panel, blocks) or (E, n, route, panel, blocks, ld).
    ints = (6 if "int blocks, int ld" in text else 5 if "int panel, int blocks" in text
            else 4 if "int* scratch" in text else 2)
    pointers = 3 if ints == 2 else 5 if ints == 6 else 4
    for fn in (lib.mfv2d_gj_inverse_f64, lib.mfv2d_gj_inverse_f32):
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
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
        work = torch.empty((e, n, _ld(n, dtype)), dtype=dtype, device="cuda")
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
            route, panel, blocks, ld = plan_of(n, dtype)
            layout = [gj_inverse.ROUTES.index(route), panel, blocks, ld]
            step = wave or e
            for e0 in range(0, e, step):
                count = min(step, e - e0)
                ptrs = (a[e0:].data_ptr(), out[e0:].data_ptr(), info[e0:].data_ptr())
                if ints == 2:
                    rc = fn(*ptrs, count, n, ctypes.c_void_p(stream))
                elif ints == 6:
                    rc = fn(*ptrs, scratch.data_ptr(), work[e0:].data_ptr(), count, n, *layout,
                            ctypes.c_void_p(stream))
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
