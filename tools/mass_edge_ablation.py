#!/usr/bin/env python3
"""Where the time of csrc/mass_edge.cu goes, and an earlier source beside it, on one GPU.

Run from the repository root:

    python3 tools/mass_edge_ablation.py [--baseline OTHER.cu] [--sweep-only]

Builds copies of ``mfv2d_torch/csrc/mass_edge.cu`` into
``build/mfv2d_torch/ablation/`` (one nvcc each, in parallel):

- ``kernel``: the source as it is;
- ``baseline``: with ``--baseline``, the source of an earlier revision that
  still had the whole-table layout and its C entry points (``bh``, ``bv``
  and ``w`` as they are, no plan), for instance
  ``git show 6c79d94:mfv2d_torch/csrc/mass_edge.cu > build/baseline/mass_edge_6c79d94.cu``;
- ``no-loads``: the f64 fragment loads from the table replaced by values
  made in registers (MMAs, metric loads and stores stay; wrong result);
- ``no-scale``: the multiplies of the f64 B fragments by the metric row,
  and with them its loads, cut out (wrong result);
- ``no-stores``: the stores of the result cut out (metric rows, table
  copies, fragment loads and MMAs stay);
- ``no-mma``: the MMAs cut out, and with them the fragment loads (metric
  rows, table copies and stores of zeros stay);
- ``copies-only``: both cut out (metric rows and table copies);
- ``unroll-2``, ``unroll-4``: the f64 loop over quadrature points unrolled
  twice and four times instead of not at all;
- ``all-quadrants``: nothing taken from the symmetry of M1: hh and vv
  computed below the diagonal too, vh computed like hv, nothing mirrored
  (launched with a tile list of all four quadrants, made here);
- ``ticks``: the source with ``clock64()`` read by thread 0 of block 0 at
  each phase boundary.

For each timed shape in f64 (p=4 and p=8 at E=4096, p=10 at E=1024, with
the solver's over-integration of 3) it prints the plain PyTorch version's
CUDA-event time and each copy twice, timed in turns (A B B A), every time
the median over 10 runs of 10 launches back to back, per launch.  The
baseline is left out where it refuses the shape (p=10).  Then the source
itself under other launch plans than the wrapper's: the other warp tile,
other numbers of elements a step and of warps, and shorter chunks where the
table is streamed.  Copies that store a result are held against the plain
version to 1e-12.  Then the cycles of block 0's first warp by phase, from
one launch of the ``ticks`` copy.  Then, for every order from 1 to 12 at
E=1024, the time under each warp tile beside the one the plan picks.

Last (alone with ``--sweep-only``) the sweep of small batches behind the
route switch of ``launch_plan`` and its choice of panel: at p=4 to 16
(over-integration 3) and E=1, 2, 4, 8, 16, 32, 64, 128, 256 and 512, the
element route and the panel route under panels of 4 x 4, 3 x 3, 2 x 2 and
1 x 1 warp tiles, forced, each held against the plain version to 1e-12 and
timed in turns, beside the einsum of the smoke's library call and the plan
the wrapper picks; then, for each order, the batches where a panel wins.

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

from chip_smoke import m1_library_call  # noqa: E402
from mfv2d_torch.ops import mass as plain  # noqa: E402
from mfv2d_torch.ops.basis import FemCache  # noqa: E402
from mfv2d_torch.ops.kernels import _build  # noqa: E402
from mfv2d_torch.ops.kernels import mass_edge as wrapper  # noqa: E402

OUT = ROOT / "build" / "mfv2d_torch" / "ablation"
BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
CASES = [((4, 4), 4096), ((8, 8), 4096), ((10, 10), 1024)]
TOL = 1e-12

NO_STORES = [("      if (r < q.q_rows) {", "      if (r < q.q_rows && n1 < 0) {")]
NO_MMA = [
    (
        "        if (mask >> (pi * NC + j) & 1u) mma_pair(acc[pi][j], a[pi][0], a[pi][1], b[j]);\n",
        "",
    )
]
PHASES = [
    "to the first barrier (table copy, first metric rows)",
    "metric rows of the next step",
    "tile set-up; ring: wait, barrier, next request",
    "tile set-up, fragment loads and MMAs",
    "stores",
    "the step's barrier",
]
TICKS = [
    (
        "namespace {\n\nconstexpr int kBlock = 8;",
        "__device__ unsigned long long ablation_cycles[6];\n"
        "#define TICK(slot) do { if (blockIdx.x == 0 && threadIdx.x == 0) {"
        " const long long now_ = clock64(); ablation_cycles[slot] += now_ - last_tick;"
        " last_tick = now_; } } while (0)\n"
        "namespace {\n\nconstexpr int kBlock = 8;",
    ),
    (
        "  const bool resident = p.stages == 1;\n",
        "  long long last_tick = clock64();\n  const bool resident = p.stages == 1;\n",
    ),
    ("  __syncthreads();\n\n  int set = 0;", "  __syncthreads();\n  TICK(0);\n\n  int set = 0;"),
    (
        "metric_rows(set ^ 1, grp + gridDim.x);\n",
        "metric_rows(set ^ 1, grp + gridDim.x);\n    TICK(1);\n",
    ),
    ("          request_chunk();\n        }\n", "          request_chunk();\n        }\n        TICK(2);\n"),
    (
        "        if (!resident) slot = slot + 1 == kRingStages",
        "        TICK(3);\n        if (!resident) slot = slot + 1 == kRingStages",
    ),
    (
        "      }\n    }\n    // The next step's metric rows are written; this step's are free.\n"
        "    __syncthreads();\n",
        "      }\n      TICK(4);\n    }\n    __syncthreads();\n    TICK(5);\n",
    ),
]
TICK_ENTRIES = """
extern "C" void ablation_reset() {
  unsigned long long zero[6] = {};
  cudaMemcpyToSymbol(ablation_cycles, zero, sizeof(zero));
}
extern "C" void ablation_read(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, ablation_cycles, sizeof(ablation_cycles));
}
"""
UNROLL = "#pragma unroll 1\n  for (int s = 0; s < n_points; s += kStep) {"
F64_A = (
    "    double b[NC];\n#pragma unroll\n    for (int i = 0; i < 2 * MP; ++i) {\n"
    "      a[i / 2][i % 2] = rows[i * kBlock];\n"
)
F64_B = "      b[j] = cols[j * kBlock] * ks;\n"
NO_LOADS = [
    (F64_A, F64_A.replace("rows[i * kBlock]", "1.0 + s")),
    (F64_B, F64_B.replace("cols[j * kBlock]", "(1.0 - s)")),
]
NO_SCALE = [(F64_B, F64_B.replace(" * ks", ""))]
ALL_QUADRANTS = [
    ("!(q.diagonal && cb0 + j < rb)", "true"),
    ("      if (q.diagonal && cb0 + j < rb0 + i) continue;\n", ""),
    (
        "const bool mirror = quad == kQuadHV || (q.diagonal && cb0 + j > rb0 + i);",
        "const bool mirror = false;",
    ),
]
COPIES = {
    "kernel": [],
    "all-quadrants": ALL_QUADRANTS,
    "no-loads": NO_LOADS,
    "no-scale": NO_SCALE,
    "unroll-2": [(UNROLL, UNROLL.replace("unroll 1", "unroll 2"))],
    "unroll-4": [(UNROLL, UNROLL.replace("unroll 1", "unroll 4"))],
    "no-stores": NO_STORES,
    "no-mma": NO_MMA,
    "copies-only": NO_STORES + NO_MMA,
    "ticks": TICKS,
}
CUT = ("no-stores", "no-mma", "copies-only", "no-loads", "no-scale")


def build(name: str, baseline: Path | None) -> ctypes.CDLL:
    if name == "baseline":
        text = baseline.read_text()
    else:
        text = (_build.CSRC / "mass_edge.cu").read_text()
    for old, new in COPIES.get(name, []):
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    if name == "ticks":
        text += TICK_ENTRIES
    source = OUT / f"mass_edge-{name}.cu"
    source.write_text(text)
    target = OUT / f"libmass_edge-{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(target))
    fn = lib.mfv2d_mass_edge_f64
    fn.restype = ctypes.c_int
    if name == "baseline":
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        )
    return lib


def inputs(orders, e, seed=1):
    tb = plain.tensor_basis(FemCache(3).get_basis2d(*orders))
    rng = np.random.default_rng(seed)
    corners = np.tile(BASE, (e, 1, 1)) + 0.08 * rng.normal(size=(e, 4, 2))
    return tb, plain.batch_jacobian(tb, torch.tensor(corners, device="cuda"))


def launch_baseline(lib, tb, jac, out):
    """A launch of the whole-table source's entry point, which returns 0 or
    its CUDA error."""
    tables = [plain.as_like(a, jac.det).contiguous() for a in (tb.bh, tb.bv, tb.w)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run() -> int:
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*jac, *tables, out)]
        return lib.mfv2d_mass_edge_f64(
            *ptrs, jac.det.shape[0], tb.bh.shape[0], tb.bv.shape[0], jac.det.shape[1], stream
        )

    return run


def per_launch_ms(fn, reps: int = 10, inner: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def launcher(lib, tb, jac, out, plan):
    """A callable that launches ``lib``'s f64 entry point with ``plan`` into
    ``out`` on the current stream."""
    tensors = (*jac, *wrapper._device_tables(tb, plan, jac.det), out)
    shapes = (jac.det.shape[0], tb.bh.shape[0], tb.bv.shape[0], jac.det.shape[1])
    ints = plan.as_ints()
    plan_array = (ctypes.c_int * len(ints))(*ints)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run() -> None:
        pointers = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
        rc = lib.mfv2d_mass_edge_f64(*pointers, *shapes, plan_array, stream)
        if rc != 0:
            raise RuntimeError(f"the launch failed with CUDA error {rc}")

    return run


def plan_variant(plan, n_h, n_v, **changes):
    """``plan`` with some fields replaced and its tile list made to match."""
    plan = plan._replace(**changes)
    tiles = wrapper.tile_list(-(-n_h // 8), -(-n_v // 8), plan.mr, plan.nc)
    return plan._replace(tiles=tiles)


def all_quadrants(plan, n_h, n_v):
    """``plan`` with the tiles of all four quadrants in full, for the
    ``all-quadrants`` copy: quadrant 3 is vh, rows v and columns h."""
    nb = {"h": -(-n_h // 8), "v": -(-n_v // 8)}
    tiles = []
    for quad, (rows, cols) in enumerate(("hh", "hv", "vv", "vh")):
        for tr in range(-(-nb[rows] // plan.mr)):
            for tc in range(-(-nb[cols] // plan.nc)):
                n_rows = min(plan.mr, nb[rows] - tr * plan.mr)
                n_cols = min(plan.nc, nb[cols] - tc * plan.nc)
                tiles.append((-(-(-n_rows // 2)) * n_cols, quad << 28 | tr << 14 | tc))
    return plan._replace(tiles=tuple(code for _, code in sorted(tiles)))


def timed_in_turns(runs: dict) -> dict:
    times = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        times[name].append(per_launch_ms(runs[name]))
    return times


SWEEP_ORDERS = range(4, 17)
SWEEP_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
SWEEP_PANELS = ((4, 4), (3, 3), (2, 2), (1, 1))


def sweep(lib) -> None:
    """Both routes forced at small batches, beside the einsum and the plan
    the wrapper picks."""
    card = wrapper.card(torch.device("cuda", 0))
    wins = {}
    for p in SWEEP_ORDERS:
        for e in SWEEP_BATCHES:
            tb, jac = inputs((p, p), e)
            n_h, n_v, nq = tb.bh.shape[0], tb.bv.shape[0], tb.w.size
            element = wrapper.element_plan(n_h, n_v, nq, torch.float64)
            plans = {"element": element}
            for panel in SWEEP_PANELS:
                plans[f"panel {panel[0]}x{panel[1]}"] = wrapper.panel_plan(
                    n_h, n_v, nq, torch.float64, element.mr, element.nc, e, card, panel=panel
                )
            picked = wrapper.launch_plan(n_h, n_v, nq, torch.float64, e, card)
            picked_name = next(name for name, plan in plans.items() if plan == picked)
            ref = plain.mass_edge(tb, jac)
            out = torch.empty_like(ref)
            runs = {name: launcher(lib, tb, jac, out, plan) for name, plan in plans.items()}
            for name, run in runs.items():
                out.fill_(float("nan"))
                run()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max() / ref.abs().max())
                if not err <= TOL:
                    raise RuntimeError(f"p={p} E={e} {name}: {err:.3e}")
            times = {name: min(t) for name, t in timed_in_turns(runs).items()}
            einsum_ms = per_launch_ms(m1_library_call(tb, jac))
            best = min(times, key=times.get)
            line = " ".join(f"{name} {ms:.4f}" for name, ms in times.items())
            print(
                f"sweep p={p:2d} E={e:3d} (element route: {-(-e // element.group)} blocks,"
                f" {len(element.tiles)} tiles an element): {line} ms; einsum"
                f" {einsum_ms:.4f} ms; fastest {best}, the wrapper picks {picked_name}"
                f" ({times[picked_name] / times[best]:.2f}x the fastest)"
            )
            if best != "element":
                wins.setdefault(p, []).append(e)
            del ref, out
    for p in SWEEP_ORDERS:
        print(f"sweep p={p:2d}: a panel route is fastest at E in {wins.get(p, [])}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", type=Path, help="an earlier mass_edge.cu, timed beside the source"
    )
    parser.add_argument(
        "--sweep-only", action="store_true", help="build the source and run the sweep only"
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mass_edge_ablation: no CUDA device.", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    OUT.mkdir(parents=True, exist_ok=True)
    if args.sweep_only:
        sweep(build("kernel", None))
        return 0
    names_built = [*COPIES, "baseline"] if args.baseline else list(COPIES)
    with ThreadPoolExecutor(len(names_built)) as pool:
        libs = dict(
            zip(names_built, pool.map(lambda name: build(name, args.baseline), names_built))
        )

    for orders, e in CASES:
        tb, jac = inputs(orders, e)
        n_h, n_v, nq = tb.bh.shape[0], tb.bv.shape[0], tb.w.size
        plan = wrapper.element_plan(n_h, n_v, nq, torch.float64)
        ref = plain.mass_edge(tb, jac)
        out = torch.empty_like(ref)
        plain_ms = per_launch_ms(lambda: plain.mass_edge(tb, jac), inner=1)
        print(
            f"p={orders} E={e} f64: plain version {plain_ms:.4f} ms; plan: warp tile"
            f" {plan.mr}x{plan.nc}, {len(plan.tiles)} tiles, {plan.stages} stages of"
            f" {plan.chunk} points, {plan.group} elements a step, {plan.warps} warps,"
            f" {plan.smem_bytes} bytes of shared memory"
        )

        def check(name):
            torch.cuda.synchronize()
            err = float((out - ref).abs().max() / ref.abs().max())
            if not err <= TOL:
                raise RuntimeError(f"{name} disagrees with the plain version: {err:.3e}")
            return err

        runs = {name: launcher(libs[name], tb, jac, out, plan) for name in COPIES}
        runs["all-quadrants"] = launcher(
            libs["all-quadrants"], tb, jac, out, all_quadrants(plan, n_h, n_v)
        )
        if "baseline" in libs:
            baseline = launch_baseline(libs["baseline"], tb, jac, out)
            rc = baseline()
            torch.cuda.synchronize()
            if rc == 0:
                runs["baseline"] = baseline
            else:
                print(f"  baseline         refuses the shape (CUDA error {rc})")
        for name, (first, again) in timed_in_turns(runs).items():
            line = f"  {name:16s} {first:9.4f} ms, again {again:9.4f} ms"
            if name not in CUT:
                out.zero_()
                runs[name]()
                line += f", rel err {check(name):.3e}"
            print(line)

        # The same source under other plans, each beside the wrapper's own.
        variants = {"plan of the wrapper": plan}
        other = next(t for t in wrapper.WARP_TILES if t != (plan.mr, plan.nc))
        variants[f"warp tile {other[0]}x{other[1]}"] = wrapper.plan_with_tile(
            n_h, n_v, nq, torch.float64, *other
        )
        for group in (plan.group // 2, plan.group * 2):
            candidate = plan_variant(plan, n_h, n_v, group=group)
            ring = candidate.stages * candidate.chunk * candidate.ld
            need = (ring + 6 * group * candidate.nq_pad) * 8 + 4 * len(candidate.tiles) + 16
            if group >= 1 and need <= wrapper.SMEM_LIMIT:
                variants[f"{group} elements a step"] = candidate
        variants[f"{24 - plan.warps} warps"] = plan_variant(plan, n_h, n_v, warps=24 - plan.warps)
        if plan.stages > 1:
            for chunk in (c for c in wrapper.CHUNKS if c < plan.chunk):
                variants[f"chunks of {chunk} points"] = plan_variant(
                    plan, n_h, n_v, chunk=chunk, nq_pad=-(-nq // chunk) * chunk
                )
        runs = {name: launcher(libs["kernel"], tb, jac, out, v) for name, v in variants.items()}
        for name, (first, again) in timed_in_turns(runs).items():
            out.zero_()
            runs[name]()
            print(
                f"  {name:28s} {first:9.4f} ms, again {again:9.4f} ms,"
                f" rel err {check(name):.3e}"
            )
        lib = libs["ticks"]
        cycles = (ctypes.c_ulonglong * len(PHASES))()
        lib.ablation_reset()
        launcher(lib, tb, jac, out, plan)()
        torch.cuda.synchronize()
        lib.ablation_read(cycles)
        total = sum(cycles)
        print(f"  block 0, warp 0, one launch: {total} cycles")
        for phase, c in zip(PHASES, cycles):
            print(f"    {phase:52s} {c:10d} {100 * c / total:5.1f}%")
        del ref, out

    # Which warp tile is faster at each order, beside the plan's choice.
    e, n_check = 1024, 32
    for p in range(1, 13):
        tb, jac = inputs((p, p), e)
        n_h, n_v, nq = tb.bh.shape[0], tb.bv.shape[0], tb.w.size
        plan = wrapper.element_plan(n_h, n_v, nq, torch.float64)
        ref = plain.mass_edge(tb, type(jac)(*(t[:n_check].contiguous() for t in jac)))
        out = torch.empty((e, n_h + n_v, n_h + n_v), dtype=torch.float64, device="cuda")
        runs = {
            f"{mr}x{nc}": launcher(
                libs["kernel"], tb, jac, out,
                wrapper.plan_with_tile(n_h, n_v, nq, torch.float64, mr, nc),
            )
            for mr, nc in wrapper.WARP_TILES
        }
        line = f"p={p:2d} E={e} warp tiles:"
        for name, (first, again) in timed_in_turns(runs).items():
            out.zero_()
            runs[name]()
            torch.cuda.synchronize()
            err = float((out[:n_check] - ref).abs().max() / ref.abs().max())
            if not err <= TOL:
                raise RuntimeError(f"p={p}, warp tile {name}: {err:.3e}")
            line += f" {name} {first:.4f} / {again:.4f} ms,"
        print(f"{line} the plan picks {plan.mr}x{plan.nc}")
        del ref, out
    sweep(libs["kernel"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
