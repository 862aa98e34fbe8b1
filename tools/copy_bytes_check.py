"""Hold the tracer's host-device byte counters against ``torch.profiler``.

    python3 tools/copy_bytes_check.py [--cells NAME ...] [--seed N]

On a CUDA card, for each benchmark cell (``BENCHMARK.json``; all by
default): one cold solve, one warm solve, then one warm solve with the
tracer on under ``torch.profiler``.  Prints, per cell, the tracer's
``h2d_bytes`` and ``d2h_bytes`` beside the bytes of the trace's HtoD and
DtoH memcpy events, and the tracer's seconds per stage path beside the
trace's ``mfv2d:<path>`` ranges.  Exits 1 where a byte count is more than
1% off the trace's, or no stage has its range.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def trace_events(fn):
    """``fn()`` and a synchronise under ``torch.profiler``; its chrome trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def memcpy_bytes(events) -> dict:
    out = {"h2d_bytes": 0, "d2h_bytes": 0}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            key = "h2d_bytes" if "HtoD" in e["name"] else "d2h_bytes" if "DtoH" in e["name"] else None
            if key:
                out[key] += int(e.get("args", {}).get("bytes", 0))
    return out


def ranges(events) -> dict:
    """Seconds of the host ``mfv2d:<path>`` ranges, per path."""
    out = defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("mfv2d:") and e.get(
            "cat"
        ) != "gpu_user_annotation":
            out[e["name"][len("mfv2d:"):]] += float(e.get("dur", 0.0)) * 1e-6
    return out


def check_cell(name: str, seed: int) -> bool:
    import torch

    import manifest
    import mfv2d_torch as mf
    from mfv2d_torch.tracing import tracer
    from traffic import amplitudes, curved_square

    cell = manifest.load_cell(name)
    arguments = manifest.adapter(cell).problem(cell.config, cell.traffic)
    n, p = cell.traffic["mesh"], cell.traffic["order"]
    draws = amplitudes(seed, cell.traffic)

    def solve():
        mesh = mf.examples.unit_square_mesh(n, n, p, deformation=curved_square(next(draws)))
        mf.solve_system_2d(mesh, device="cuda", **arguments(mesh))
        torch.cuda.synchronize()

    for _ in range(2):
        solve()
    tracer.reset()
    tracer.enable()
    t = time.perf_counter()
    events = trace_events(solve)
    wall = time.perf_counter() - t
    tracer.disable()
    seen = memcpy_bytes(events)
    ok = True
    print(f"{name} (seed {seed}, profiled warm solve {wall:.4f} s):")
    for key in ("h2d_bytes", "d2h_bytes"):
        counted = tracer.total(key)
        off = abs(counted - seen[key]) / max(seen[key], 1)
        ok &= off <= 0.01
        print(f"  {key}: tracer {counted} profiler {seen[key]} ({100 * off:.4f}% off)")
    spans = ranges(events)
    ok &= bool(spans)
    for path, (calls, seconds) in sorted(tracer.stages.items(), key=lambda kv: -kv[1][1]):
        print(f"  stage {path:36s} {calls:4d} calls {seconds:10.4f} s; range {spans.get(path, 0.0):10.4f} s")
    tracer.reset()
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", nargs="*")
    parser.add_argument("--seed", type=int, default=2147483659)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("copy_bytes_check.py: needs a CUDA device.", file=sys.stderr)
        return 2
    import manifest
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge

    mass_edge.library()
    gj_inverse.library()
    cells = args.cells or [w["name"] for w in manifest.load_manifest()["workloads"]]
    print(torch.cuda.get_device_name(0), flush=True)
    results = [check_cell(name, args.seed) for name in cells]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
