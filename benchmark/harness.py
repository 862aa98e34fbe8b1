"""One run of one cell: set-up, the measured window, the comparison.

Set-up imports the program, initialises the device, loads the two kernel
libraries (built once into the checkout's ``build/``) and makes the first
solve, which is cold: its plans are built and its tables uploaded there.
The window then repeats, closed loop and back to back, a new mesh and a
solve on it, until ``seconds`` have passed and the solve in flight ends.
With ``trace`` the program's tracer is on in the window, and one more
solve runs after it under the profiler.  Every solve's answer is kept on
the host and judged once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

import check
import manifest
from device_trace import Profile, profile_call
from traffic import amplitudes, curved_square

# The kernels that mark one wrapper call each: M1's one kernel; the
# inverse's register or blocked kernel, or the streamed route's last one.
CALL_KERNELS = {"mass_edge": ("mass_edge",), "gj_inverse": ("gj_inverse_", "gj_streamed_unswap")}


@dataclass
class Run:
    """What a traced run measured, for the per-layer readers."""

    config: dict
    traffic: dict
    solves: int
    first_solve_s: float
    mesh_seconds: float
    stages: dict
    peak_bytes: int
    profile: Profile | None = None
    launches: dict = field(default_factory=dict)

    def stage_seconds(self, name: str) -> float | None:
        """A tracer stage's seconds per solve of the window, or None where
        the window never entered it."""
        if name not in self.stages or not self.solves:
            return None
        return self.stages[name][1] / self.solves


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str,
             clock_start: float, log=sys.stderr) -> dict:
    """Run the cell once and return the result line's object, with the
    numbers compared under ``checks``."""
    import torch

    import mfv2d_torch as mf
    from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
    from mfv2d_torch.tracing import tracer

    cuda = device == "cuda"
    if cuda:
        torch.zeros(1, device=device)
        mass_edge.library()
        gj_inverse.library()
        torch.cuda.synchronize()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arguments = manifest.adapter(cell).problem(cell.config, cell.traffic)
    n, p = cell.traffic["mesh"], cell.traffic["order"]
    draws = amplitudes(seed, cell.traffic)

    def make_mesh(a):
        return mf.examples.unit_square_mesh(n, n, p, deformation=curved_square(a))

    def solve(mesh):
        grids, _, _ = mf.solve_system_2d(mesh, device=device, **arguments(mesh))
        sync()
        return grids[-1]

    answers: list[check.Answer] = []

    def keep(a, grid):
        answers.append(check.Answer(a, np.array(grid.points), dict(grid.point_data)))

    a = next(draws)
    mesh = make_mesh(a)
    t = time.perf_counter()
    grid = solve(mesh)
    first_solve_s = time.perf_counter() - t
    keep(a, grid)
    setup_s = time.perf_counter() - clock_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    failed = solves = 0
    mesh_seconds = 0.0
    walls = []
    if trace:
        tracer.reset()
        tracer.enable()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    while True:
        a = next(draws)
        try:
            t = time.perf_counter()
            mesh = make_mesh(a)
            mesh_seconds += time.perf_counter() - t
            grid = solve(mesh)
            walls.append(time.perf_counter() - t)
        except Exception:
            failed += 1
            traceback.print_exc(file=log)
            break
        keep(a, grid)
        solves += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    run = None
    if trace:
        tracer.disable()
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        run = Run(cell.config, cell.traffic, solves, first_solve_s, mesh_seconds,
                  dict(tracer.stages), window_peak)
        if not failed:
            a = next(draws)
            mesh = make_mesh(a)
            wrappers = {"mass_edge": mass_edge, "gj_inverse": gj_inverse}
            before = {name: w.launches for name, w in wrappers.items()}
            grid, run.profile = profile_call(lambda: solve(mesh), sync, tracer, cuda)
            keep(a, grid)
            run.launches = {name: w.launches - before[name] for name, w in wrappers.items()}
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())
    del mesh, grid
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    exact, magnitude = manifest.judged_fields(cell)
    values = check.worst([check.readings(x, cell.traffic, exact, magnitude) for x in answers],
                         cell.limits)
    correct = failed == 0 and check.judge(values, cell.limits)
    print(
        f"{cell.name} seed {seed}: {solves} solves in {window_s:.4f} s of window,"
        f" first solve {first_solve_s:.4f} s, set-up {setup_s:.4f} s, {failed} failed,"
        f" {len(answers)} answers judged; solves (mesh and call) "
        + " ".join(f"{w:.4f}" for w in walls) + " s",
        flush=True,
    )
    result = {
        "correct": bool(correct),
        "attempted": solves + failed,
        "failed": failed,
        "metrics": {},
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["metrics"] = per_layer(cell, run)
        if run.profile is not None:
            result["device"]["busy_s"] = run.profile.busy_s
            result["device"]["window_s"] = run.profile.window_s
            result["breakdown"] = {
                "device_ops": run.profile.top_ops(10),
                "idle_gaps": [list(g) for g in run.profile.gaps[:10]],
            }
            for name, launched in run.launches.items():
                seen = sum(run.profile.kernel_count(k) for k in CALL_KERNELS[name])
                note = "" if seen == launched else " (the profiler lost calls)"
                print(f"  {name} calls: the profiler saw {seen}, the wrapper counted"
                      f" {launched}{note}", flush=True)
        for name, (calls, total) in sorted(run.stages.items(), key=lambda kv: -kv[1][1]):
            print(f"  stage {name:28s} {total:10.4f} s ({calls} calls)", flush=True)
    else:
        e2e = {"solve_s": window_s / solves if solves else None, "setup_s": setup_s}
        for metric in cell.end_to_end:
            if e2e.get(metric["name"]) is not None:
                result["metrics"][metric["name"]] = {
                    "value": e2e[metric["name"]], "unit": metric["unit"]}
    result["checks"] = {
        name: {"value": values[name], "limit": limit} for name, limit in cell.limits.items()
    }
    return result


def per_layer(cell: manifest.Cell, run: Run) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for metric in cell.per_layer:
        value = manifest.reader(cell, metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out
