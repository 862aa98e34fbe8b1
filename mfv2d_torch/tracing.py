"""Lightweight stage tracing for solves (an aux subsystem the reference
lacks entirely — SURVEY section 5 lists "Tracing / profiling: none").

Enable with ``MFV2D_TORCH_TRACE=1`` (prints a table at the end of each
``solve_system_2d`` call) or programmatically::

    from mfv2d_torch.tracing import tracer
    tracer.enable()
    ... solve ...
    print(tracer.report())

Set ``MFV2D_TORCH_TRACE_FILE=/path.jsonl`` to also append one JSON line per
stage event (wall-clock seconds, monotonic), suitable for external
dashboards.  When disabled the per-stage overhead is a single attribute
check.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


class Tracer:
    """Accumulates (calls, total seconds) per named stage."""

    def __init__(self) -> None:
        self.enabled = bool(os.environ.get("MFV2D_TORCH_TRACE"))
        self._file = os.environ.get("MFV2D_TORCH_TRACE_FILE")
        self.stages: dict[str, tuple[int, float]] = {}
        self._stack: list[str] = []

    def enable(self, file: str | None = None) -> None:
        self.enabled = True
        if file is not None:
            self._file = file

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.stages = {}

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        self._stack.append(name)
        full = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            calls, total = self.stages.get(full, (0, 0.0))
            self.stages[full] = (calls + 1, total + dt)
            if self._file:
                with open(self._file, "a") as f:
                    f.write(
                        json.dumps(
                            {"stage": full, "seconds": dt, "t": time.time()}
                        )
                        + "\n"
                    )

    def add(self, name: str, seconds: float) -> None:
        """Record an externally-timed span."""
        if not self.enabled:
            return
        calls, total = self.stages.get(name, (0, 0.0))
        self.stages[name] = (calls + 1, total + seconds)
        if self._file:
            with open(self._file, "a") as f:
                f.write(
                    json.dumps(
                        {"stage": name, "seconds": seconds, "t": time.time()}
                    )
                    + "\n"
                )

    def report(self) -> str:
        """Fixed-width table of stages sorted by total time."""
        if not self.stages:
            return "(no stages traced)"
        width = max(len(k) for k in self.stages)
        lines = [f"{'stage':<{width}}  {'calls':>6}  {'total [s]':>10}"]
        for name, (calls, total) in sorted(
            self.stages.items(), key=lambda kv: -kv[1][1]
        ):
            lines.append(f"{name:<{width}}  {calls:>6}  {total:>10.3f}")
        return "\n".join(lines)


tracer = Tracer()
