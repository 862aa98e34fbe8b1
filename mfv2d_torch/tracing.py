"""Stage tracing for solves: spans, their totals per stage, and counters
(an aux subsystem the reference lacks entirely — SURVEY section 5 lists
"Tracing / profiling: none").

Turn it on with ``MFV2D_TORCH_TRACE=1``, which also prints :meth:`Tracer.
report` at the end of every ``solve_system_2d`` call, or in code, which
prints nothing::

    from mfv2d_torch.tracing import tracer
    tracer.enable()
    ... solve ...
    print(tracer.report())

While the tracer is on:

- every :meth:`Tracer.stage` is a :class:`Span` in ``tracer.spans``: its
  id, the id of the span that encloses it, the id of the
  ``solve_system_2d`` call it ran in, its name and path (the names of the
  open spans joined by ``/``), and its start and end on
  ``time.perf_counter_ns()``.  ``tracer.stages`` keeps the calls and
  seconds per path, ``{path: (calls, seconds)}``;
- every span is also a ``torch.profiler.record_function`` range named
  ``mfv2d:<path>``: under a ``torch.profiler`` run the stages sit in its
  trace, nested, beside the kernels and copies and on the trace's clock;
- :meth:`Tracer.count` adds to a counter, per name and per innermost open
  span: ``solves`` (one a ``solve_system_2d`` call), ``h2d_bytes`` and
  ``d2h_bytes`` (the explicit host-device copies, made through
  :mod:`mfv2d_torch.transfer`), ``superlu_min_degree`` and
  ``superlu_colamd`` (the trace Schur factorizations by the column ordering
  each took, :func:`mfv2d_torch.solver.iterative.trace_column_ordering`),
  ``march_steps`` (one a step of a trapezoidal march on the host loop,
  counted inside its ``march-step`` span; the step's residuals, update
  solves and reconstruction sit under that span, and its carry projection
  and update in ``march-step/carry``), ``frozen_solve_host`` and
  ``frozen_solve_card`` (each solve of a
  :class:`mfv2d_torch.solver.solve.FrozenSaddleSolver` by SciPy's SuperLU or
  by the factors' sweeps on the card; the card's schedule is built once a
  factorization inside the span ``frozen-solve-prepare``).

:meth:`Tracer.reset` clears the totals, spans and counters.  Off, a stage
or a count costs one attribute check.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass

from torch.profiler import record_function


@dataclass(slots=True)
class Span:
    """One stage call; ``end_ns`` is None while it is open."""

    id: int
    parent: int | None
    solve: int | None
    name: str
    path: str
    start_ns: int
    end_ns: int | None = None


class Tracer:
    """Stage spans, their (calls, total seconds) per path, and counters."""

    def __init__(self) -> None:
        self.enabled = bool(os.environ.get("MFV2D_TORCH_TRACE"))
        self._report_each_solve = self.enabled
        self._open: list[Span] = []
        self._solve: int | None = None
        self._next_id = 0
        self.reset()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.stages: dict[str, tuple[int, float]] = {}
        self.spans: list[Span] = []
        # {innermost open span's path ("" for none): {name: total}}
        self.counters: dict[str, dict[str, int]] = {}

    def _new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        parent = self._open[-1] if self._open else None
        path = name if parent is None else f"{parent.path}/{name}"
        span = Span(
            self._new_id(),
            None if parent is None else parent.id,
            self._solve,
            name,
            path,
            time.perf_counter_ns(),
        )
        self.spans.append(span)
        self._open.append(span)
        try:
            with record_function("mfv2d:" + path):
                yield
        finally:
            span.end_ns = time.perf_counter_ns()
            self._open.pop()
            calls, total = self.stages.get(path, (0, 0.0))
            self.stages[path] = (calls + 1, total + (span.end_ns - span.start_ns) * 1e-9)

    @contextmanager
    def solve(self):
        """One ``solve_system_2d`` call: counts ``solves`` and gives the
        spans opened inside it the call's id; under ``MFV2D_TORCH_TRACE``
        prints the report at its end."""
        if not self.enabled:
            yield
            return
        self.count("solves")
        outer, self._solve = self._solve, self._new_id()
        try:
            yield
        finally:
            self._solve = outer
            if self._report_each_solve and self.enabled:
                print(self.report())

    def add(self, name: str, seconds: float) -> None:
        """Record an externally-timed span."""
        if not self.enabled:
            return
        calls, total = self.stages.get(name, (0, 0.0))
        self.stages[name] = (calls + 1, total + seconds)

    def count(self, name: str, amount: int = 1) -> None:
        """Add ``amount`` to the counter ``name`` of the innermost open span."""
        if not self.enabled:
            return
        at = self.counters.setdefault(self._open[-1].path if self._open else "", {})
        at[name] = at.get(name, 0) + amount

    def total(self, name: str) -> int:
        """The counter ``name`` summed over every span."""
        return sum(at.get(name, 0) for at in self.counters.values())

    def report(self) -> str:
        """Fixed-width table of stages sorted by total time, each with its
        counters under it; counters outside any stage come last."""
        if not self.stages and not self.counters:
            return "(no stages traced)"
        width = max(len(k) for k in (*self.stages, *self.counters, "(outside the stages)"))
        lines = [f"{'stage':<{width}}  {'calls':>6}  {'total [s]':>10}"]

        def counters(path: str) -> None:
            for name, amount in sorted(self.counters.get(path, {}).items()):
                lines.append(f"  {name:<{width}}  {amount:>16}")

        for path, (calls, total) in sorted(self.stages.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{path:<{width}}  {calls:>6}  {total:>10.3f}")
            counters(path)
        for path in sorted(set(self.counters) - set(self.stages)):
            lines.append(path or "(outside the stages)")
            counters(path)
        return "\n".join(lines)


tracer = Tracer()
