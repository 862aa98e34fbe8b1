"""Terminal reporting for iterative solves: status line and histograms.

Fills the same role as the reference's progress module (an in-place status
line for the nonlinear loop and text histograms for error/order
distributions) with an original rendering: convergence is shown as the
fraction of the log-residual distance already covered, drawn as a single
percent-style bar, and histograms carry a count axis on the left margin.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import numpy.typing as npt

_RESET = "\033[0m"


def _tint(text: str, fraction: float) -> str:
    """Color text red/yellow/green by how far along convergence is."""
    if fraction >= 1.0:
        code = "\033[32m"
    elif fraction > 0.0:
        code = "\033[33m"
    else:
        code = "\033[31m"
    return code + text + _RESET


def _bar(fraction: float, width: int) -> str:
    """A percent bar: '=' for covered cells, '>' at the frontier."""
    fraction = min(max(fraction, 0.0), 1.0)
    filled = int(round(fraction * width))
    if 0 < filled < width:
        return "=" * (filled - 1) + ">" + "." * (width - filled)
    return "=" * filled + "." * (width - filled)


@dataclass
class ProgressTracker:
    """Single-line convergence status for a nonlinear iteration.

    Progress toward the tolerance is measured in log space: with a starting
    residual ``r0``, current residual ``r`` and tolerance ``tol``, the
    covered fraction is ``log(r0/r) / log(r0/tol)`` — 0 at the start, 1 at
    convergence, negative if the residual grew.
    """

    err_tol: float
    err_initial: float
    err_cur: float
    iter_max: int
    iter_cur: int = 0
    iter_width: int = 10
    err_width: int = 10
    _history: list[float] = field(default_factory=list)

    _PULSE = ".oOo"

    def update_iteration(self, new_err: float) -> None:
        """Record the residual of one more completed iteration."""
        self._history.append(float(new_err))
        self.err_cur = float(new_err)
        self.iter_cur = min(self.iter_cur + 1, self.iter_max)

    @property
    def converged_fraction(self) -> float:
        """Fraction of the log-residual distance to tolerance covered."""
        span = math.log(self.err_initial) - math.log(self.err_tol)
        if span <= 0.0:
            return 1.0
        if self.err_cur <= 0.0:
            return 1.0
        return (math.log(self.err_initial) - math.log(self.err_cur)) / span

    def state_str(self, format_string: str) -> str:
        """Render the status into ``format_string`` ({spinner}, {iter}, {err})."""
        pulse = self._PULSE[self.iter_cur % len(self._PULSE)]
        digits = len(str(self.iter_max))
        iter_part = (
            f"it {self.iter_cur:>{digits}}/{self.iter_max} "
            f"[{_bar(self.iter_cur / self.iter_max, self.iter_width)}]"
        )
        frac = self.converged_fraction
        err_part = (
            f"res {self.err_cur:9.3e} -> {self.err_tol:.0e} "
            + _tint(f"[{_bar(frac, self.err_width)}] {100 * frac:5.1f}%", frac)
        )
        return format_string.format(pulse, iter_part, err_part)


@dataclass(frozen=True)
class HistogramFormat:
    """Text histogram: vertical bars with a count axis and edge labels.

    ``rows`` is the bar height in character rows, ``cols`` the number of
    character columns spanned by the bins, ``tick_count`` how many bin-edge
    labels to print under the axis.
    """

    rows: int
    cols: int
    tick_count: int = 2
    label_format: Callable[[float], str] = str

    def format(self, a: npt.ArrayLike) -> str:
        values = np.asarray(a, dtype=float).ravel()
        counts, edges = np.histogram(values, bins=self.cols)
        peak = int(counts.max()) if counts.size else 0
        lines: list[str] = []
        margin = len(str(peak)) + 1
        for row in range(self.rows, 0, -1):
            # A column is drawn in this row if its count reaches the row's
            # share of the peak; the axis carries the peak count on top.
            threshold = peak * (row - 0.5) / self.rows
            cells = "".join("#" if c > threshold and c > 0 else " " for c in counts)
            axis_label = str(peak) if row == self.rows else ""
            lines.append(f"{axis_label:>{margin - 1}}|{cells}")
        lines.append(" " * (margin - 1) + "+" + "-" * self.cols)

        ticks = np.linspace(0, self.cols, self.tick_count, dtype=int)
        marker_row = bytearray(b" " * (margin + self.cols + 1))
        label_row = bytearray(b" " * (margin + self.cols + 32))
        for rank, t in enumerate(ticks):
            marker_row[margin + min(int(t), self.cols - 1)] = ord("^")
            text = self.label_format(float(edges[t]))
            anchor = margin + int(t)
            if rank == len(ticks) - 1:
                anchor -= len(text) - 1
            elif rank > 0:
                anchor -= len(text) // 2
            anchor = max(anchor, 0)
            label_row[anchor : anchor + len(text)] = text.encode()
        lines.append(marker_row.decode().rstrip())
        lines.append(label_row.decode().rstrip())
        return "\n".join(lines)

    def __call__(self, a: npt.ArrayLike) -> str:
        return self.format(a)
