"""One solve under ``torch.profiler``, read back from its trace.

The device's busy time is the union of the intervals in which a kernel, a
copy or a memset ran, so work that overlaps counts once.  The host's
stages (the program's tracer spans) are recorded on the host's clock and
placed on the trace's by the annotation around the solve, so that each
idle gap of the device is labelled with the stage the host was in.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "bench.solve"


@dataclass
class Profile:
    """What one profiled solve did on the device (seconds)."""

    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)  # (category, name, start, duration)
    gaps: list = field(default_factory=list)  # (stage, seconds), longest first

    def kernel_seconds(self, part: str) -> float:
        return sum(d for c, n, _, d in self.ops if c == "kernel" and part in n)

    def kernel_count(self, part: str) -> int:
        return sum(1 for c, n, _, _ in self.ops if c == "kernel" and part in n)

    def copy_seconds(self) -> float:
        return sum(
            d for c, n, _, d in self.ops if c == "gpu_memcpy" and ("HtoD" in n or "DtoH" in n)
        )

    def top_ops(self, count: int = 10) -> list:
        by_name = defaultdict(float)
        for _, name, _, duration in self.ops:
            by_name[name[:120]] += duration
        return sorted(([n, s] for n, s in by_name.items()), key=lambda e: -e[1])[:count]


@contextmanager
def host_stages(tracer, spans: list):
    """Record ``(name, start, end)`` on the host's clock for every stage the
    program's tracer opens or adds while the block runs."""
    stage, add = tracer.stage, tracer.add

    @contextmanager
    def timed_stage(name):
        t0 = time.perf_counter()
        try:
            with stage(name):
                yield
        finally:
            spans.append((name, t0, time.perf_counter()))

    def timed_add(name, seconds):
        now = time.perf_counter()
        spans.append((name, now - seconds, now))
        add(name, seconds)

    tracer.stage, tracer.add = timed_stage, timed_add
    try:
        yield
    finally:
        del tracer.stage, tracer.add


def profile_call(fn, sync, tracer, with_device: bool):
    """Run ``fn`` (then ``sync``) under the profiler; return its result and
    the Profile of the call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if with_device:
        activities.append(ProfilerActivity.CUDA)
    spans: list = []
    was_enabled = tracer.enabled
    tracer.enable()
    try:
        with profile(activities=activities) as prof, host_stages(tracer, spans):
            t0 = time.perf_counter()
            with record_function(ANNOTATION):
                result = fn()
                sync()
            t1 = time.perf_counter()
    finally:
        if not was_enabled:
            tracer.disable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return result, parse(events, t0, t1, spans)


def _merged(intervals: list) -> list:
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def parse(events: list, t0: float, t1: float, spans: list) -> Profile:
    """The Profile of the annotated solve in a chrome trace's events.

    ``t0`` and ``t1`` bound the solve on the host's clock; ``spans`` are the
    host stages on that clock."""
    marks = [e for e in events if e.get("name") == ANNOTATION and e.get("ph") == "X"
             and e.get("cat") != "gpu_user_annotation"]
    if not marks:
        return Profile(window_s=t1 - t0, busy_s=0.0)
    start = float(marks[0]["ts"]) * 1e-6
    end = start + (t1 - t0)
    offset = start - t0
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = float(e["ts"]) * 1e-6
        d = float(e.get("dur", 0.0)) * 1e-6
        if s + d < start or s > end:
            continue
        ops.append((e["cat"], e["name"], s, d))
    busy = _merged([(max(s, start), min(s + d, end)) for _, _, s, d in ops])
    busy_s = sum(b - a for a, b in busy)
    host = sorted(((n, a + offset, b + offset) for n, a, b in spans), key=lambda h: h[2] - h[1])
    edges = [start, *(x for pair in busy for x in pair), end]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((n for n, ha, hb in host if ha <= mid <= hb), "outside the stages")
        gaps.append((label, b - a))
    gaps.sort(key=lambda g: -g[1])
    return Profile(window_s=end - start, busy_s=busy_s, ops=ops, gaps=gaps)
