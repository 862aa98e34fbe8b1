"""The port's tracer: spans with ids and parents inside the two host
factorizations and the reconstruction, counters of host-device bytes and
solves, and the copy helpers that feed them (``mfv2d_torch.transfer``).

The solves run mixed Poisson at 4x4 p=2 on the CPU, where no byte crosses;
the card's test holds the counted bytes against ``torch.profiler``'s
memcpy events.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
from mfv2d_torch import transfer
from mfv2d_torch.models import poisson as tpoisson
from mfv2d_torch.tracing import tracer

torch.set_num_threads(1)

NEW_KEYS = {
    "direct": {"factorize", "factorize/saddle-matrix", "factorize/superlu", "reconstruct"},
    "schur_direct": {
        "factorize",
        "picard-solve/schur-factor",
        "picard-solve/schur-factor/condense",
        "picard-solve/schur-factor/superlu",
        "reconstruct",
    },
}


@pytest.fixture
def fresh_tracer():
    """The process's tracer, off and empty before and after the test."""
    tracer.disable()
    tracer.reset()
    yield tracer
    tracer.disable()
    tracer.reset()


def _solve(linear_solver: str, n: int = 4, p: int = 2, device: str = "cpu"):
    model = tpoisson.mixed_poisson()
    mesh = tf.examples.unit_square_mesh(n, n, p)
    return tf.solve_system_2d(
        mesh,
        tf.SystemSettings(model.system),
        tf.SolverSettings(linear_solver=linear_solver),
        recon_order=p,
        device=device,
    )


@pytest.mark.parametrize("linear_solver", sorted(NEW_KEYS))
def test_spans_nest_inside_their_solve(fresh_tracer, linear_solver):
    fresh_tracer.enable()
    _solve(linear_solver)
    _solve(linear_solver)
    fresh_tracer.disable()

    assert NEW_KEYS[linear_solver] <= set(fresh_tracer.stages)
    spans = fresh_tracer.spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    assert len({s.solve for s in spans}) == 2 and None not in {s.solve for s in spans}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.path == s.name
            continue
        parent = by_id[s.parent]
        assert parent.solve == s.solve
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        assert s.path == f"{parent.path}/{s.name}"
    for parent in spans:
        children = [s for s in spans if s.parent == parent.id]
        assert sum(c.end_ns - c.start_ns for c in children) <= parent.end_ns - parent.start_ns
    # The totals per path are the spans' sums.
    for path, (calls, seconds) in fresh_tracer.stages.items():
        mine = [s for s in spans if s.path == path]
        if mine:
            assert calls == len(mine)
            assert seconds == pytest.approx(sum(s.end_ns - s.start_ns for s in mine) * 1e-9)
    # No byte crosses on the CPU; the solves are counted.
    assert fresh_tracer.total("h2d_bytes") == 0 and fresh_tracer.total("d2h_bytes") == 0
    assert fresh_tracer.total("solves") == 2
    assert fresh_tracer.counters[""]["solves"] == 2


def test_children_of_the_factorizations(fresh_tracer):
    fresh_tracer.enable()
    _solve("direct")
    _solve("schur_direct")
    fresh_tracer.disable()
    stages = fresh_tracer.stages
    for parent, children in (
        ("factorize", ("saddle-matrix", "superlu")),
        ("picard-solve/schur-factor", ("condense", "superlu")),
    ):
        assert sum(stages[f"{parent}/{c}"][1] for c in children) <= stages[parent][1]


@pytest.mark.parametrize(
    "linear_solver, counts",
    [
        # The trace matrix of mixed Poisson is definite: one factorization,
        # by the minimum degree ordering, counted under its span.
        ("schur_direct", {"picard-solve/schur-factor/superlu": {"superlu_min_degree": 1}}),
        # The saddle matrix's factorization does not choose an ordering.
        ("direct", {}),
    ],
)
def test_superlu_orderings_are_counted(fresh_tracer, linear_solver, counts):
    fresh_tracer.enable()
    _solve(linear_solver)
    fresh_tracer.disable()
    names = ("superlu_min_degree", "superlu_colamd")
    seen = {
        path: {k: v for k, v in at.items() if k in names}
        for path, at in fresh_tracer.counters.items()
        if any(k in names for k in at)
    }
    assert seen == counts


def test_an_off_tracer_records_nothing(fresh_tracer):
    _solve("direct")
    with fresh_tracer.stage("outside"):
        fresh_tracer.count("h2d_bytes", 8)
    fresh_tracer.add("added", 1.0)
    assert fresh_tracer.stages == {}
    assert fresh_tracer.spans == []
    assert fresh_tracer.counters == {}
    assert fresh_tracer.report() == "(no stages traced)"


def test_reset_clears_spans_and_counters(fresh_tracer):
    fresh_tracer.enable()
    _solve("schur_direct")
    assert fresh_tracer.spans and fresh_tracer.counters and fresh_tracer.stages
    fresh_tracer.reset()
    assert fresh_tracer.spans == [] and fresh_tracer.counters == {}
    assert fresh_tracer.stages == {} and fresh_tracer.total("solves") == 0


def test_enabled_in_code_prints_no_report(fresh_tracer, capsys):
    fresh_tracer.enable()
    _solve("direct")
    assert capsys.readouterr().out == ""


def test_counters_sit_under_the_innermost_span(fresh_tracer):
    fresh_tracer.enable()
    with fresh_tracer.stage("outer"):
        fresh_tracer.count("h2d_bytes", 16)
        with fresh_tracer.stage("inner"):
            fresh_tracer.count("h2d_bytes", 8)
            fresh_tracer.count("h2d_bytes", 8)
    fresh_tracer.count("solves")
    assert fresh_tracer.counters == {
        "outer": {"h2d_bytes": 16},
        "outer/inner": {"h2d_bytes": 16},
        "": {"solves": 1},
    }
    assert fresh_tracer.total("h2d_bytes") == 32
    report = fresh_tracer.report().splitlines()
    inner = next(i for i, line in enumerate(report) if line.startswith("outer/inner "))
    assert report[inner + 1].split() == ["h2d_bytes", "16"]
    assert report[-2:] == ["(outside the stages)", report[-1]]
    assert report[-1].split() == ["solves", "1"]


class _CardTensor:
    """A stand-in for a tensor on a card: ``.cpu()`` gives the host copy."""

    def __init__(self, values: torch.Tensor) -> None:
        self.device = torch.device("cuda")
        self._values = values

    def cpu(self) -> torch.Tensor:
        return self._values


def test_helpers_count_only_across_device_types(fresh_tracer):
    fresh_tracer.enable()
    host = np.arange(12, dtype=np.float64).reshape(3, 4)
    # Host to host: no count, and as_tensor shares the array's memory.
    shared = transfer.to_device(host, "cpu")
    assert shared.data_ptr() == host.__array_interface__["data"][0]
    copied = transfer.to_device(host, "cpu", torch.float64, copy=True)
    assert copied.data_ptr() != shared.data_ptr()
    assert np.array_equal(transfer.to_host(copied), host)
    assert fresh_tracer.total("h2d_bytes") == 0 and fresh_tracer.total("d2h_bytes") == 0
    # Across device types: the target's bytes.  A meta tensor stands for a
    # card's here.
    on_meta = transfer.to_device(host, "meta", torch.float32)
    assert on_meta.device.type == "meta"
    assert fresh_tracer.total("h2d_bytes") == 12 * 4
    transfer.to_device(torch.zeros(5, dtype=torch.int64), "meta")
    assert fresh_tracer.total("h2d_bytes") == 12 * 4 + 5 * 8
    back = transfer.to_host(_CardTensor(torch.ones(7, dtype=torch.float64)))
    assert isinstance(back, np.ndarray) and back.shape == (7,)
    assert fresh_tracer.total("d2h_bytes") == 7 * 8
    # Off: nothing more is counted.
    fresh_tracer.disable()
    transfer.to_device(host, "meta")
    transfer.to_host(_CardTensor(torch.ones(7)))
    assert fresh_tracer.total("h2d_bytes") == 12 * 4 + 5 * 8
    assert fresh_tracer.total("d2h_bytes") == 7 * 8


def _copy_bytes_check():
    """``tools/copy_bytes_check.py``, imported by path: its chrome-trace
    readers serve the card's test."""
    spec = importlib.util.spec_from_file_location(
        "copy_bytes_check", Path(__file__).resolve().parents[1] / "tools" / "copy_bytes_check.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("linear_solver", ["direct", "schur_direct"])
def test_counted_bytes_match_the_profiler_on_card(fresh_tracer, linear_solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: on the CPU no byte crosses")
    tool = _copy_bytes_check()
    _solve(linear_solver, n=16, p=4, device="cuda")  # warm: plans and tables
    fresh_tracer.enable()
    seen = tool.memcpy_bytes(tool.trace_events(lambda: _solve(linear_solver, n=16, p=4, device="cuda")))
    fresh_tracer.disable()
    for key in ("h2d_bytes", "d2h_bytes"):
        assert fresh_tracer.total(key) > 0
        assert fresh_tracer.total(key) == pytest.approx(seen[key], rel=0.01), key
