"""The frozen saddle factorization's triangular sweeps by supernodal levels
(``mfv2d_torch.ops.kernels.supernodal``) against SciPy's own solve.

The factorizations are those ``solve_system_2d`` makes at test size for
mixed Poisson, the mixed heat march and Navier-Stokes (whose frozen
operator is not symmetric).  On the CPU: the schedule's plain version
reproduces ``splu(A).solve(b)``, every block's level exceeds those of the
blocks it reads, its tasks cover its rows once, ``FrozenSaddleSolver``
on the CPU never builds the schedule and answers as SciPy does, and on a
CUDA device it moves to the card at its second solve only after a first
solve of at least ``CARD_MIN_HOST_SOLVE_S``.  The
``cuda``-marked tests hold the kernel (``csrc/sn_trsv.cu``) against the
plain version on the card, and the solver's and a march's use of it.  The
file imports no JAX, so it runs on the card alone:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_supernodal.py``.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import mfv2d_torch as mf
from mfv2d_torch.models import flow, poisson, transport
from mfv2d_torch.ops.kernels import supernodal
from mfv2d_torch.solver import solve as solve_module
from mfv2d_torch.solver.solve import FrozenSaddleSolver
from mfv2d_torch.tracing import tracer

torch.set_num_threads(1)
# The module, which the package's function of the same name hides.
tsys = importlib.import_module("mfv2d_torch.solve_system_2d")


def _curved(amplitude):
    def deformation(x, y):
        s = amplitude * np.sin(np.pi * x) * np.sin(np.pi * y)
        return x + s, y - s

    return deformation


def _steady(x, y):
    return np.cos(np.pi * x / 2) * np.cos(np.pi * y / 2)


def _heat_march(n, p, nt, device):
    model = transport.heat_mixed(0.02, 1.0, _steady)
    mesh = mf.examples.unit_square_mesh(n, n, p, deformation=_curved(0.06))
    return mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-10, 0.0)),
        time_settings=mf.TimeSettings(
            dt=2.0 / nt, nt=nt, time_march_relations=model.time_march_relations
        ),
        recon_order=p,
        device=device,
    )


def _poisson():
    model = poisson.mixed_poisson()
    mesh = mf.examples.unit_square_mesh(12, 12, 4, deformation=_curved(0.05))
    mf.solve_system_2d(mesh, mf.SystemSettings(model.system), recon_order=2, device="cpu")


def _heat():
    _heat_march(6, 4, 2, "cpu")


def _navier_stokes():
    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(5, 5, 5, deformation=_curved(0.07))
    bc = mf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, flow.ns_velocity_exact)
    mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(mf.ConvergenceSettings(2, 1e-8, 0.0), relaxation=0.7),
        recon_order=2,
        device="cpu",
    )


CASES = {"poisson": _poisson, "heat": _heat, "navier_stokes": _navier_stokes}


@functools.cache
def saddle(case: str) -> tuple:
    """The element matrices and constraint matrix of the first frozen
    saddle system that ``solve_system_2d`` factors in the case."""
    made = []

    class Recording(FrozenSaddleSolver):
        def __init__(self, matrices, lagrange_mat, device=None):
            super().__init__(matrices, lagrange_mat, device)
            made.append((matrices, lagrange_mat))

    original = tsys.FrozenSaddleSolver
    tsys.FrozenSaddleSolver = Recording
    try:
        CASES[case]()
    finally:
        tsys.FrozenSaddleSolver = original
    return made[0]


@functools.cache
def factorization(case: str):
    """SciPy's SuperLU object of the case's saddle matrix."""
    return FrozenSaddleSolver(*saddle(case))._decomp


# A task budget small enough to cut many blocks of both sweeps into tasks,
# and a block width that splits every supernode wider than it.
SMALL_TASKS = 64
NARROW = 12


@functools.cache
def schedule(case: str, task_values: int = supernodal.TASK_VALUES,
             device: str = "cpu", max_width: int = supernodal.MAX_WIDTH) -> supernodal.Schedule:
    """The case's schedule, its tasks cut at ``task_values`` values and its
    blocks at ``max_width`` rows."""
    saved = supernodal.TASK_VALUES, supernodal.MAX_WIDTH
    supernodal.TASK_VALUES, supernodal.MAX_WIDTH = task_values, max_width
    try:
        return supernodal.build_schedule(factorization(case), device)
    finally:
        supernodal.TASK_VALUES, supernodal.MAX_WIDTH = saved


def right_sides(n: int, count: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(n)
    return [rng.normal(size=n) * 10.0 ** rng.integers(-3, 4) for _ in range(count)]


def rel(mine: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("max_width", [supernodal.MAX_WIDTH, NARROW])
@pytest.mark.parametrize("case", CASES)
def test_plain_sweeps_reproduce_superlu(case, max_width):
    lu, s = factorization(case), schedule(case, max_width=max_width)
    assert int(s.w.max()) <= max_width
    for b in right_sides(s.n):
        x = supernodal.solve_plain(s, torch.from_numpy(b)).numpy()
        assert rel(x, lu.solve(b)) <= 1e-12


@pytest.mark.parametrize("max_width", [supernodal.MAX_WIDTH, NARROW])
@pytest.mark.parametrize("case", CASES)
def test_levels_exceed_those_of_the_blocks_read(case, max_width):
    s = schedule(case, max_width=max_width)
    blk = torch.repeat_interleave(torch.arange(s.n_blocks), s.w.long())
    rows = torch.repeat_interleave(torch.arange(s.n), torch.diff(s.l_rowptr))
    level = s.lower.level
    assert bool((level[blk[rows]] > level[blk[s.l_col.long()]]).all())
    # L's rows outside their block read only columns left of it.
    assert bool((s.l_col.long() < s.c0.long()[blk[rows]]).all())
    readers = torch.repeat_interleave(torch.arange(s.n_blocks), s.u_nk.long())
    level = s.upper.level
    assert bool((level[readers] > level[blk[s.u_kidx.long()]]).all())
    assert bool((s.u_kidx.long() >= (s.c0 + s.w).long()[readers]).all())


@pytest.mark.parametrize("task_values", [supernodal.TASK_VALUES, SMALL_TASKS])
@pytest.mark.parametrize("case", CASES)
def test_tasks_cover_each_block_once_by_level(case, task_values):
    s = schedule(case, task_values)
    row_len = {
        "lower": torch.diff(s.l_rowptr),
        "upper": s.u_nk.long()[torch.repeat_interleave(torch.arange(s.n_blocks), s.w.long())],
    }
    for name, sweep in (("lower", s.lower), ("upper", s.upper)):
        tasks = sweep.tasks.long()
        blk, row0, row1 = tasks[:, :3].unbind(1)
        # every row of every block in exactly one task
        covered = torch.zeros(s.n, dtype=torch.int64)
        first = s.c0.long()[blk]
        for a, b in zip((first + row0).tolist(), (first + row1).tolist()):
            covered[a:b] += 1
        assert bool((covered == 1).all()), name
        assert torch.equal(torch.bincount(blk, minlength=s.n_blocks), sweep.ntask.long())
        # tasks sorted by level, each level's tasks one launch
        levels = sweep.level[blk]
        assert bool((torch.diff(levels) >= 0).all())
        per_level = torch.tensor([n_big + n_small for _, n_big, n_small, _, _ in sweep.launches])
        assert torch.equal(torch.bincount(levels), per_level)
        # a task's rows start within task_values values of its first row's start
        starts = torch.tensor([
            int(row_len[name][a : b - 1].sum())
            for a, b in zip((first + row0).tolist(), (first + row1).tolist())
        ])
        assert bool((starts < task_values).all()), name
        # launches: one a level, its large tasks (a CTA each) then its small
        # ones (a warp each, blocks of at most SMALL_WIDTH rows in one task),
        # with the shared memory the largest of each needs
        values = torch.tensor([
            int(row_len[name][a:b].sum())
            for a, b in zip((first + row0).tolist(), (first + row1).tolist())
        ])
        width = s.w.long()[blk]
        small = (
            (width <= supernodal.SMALL_WIDTH)
            & (values <= supernodal.SMALL_VALUES)
            & (sweep.ntask.long()[blk] == 1)
        )
        triangle = width * (width + 1) // 2 if name == "upper" else width * (width - 1) // 2
        need = 8 * (width + (width + 2) // 2 + values.clamp(max=supernodal.CHUNK) + triangle)
        offsets = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64), per_level]), 0)
        for (t0, n_big, n_small, smem, stride), a in zip(sweep.launches, offsets.tolist()):
            b = t0 + n_big + n_small
            assert t0 == a
            assert not bool(small[t0 : t0 + n_big].any())
            assert bool(small[t0 + n_big : b].all())
            big = int(need[t0 : t0 + n_big].max()) if n_big else 0
            warp = int(need[t0 + n_big : b].max()) if n_small else 0
            assert stride == warp // 8
            assert smem == max(big, supernodal.WARPS * warp) <= 232448 - 16
        # each record holds what its CTA reads: its block's rows, tasks,
        # first product value, products and triangle
        record = dict(zip(supernodal.TASK_FIELDS, sweep.tasks.unbind(1)))
        assert torch.equal(record["c0"], s.c0.long()[blk])
        assert torch.equal(record["w"], width)
        assert torch.equal(record["ntask"], sweep.ntask.long()[blk])
        assert torch.equal(record["tri_off"], sweep.tri_off[blk])
        assert torch.equal(record["values"], values)
        before = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(row_len[name], 0)])
        assert torch.equal(record["first"], before[first + row0])
        if name == "lower":
            assert torch.equal(record["first"], s.l_rowptr[first + row0])
        else:
            assert torch.equal(record["first"], s.u_off[blk] + row0 * s.u_nk.long()[blk])
            assert torch.equal(record["koff"], s.u_koff[blk])


@pytest.mark.parametrize("case", CASES)
def test_cases_reach_past_one_panel_and_one_task(case):
    """Every case holds a block wider than the kernel's 32-column panel; at
    the small budget both sweeps cut blocks into several tasks (CTAs)."""
    assert int(schedule(case).w.max()) > 32
    small = schedule(case, SMALL_TASKS)
    assert int(small.lower.ntask.max()) > 1
    assert int(small.upper.ntask.max()) > 1


def test_supernodes_share_the_pattern_of_their_first_column():
    """Each block of several rows is a supernode of L: its columns' rows,
    in order, are the first column's after as many leading rows."""
    lu = factorization("poisson")
    lmat = lu.L
    s = schedule("poisson")
    starts = s.c0.tolist()
    widths = s.w.tolist()
    for c0, w in zip(starts, widths):
        head = lmat.indices[lmat.indptr[c0] : lmat.indptr[c0 + 1]]
        for j in range(1, w):
            column = lmat.indices[lmat.indptr[c0 + j] : lmat.indptr[c0 + j + 1]]
            assert np.array_equal(column, head[j:])


def test_frozen_solver_on_the_cpu_is_superlu(monkeypatch):
    """``device="cpu"``: the schedule is never built, and every solve is
    SciPy's, bitwise, counted as a host solve."""
    lu = factorization("heat")

    def refuse(*args, **kwargs):
        raise AssertionError("the schedule was built for a CPU solver")

    monkeypatch.setattr(supernodal, "build_schedule", refuse)
    solver = FrozenSaddleSolver(*saddle("heat"), device="cpu")
    tracer.reset()
    tracer.enable()
    try:
        for b in right_sides(lu.shape[0], 4):
            assert np.array_equal(solver.solve(b), lu.solve(b))
    finally:
        tracer.disable()
    assert tracer.total("frozen_solve_host") == 4
    assert tracer.total("frozen_solve_card") == 0
    tracer.reset()


class _FakeCard:
    """Stands in for :class:`supernodal.CardSolve` on the CPU: SciPy's
    solve of the factorization the schedule stub names."""

    def __init__(self, lu):
        self.lu = lu

    def solve(self, rhs):
        return self.lu.solve(rhs)


@pytest.mark.parametrize("floor, card_solves", [(0.0, 3), (3600.0, 0)])
def test_frozen_solver_moves_to_the_card_after_a_slow_first_solve(monkeypatch, floor, card_solves):
    """On a CUDA device the schedule is built at the second solve, once,
    when the first (host) solve took at least ``CARD_MIN_HOST_SOLVE_S``;
    after a quicker first solve every solve stays SciPy's and nothing is
    built.  The card is stood in for, so this runs on the CPU."""
    lu = factorization("heat")
    built = []
    monkeypatch.setattr(solve_module, "CARD_MIN_HOST_SOLVE_S", floor)

    def build(decomp, device):
        built.append(device)
        return decomp

    monkeypatch.setattr(supernodal, "build_schedule", build)
    monkeypatch.setattr(supernodal, "CardSolve", _FakeCard)
    solver = FrozenSaddleSolver(*saddle("heat"), device="cuda")
    tracer.reset()
    tracer.enable()
    try:
        for b in right_sides(lu.shape[0], 4):
            assert np.array_equal(solver.solve(b), lu.solve(b))
    finally:
        tracer.disable()
    assert built == ([torch.device("cuda")] if card_solves else [])
    assert tracer.total("frozen_solve_host") == 4 - card_solves
    assert tracer.total("frozen_solve_card") == card_solves
    assert ("frozen-solve-prepare" in tracer.stages) == bool(card_solves)
    tracer.reset()


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "task_values, max_width",
    [(supernodal.TASK_VALUES, supernodal.MAX_WIDTH), (SMALL_TASKS, supernodal.MAX_WIDTH),
     (SMALL_TASKS, NARROW)],
)
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case, task_values, max_width):
    _needs_card()
    lu = factorization(case)
    s = schedule(case, task_values, "cuda", max_width)
    plain = schedule(case, task_values, max_width=max_width)
    card = supernodal.CardSolve(s)
    for b in right_sides(s.n):
        before = supernodal.launches
        x = card.solve(b)
        levels = int(s.lower.level.max()) + int(s.upper.level.max()) + 2
        assert supernodal.launches - before == card.level_launches == levels
        assert rel(x, supernodal.solve_plain(plain, torch.from_numpy(b)).numpy()) <= 1e-12
        assert rel(x, lu.solve(b)) <= 1e-12
        assert np.array_equal(card.solve(b), x), "two solves of one right side differ"


@pytest.mark.cuda
def test_frozen_solver_moves_to_the_card_at_its_second_solve(monkeypatch):
    _needs_card()
    # A test-size factorization solves in well under the floor.
    monkeypatch.setattr(solve_module, "CARD_MIN_HOST_SOLVE_S", 0.0)
    lu = factorization("navier_stokes")
    solver = FrozenSaddleSolver(*saddle("navier_stokes"), device="cuda")
    tracer.reset()
    tracer.enable()
    try:
        answers = [solver.solve(b) for b in right_sides(lu.shape[0], 4)]
    finally:
        tracer.disable()
    assert tracer.total("frozen_solve_host") == 1
    assert tracer.total("frozen_solve_card") == 3
    assert tracer.stages["frozen-solve-prepare"][0] == 1
    tracer.reset()
    for b, x in zip(right_sides(lu.shape[0], 4), answers):
        assert rel(x, lu.solve(b)) <= 1e-12


@pytest.mark.cuda
def test_heat_march_keeps_its_picard_iterations_on_card(monkeypatch):
    _needs_card()
    monkeypatch.setattr(solve_module, "CARD_MIN_HOST_SOLVE_S", 0.0)
    tracer.reset()
    tracer.enable()
    try:
        grids, stats, _ = _heat_march(6, 4, 4, "cuda")
    finally:
        tracer.disable()
    solves = int(np.sum(stats.iter_history))
    assert tracer.total("frozen_solve_host") == 1
    assert tracer.total("frozen_solve_card") == solves - 1
    tracer.reset()
    ref_grids, ref_stats, _ = _heat_march(6, 4, 4, "cpu")
    assert np.array_equal(stats.iter_history, ref_stats.iter_history)
    u, ref = grids[-1].point_data["u"], ref_grids[-1].point_data["u"]
    assert rel(u, ref) <= 1e-10
