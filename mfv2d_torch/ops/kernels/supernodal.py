"""The triangular sweeps of a frozen SciPy SuperLU factorization, on the card.

SciPy's ``splu`` gives ``Pr A Pc = L U`` (``L`` with a unit diagonal), so
``A x = b`` is ``z = Pr b``, ``L y = z``, ``U w = y``, ``x = Pc w``.
:func:`build_schedule` lays ``L`` and ``U`` out once per factorization for
a solve by dependency levels of supernodes, and :class:`CardSolve` runs
that schedule with the hand-written kernel ``csrc/sn_trsv.cu`` (built at
first use, see :mod:`mfv2d_torch.ops.kernels._build`), one launch a level,
the permutations and both sweeps captured once in a CUDA graph and replayed
each solve.  :func:`solve_plain` is its plain version: the same
schedule with torch operations, on any device.

The schedule:

- **Blocks.**  Supernodes of ``L``: a column joins the block of the column
  before it when its row pattern is that column's pattern less its own
  row.  A block is a run of rows ``[c0, c0 + w)``, at most ``MAX_WIDTH``
  rows.  Its diagonal block's triangles, ``L``'s strict lower one and
  ``U``'s upper one with the diagonal, are each stored dense, packed by
  columns (``Sweep.tri``), and staged whole in shared memory to be solved.
- **L's rows** outside their diagonal block are kept as CSR (their columns
  all lie left of the block), since the rows of one supernode of ``L``
  share no pattern; **U's rows** as a dense row block a block, ``w`` rows
  by the ``nk`` columns right of the block that any of its rows touches
  (``u_val``, row-major, the columns in ``u_kidx``).
- **Levels.**  A block reads the solution of the blocks its off-diagonal
  entries name; its level exceeds theirs by at least one (``L``: blocks to
  its left, ``U``: to its right).  The blocks of a level are independent.
- **Tasks.**  A block's off-diagonal row products are cut into tasks of
  whole rows, each row starting within ``TASK_VALUES`` values of its task's
  first row, one CTA a task; the last task of a block to finish solves its
  diagonal triangle.  Each row's sum is taken in a fixed order, so a solve
  is bitwise repeatable.  A small block (at most ``SMALL_WIDTH`` rows and
  ``SMALL_VALUES`` products) is one task of one warp, eight to a CTA.  A
  level is one launch: a CTA a large task, then the small ones.

``launches`` counts the kernel launches made through this module, one a
level of each sweep, a replayed graph's included.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from mfv2d_torch.ops.kernels import _build
from mfv2d_torch.transfer import to_device, to_host

launches = 0

# Rows a block holds: a CTA keeps the block's right side, its rows' starts,
# a chunk of products and its packed upper triangle in shared memory, w + (w
# + 2) / 2 + CHUNK + w (w + 1) / 2 values of 8 bytes, within the 227 KB a
# CTA may take on the H100.
MAX_WIDTH = 224
# Values of off-diagonal row products a task reads before its last row.
TASK_VALUES = 2048
# Products a CTA holds in shared memory at once: the kernel's ``kChunk``,
# which :class:`CardSolve` checks against this.
CHUNK = 2048
# A block of at most SMALL_WIDTH rows and SMALL_VALUES products, in one task,
# is a small task, one warp's; every other task takes a CTA of THREADS.
SMALL_WIDTH = 32
SMALL_VALUES = 512
THREADS = 256
WARPS = THREADS // 32
# A task's record, all a CTA reads to start: its block, rows, the block's
# first row, rows and tasks, U's columns a row, the offset of the task's
# first product value (L's rows are CSR over the row order, U's row blocks
# follow each other, so both are the sum of the row lengths before it), its
# products, the block's triangle and (U) its columns' offset in u_kidx;
# twelve fields, so that each record starts 16 bytes after the last.
TASK_FIELDS = ("block", "row0", "row1", "c0", "w", "ntask", "nk", "first", "values",
               "tri_off", "koff", "unused")


@dataclass
class Sweep:
    """One triangular sweep: its tasks, ``[T, 12]`` int64 records (see
    :data:`TASK_FIELDS`; rows relative to the block), sorted by level and,
    within a level, large tasks first; ``ntask`` the tasks of each block,
    ``level`` each block's level;
    each block's triangle packed by columns in ``tri`` from ``tri_off``
    (L: rows below the diagonal, U: rows to the diagonal); ``launches`` the
    kernel launches, one a level, each ``(first task, large tasks, small
    tasks, shared memory bytes, a warp's share of them for a small task in
    8-byte words)``."""

    tasks: torch.Tensor
    ntask: torch.Tensor
    level: torch.Tensor
    tri_off: torch.Tensor
    tri: torch.Tensor
    launches: list[tuple[int, int, int, int, int]]


@dataclass
class Schedule:
    """A factorization laid out for the level-scheduled sweeps (see the
    module's docstring); every tensor on one device."""

    n: int
    perm_in: torch.Tensor  # z = b[perm_in]
    perm_out: torch.Tensor  # x = w[perm_out]
    c0: torch.Tensor  # int32 [nb]: first row of each block
    w: torch.Tensor  # int32 [nb]: rows of each block
    l_rowptr: torch.Tensor  # int64 [n + 1]: L's rows left of their block
    l_col: torch.Tensor  # int32
    l_val: torch.Tensor  # f64
    u_off: torch.Tensor  # int64 [nb]: each block's dense row block in bval
    u_nk: torch.Tensor  # int32 [nb]: its columns
    u_koff: torch.Tensor  # int64 [nb]: its columns' offset in kidx
    u_kidx: torch.Tensor  # int32
    u_val: torch.Tensor  # f64: w x nk row-major row blocks of U
    lower: Sweep
    upper: Sweep

    @property
    def n_blocks(self) -> int:
        return int(self.c0.numel())


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(x.numel() + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def _csc(matrix, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each entry's row and column (int32) and value, uploaded."""
    n = matrix.shape[1]
    counts = to_device(np.diff(matrix.indptr), device)
    col = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=device), counts)
    return to_device(matrix.indices, device).int(), col, to_device(matrix.data, device)


def _supernode_starts(row: torch.Tensor, col: torch.Tensor, n: int) -> torch.Tensor:
    """Where the supernodes of ``L`` start, from the CSC entries' rows and
    columns (column-sorted, each column's unit diagonal first): column j
    joins column j-1 when its rows, in order, are column j-1's after its
    first."""
    if n < 2:
        return torch.ones(n, dtype=torch.bool, device=row.device)
    counts = torch.bincount(col, minlength=n)
    joins = torch.zeros(n, dtype=torch.bool, device=row.device)
    joins[1:] = counts[1:] == counts[:-1] - 1
    # Entry q of a column j that may join sits counts[j-1] - 1 entries
    # after its match in column j-1.
    shift = (counts - 1).to(torch.int32)
    src = torch.arange(row.numel(), dtype=torch.int32, device=row.device)
    src -= shift[(col - 1).clamp_(min=0)]
    bad = (row != row[src.clamp_(min=0)]) & joins[col]
    del src
    joins[col[bad]] = False
    return ~joins


def _levels(src: torch.Tensor, dst: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The longest path to each block over the edges ``src -> dst``
    (``dst`` reads ``src``), by relaxation: one round a level."""
    level = torch.zeros(n_blocks, dtype=torch.int64, device=src.device)
    while True:
        new = level.scatter_reduce(0, dst, level[src] + 1, reduce="amax")
        if torch.equal(new, level):
            return level
        level = new


def _triangle(row, col, val, blk, c0, w, upper: bool):
    """The diagonal blocks' triangles packed by columns: each block's
    offset and the values (L's strict lower triangle, or U's upper one
    with the diagonal)."""
    size = w * (w + 1) // 2 if upper else w * (w - 1) // 2
    off = _exclusive_cumsum(size)
    b = blk[col]
    i, k = row - c0[b], col - c0[b]
    pos = k * (k + 1) // 2 + i if upper else k * (w[b] - 1) - k * (k - 1) // 2 + i - k - 1
    tri = torch.zeros(int(off[-1]), dtype=torch.float64, device=row.device)
    tri[off[b] + pos] = val
    return off[:-1].contiguous(), tri, size


def _sweep(level: torch.Tensor, blk_of_row: torch.Tensor, row_len: torch.Tensor,
           c0: torch.Tensor, w: torch.Tensor, triangle, columns=None) -> Sweep:
    """Cut each block's rows into tasks, a new task where a row starts
    past a multiple of ``TASK_VALUES`` values of the block's row products;
    sort the tasks by level and class and group them into launches;
    ``triangle`` is :func:`_triangle`'s, ``columns`` U's columns a row and
    their offset in kidx, a block each."""
    n = blk_of_row.numel()
    device = level.device
    before = _exclusive_cumsum(row_len)
    within = before[:-1] - before[c0][blk_of_row]
    chunk = torch.div(within, TASK_VALUES, rounding_mode="floor")
    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = (blk_of_row[1:] != blk_of_row[:-1]) | (chunk[1:] != chunk[:-1])
    begin = torch.nonzero(first).flatten()
    end = torch.cat([begin[1:], torch.tensor([n], device=device)])
    blk = blk_of_row[begin]
    values = before[end] - before[begin]
    width = w[blk]
    ntask = torch.bincount(blk, minlength=c0.numel())
    small = (width <= SMALL_WIDTH) & (values <= SMALL_VALUES) & (ntask[blk] == 1)
    tri_off, tri, size = triangle
    smem = 8 * (width + (width + 2) // 2 + values.clamp(max=CHUNK) + size[blk])
    zero = torch.zeros_like(blk)
    nk, koff = (zero, zero) if columns is None else (columns[0][blk], columns[1][blk])
    base = c0[blk]
    record = torch.stack(
        [blk, begin - base, end - base, base, width, ntask[blk], nk, before[begin], values,
         tri_off[blk], koff, zero], 1,
    )
    n_levels = int(level.max()) + 1
    group = 2 * level[blk] + small.long()
    order = torch.sort(group, stable=True).indices
    counts = torch.bincount(group, minlength=2 * n_levels).view(n_levels, 2).tolist()
    need = torch.zeros(2 * n_levels, dtype=torch.int64, device=device).scatter_reduce(
        0, group, smem, reduce="amax"
    ).view(n_levels, 2).tolist()
    launches, first_task = [], 0
    for (n_big, n_small), (big, warp) in zip(counts, need):
        launches.append((first_task, n_big, n_small, max(big, WARPS * warp), warp // 8))
        first_task += n_big + n_small
    return Sweep(record[order].contiguous(), ntask.to(torch.int32), level, tri_off, tri,
                 launches)


def build_schedule(lu, device) -> Schedule:
    """The level schedule of SciPy's SuperLU object ``lu`` on ``device``.

    The factors cross to the device once (through
    :func:`mfv2d_torch.transfer.to_device`, so the tracer counts them) and
    are laid out there, each entry's row and column as int32, each
    factor's copies freed before the next step."""
    device = torch.device(device)
    lmat, umat = lu.L, lu.U
    n = lmat.shape[0]
    l_row, l_col, l_val = _csc(lmat, device)
    del lmat

    starts = _supernode_starts(l_row, l_col, n)
    group = torch.cumsum(starts, 0) - 1
    offset = torch.arange(n, device=device) - torch.nonzero(starts).flatten()[group]
    starts |= offset % MAX_WIDTH == 0
    blk = (torch.cumsum(starts, 0) - 1).to(torch.int32)
    c0 = torch.nonzero(starts).flatten()
    nb = c0.numel()
    w = torch.diff(c0, append=torch.tensor([n], device=device))

    # L's rows left of their block, as CSR with ascending columns: the
    # entries are in column order, so a stable sort by row keeps it.
    l_off = blk[l_row] != blk[l_col]
    keep = ~l_off & (l_row != l_col)
    l_tri = _triangle(l_row[keep], l_col[keep], l_val[keep], blk, c0, w, upper=False)
    del keep
    r, lc, lv = l_row[l_off], l_col[l_off], l_val[l_off]
    del l_row, l_col, l_val, l_off
    order = torch.sort(r, stable=True).indices
    r, lc, lv = r[order], lc[order], lv[order]
    del order
    l_len = torch.bincount(r, minlength=n)
    l_rowptr = _exclusive_cumsum(l_len)
    l_edges = torch.unique(blk[lc].long() * nb + blk[r])
    del r
    lower = _sweep(_levels(l_edges // nb, l_edges % nb, nb), blk, l_len, c0, w, l_tri)
    del l_edges

    # U's rows right of their block, as a dense row block a block.
    u_row, u_col, u_val = _csc(umat, device)
    del umat
    u_off_blk = blk[u_row] != blk[u_col]
    u_tri = _triangle(
        u_row[~u_off_blk], u_col[~u_off_blk], u_val[~u_off_blk], blk, c0, w, upper=True
    )
    r, c, uv = u_row[u_off_blk], u_col[u_off_blk], u_val[u_off_blk]
    del u_row, u_col, u_val, u_off_blk
    b = blk[r].long()
    keys, inverse = torch.unique(b * n + c, return_inverse=True)
    del c
    k_blk = keys // n
    kidx = (keys % n).to(torch.int32)
    del keys
    nk = torch.bincount(k_blk, minlength=nb)
    u_koff = _exclusive_cumsum(nk)
    u_off = _exclusive_cumsum(w * nk)
    bval = torch.zeros(int(u_off[-1]), dtype=torch.float64, device=device)
    inverse += u_off[b] + (r - c0[b]) * nk[b] - u_koff[b]
    bval[inverse] = uv
    del r, uv, inverse, b
    u_edges = torch.unique(blk[kidx].long() * nb + k_blk)
    del k_blk
    upper = _sweep(
        _levels(u_edges // nb, u_edges % nb, nb), blk, nk[blk], c0, w, u_tri, (nk, u_koff[:-1])
    )

    perm_r = to_device(lu.perm_r, device).long()
    perm_in = torch.empty_like(perm_r)
    perm_in[perm_r] = torch.arange(n, device=device)
    return Schedule(
        n=n,
        perm_in=perm_in,
        perm_out=to_device(lu.perm_c, device).long(),
        c0=c0.to(torch.int32),
        w=w.to(torch.int32),
        l_rowptr=l_rowptr,
        l_col=lc,
        l_val=lv,
        u_off=u_off[:-1].contiguous(),
        u_nk=nk.to(torch.int32),
        u_koff=u_koff[:-1].contiguous(),
        u_kidx=kidx,
        u_val=bval,
        lower=lower,
        upper=upper,
    )


def _level_blocks(sweep: Sweep) -> list[list[int]]:
    """The blocks of each level (launch), in the order of their tasks."""
    tasks = sweep.tasks[:, 0].tolist()
    return [
        list(dict.fromkeys(tasks[t0 : t0 + n_big + n_small]))
        for t0, n_big, n_small, _, _ in sweep.launches
    ]


def _unpacked(sweep: Sweep, k: int, m: int, upper: bool) -> torch.Tensor:
    """Block ``k``'s triangle of the sweep as an ``m x m`` matrix (L's with
    a unit diagonal)."""
    rows, cols = (torch.triu_indices if upper else torch.tril_indices)(
        m, m, 0 if upper else -1, device=sweep.tri.device
    )
    order = torch.argsort(cols * m + rows)
    start = int(sweep.tri_off[k])
    out = torch.eye(m, dtype=torch.float64, device=sweep.tri.device)
    out[rows[order], cols[order]] = sweep.tri[start : start + rows.numel()]
    return out


def solve_plain(s: Schedule, b: torch.Tensor) -> torch.Tensor:
    """``A^{-1} b`` by the schedule, with torch operations on the
    schedule's device: what the kernel computes, level by level, each
    block's off-diagonal row products and then its diagonal triangle."""
    z = b.to(torch.float64)[s.perm_in]
    c0, w = s.c0.tolist(), s.w.tolist()
    rowptr = s.l_rowptr.tolist()
    u_off, u_nk, u_koff = s.u_off.tolist(), s.u_nk.tolist(), s.u_koff.tolist()
    for sweep, upper in ((s.lower, False), (s.upper, True)):
        for blocks in _level_blocks(sweep):
            rights = []
            for k in blocks:
                a, m = c0[k], w[k]
                if upper:
                    block = s.u_val[u_off[k] : u_off[k] + m * u_nk[k]].view(m, u_nk[k])
                    cols = s.u_kidx[u_koff[k] : u_koff[k] + u_nk[k]].long()
                    product = block @ z[cols]
                else:
                    p0, p1 = rowptr[a], rowptr[a + m]
                    rows = torch.repeat_interleave(
                        torch.arange(m, device=z.device),
                        s.l_rowptr[a + 1 : a + m + 1] - s.l_rowptr[a : a + m],
                    )
                    product = torch.zeros(m, dtype=torch.float64, device=z.device).index_add_(
                        0, rows, s.l_val[p0:p1] * z[s.l_col[p0:p1].long()]
                    )
                rights.append(z[a : a + m] - product)
            for k, right in zip(blocks, rights):
                a, m = c0[k], w[k]
                z[a : a + m] = torch.linalg.solve_triangular(
                    _unpacked(sweep, k, m, upper), right[:, None], upper=upper,
                    unitriangular=not upper,
                )[:, 0]
    return z[s.perm_out]


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = _build.load("sn_trsv")
    lib.mfv2d_sn_trsv_f64.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
    )
    lib.mfv2d_sn_trsv_f64.restype = ctypes.c_int
    lib.mfv2d_sn_trsv_chunk.argtypes = []
    lib.mfv2d_sn_trsv_chunk.restype = ctypes.c_int
    lib.mfv2d_sn_trsv_reserve.argtypes = [ctypes.c_int]
    lib.mfv2d_sn_trsv_reserve.restype = ctypes.c_int
    return lib


class CardSolve:
    """``A^{-1} b`` by a :class:`Schedule` on its CUDA device.

    The right side's permutation, the kernel launches of both sweeps and
    the solution's permutation are captured once in a CUDA graph, after
    one solve outside it (which loads the kernel); each :meth:`solve`
    uploads the right side into the graph's input, replays the graph and
    brings the solution back."""

    def __init__(self, schedule: Schedule) -> None:
        self.schedule = schedule
        self.device = schedule.perm_in.device
        if self.device.type != "cuda":
            raise ValueError(f"CardSolve runs on a CUDA device, not {self.device}.")
        if library().mfv2d_sn_trsv_chunk() != CHUNK:
            raise ValueError(
                f"sn_trsv holds {library().mfv2d_sn_trsv_chunk()} products a CTA, the"
                f" schedule's shared memory counts {CHUNK}."
            )
        sweeps = (schedule.lower, schedule.upper)
        smem = max((launch[3] for sweep in sweeps for launch in sweep.launches), default=0)
        with torch.cuda.device(self.device):
            rc = library().mfv2d_sn_trsv_reserve(smem)
        if rc != 0:
            raise RuntimeError(
                f"sn_trsv: {smem} bytes of shared memory refused (CUDA error {rc})."
            )
        self._host = [
            (ctypes.c_longlong * (5 * len(sw.launches)))(*(v for lc in sw.launches for v in lc))
            for sw in sweeps
        ]
        self._counters = torch.zeros(
            max(schedule.n_blocks, 1), dtype=torch.int32, device=self.device
        )
        self._b = torch.zeros(schedule.n, dtype=torch.float64, device=self.device)
        self._x = self._run()
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._x = self._run()

    @property
    def level_launches(self) -> int:
        """Kernel launches of one solve, over both sweeps."""
        return sum(len(sw.launches) for sw in (self.schedule.lower, self.schedule.upper))

    def _sweep(self, upper: bool, z: torch.Tensor) -> None:
        """Every launch of a sweep on ``z`` (the permuted right side,
        solved in place) on the current stream."""
        global launches
        s = self.schedule
        sweep = s.upper if upper else s.lower
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = library().mfv2d_sn_trsv_f64(
                z.data_ptr(), sweep.tasks.data_ptr(), ctypes.addressof(self._host[int(upper)]),
                len(sweep.launches), int(upper), sweep.tri.data_ptr(),
                s.l_rowptr.data_ptr(), s.l_col.data_ptr(), s.l_val.data_ptr(),
                s.u_kidx.data_ptr(), s.u_val.data_ptr(), self._counters.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"sn_trsv kernel launch failed with CUDA error {rc}.")
        if not torch.cuda.is_current_stream_capturing():
            launches += len(sweep.launches)

    def _run(self) -> torch.Tensor:
        z = self._b[self.schedule.perm_in]
        self._sweep(False, z)
        self._sweep(True, z)
        return z[self.schedule.perm_out]

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """The solution of ``A x = rhs`` for one float64 right side."""
        global launches
        self._b.copy_(to_device(rhs, self.device, torch.float64))
        self._graph.replay()
        launches += self.level_launches
        return to_host(self._x)
