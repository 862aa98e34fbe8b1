"""M1, the 1-form mass matrix, through the hand-written Hopper kernel.

``mass_edge(tb, jac)`` computes what :func:`mfv2d_torch.ops.mass.mass_edge`
computes (its plain PyTorch version) for a batch of ``E`` elements:
``[E, n1, n1]`` in the dtype of the Jacobian terms, float32 or float64.

- For tensors on the CPU it returns the plain version, at any order.
- For CUDA tensors it launches ``csrc/mass_edge.cu`` (built at first use,
  see :mod:`mfv2d_torch.ops.kernels._build`) on the current stream, or
  raises.  There is no fallback.

The kernel replaces the Pallas TPU kernel ``mass_edge_pallas``
(mfv2d_tpu/ops/pallas_mass.py); the source note in the ``.cu`` file says
what bounds it on the card.  Everything the kernel is told about shapes is
decided here, in :func:`launch_plan` and :func:`padded_table`, so that it
can be checked without a card: the route, the warp tile, the list of tiles
an element is cut into, the padded table layout, how many quadrature points
a ring stage holds, how many elements a block takes at a time, and the
shared memory all of that needs.  A batch too small to fill the card takes
the panel route, where a block owns one panel of warp tiles of one element
and streams only the table columns of its panel.  ``launches`` counts the
kernel launches made through this wrapper, so a run can show that its main
path used the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from mfv2d_torch.ops import mass as _plain
from mfv2d_torch.ops.geometry import JacobianTerms
from mfv2d_torch.ops.kernels import _build
from mfv2d_torch.ops.mass import TensorBasis

launches = 0

_ENTRY = {
    torch.float64: "mfv2d_mass_edge_f64",
    torch.float32: "mfv2d_mass_edge_f32",
}
# Dynamic shared memory a block may use on Hopper after opting in.
SMEM_LIMIT = 232448
# The tiling counts in blocks of 8 x 8 outputs; a warp tile is mr x nc blocks,
# mr even: an MMA (m16n8k4) covers two row blocks and one column block.
BLOCK = 8
WARP_TILES = ((4, 4), (4, 3))
# The table stays resident in shared memory up to this size; above it, it
# is streamed through a ring of RING_STAGES stages of at most RING_BYTES.
RESIDENT_BYTES = 176 * 1024
RING_STAGES = 3
RING_BYTES = 176 * 1024
CHUNKS = (32, 16, 8, 4)
GROUPS = (1, 2, 4, 8)
# Panels of the panel route, rows x columns in warp tiles (one warp each).
# In the sweep of tools/mass_edge_ablation.py (f64, p=4 to 16, E=1 to 512,
# an NVIDIA H100 80GB HBM3 at 700 W) panels of 3 x 3 and 1 x 1 tiles were
# at most 12% faster than the best of these two and the element route (at
# p=4, E=128, 0.01 ms), and up to 1.68x slower.
PANELS = ((4, 4), (2, 2))
ROUTES = ("element", "panel")
# Registers a thread may take under the kernels' launch bounds of 512
# threads (ptxas gives the f64 kernels 100 to 114).
THREAD_REGISTERS = 128
# Quadrants of M1 in the tile codes, rows x columns: hh and vv are computed
# on and above the block diagonal and hv once; the kernel stores the mirror
# images, so vh has no tiles.
HH, HV, VV = range(3)


class Card(NamedTuple):
    """What a launch plan needs to know of the card, as the CUDA runtime
    reports it (:func:`card`): its SMs and what one SM holds at once."""

    sms: int
    smem_per_sm: int  # bytes of shared memory of one SM
    smem_per_block_reserved: int  # bytes of it the runtime keeps for each block
    registers_per_sm: int


# An NVIDIA H100 80GB HBM3 as the runtime reports it: the card the tests plan for.
H100 = Card(sms=132, smem_per_sm=233472, smem_per_block_reserved=1024, registers_per_sm=65536)


class LaunchPlan(NamedTuple):
    """What one launch of the kernel is told, for ``(n_h, n_v, nq, dtype)``
    and, through the route, the batch and the card."""

    mr: int  # warp tile: rows, in blocks of 8 (even: MMAs take row pairs)
    nc: int  # warp tile: columns, in blocks of 8
    ld: int  # row length of the padded s-major table
    nq_pad: int  # quadrature points, padded to whole chunks
    chunk: int  # quadrature points per ring stage (nq_pad when resident)
    stages: int  # ring stages; 1 means the whole table stays resident
    group: int  # elements a block takes per step
    warps: int  # warps per block
    # Element route: quadrant << 28 | tile row << 14 | tile column; panel
    # route: the panels, coded alike in panel rows and columns.
    tiles: tuple[int, ...]
    smem_bytes: int
    route: str = "element"  # or "panel": one block per (panel, element)
    panel: tuple[int, int] = (0, 0)  # panel route: rows x columns, in warp tiles
    slice_ld: int = 0  # panel route: row length of a ring stage

    def as_ints(self) -> list[int]:
        """The fields the C entry point takes, in its order."""
        return [
            self.mr, self.nc, self.ld, self.nq_pad, self.chunk, self.stages,
            self.group, self.warps, len(self.tiles), ROUTES.index(self.route),
            *self.panel, self.slice_ld,
        ]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _row_length(entries: int) -> int:
    """``entries`` rounded up to 4 (mod 16): the four quadrature points and
    eight table columns of an MMA fragment load fall into distinct banks."""
    return entries + (4 - entries) % 16


def tile_list(nb_h: int, nb_v: int, mr: int, nc: int) -> tuple[int, ...]:
    """The warp tiles of one element, as codes, those with the most MMAs
    first.  ``nb_h`` and ``nb_v`` are the blocks of 8 in the h and v parts.
    The tiles of hh and vv that lie wholly below the block diagonal are
    left out.  With ``mr`` and ``nc`` the blocks of a panel, the panels."""
    tiles = []
    for q, nb_rows, nb_cols in ((HH, nb_h, nb_h), (HV, nb_h, nb_v), (VV, nb_v, nb_v)):
        diagonal = q != HV
        for tr in range(_ceil_div(nb_rows, mr)):
            for tc in range(_ceil_div(nb_cols, nc)):
                # An MMA takes the row pair from block rb on and column block cb.
                n_mma = sum(
                    not (diagonal and cb < rb)
                    for rb in range(tr * mr, min((tr + 1) * mr, nb_rows), 2)
                    for cb in range(tc * nc, min((tc + 1) * nc, nb_cols))
                )
                if n_mma:
                    tiles.append((-n_mma, q << 28 | tr << 14 | tc))
    return tuple(code for _, code in sorted(tiles))


def plan_with_tile(
    n_h: int, n_v: int, nq: int, dtype: torch.dtype, mr: int, nc: int
) -> LaunchPlan:
    """The launch plan for warp tiles of ``mr x nc`` blocks."""
    size = torch.empty((), dtype=dtype).element_size()
    nb_h = _ceil_div(n_h, BLOCK)
    nb_v = _ceil_div(n_v, BLOCK)
    ld = _row_length((nb_h + nb_v) * BLOCK)
    tiles = tile_list(nb_h, nb_v, mr, nc)

    nq_pad = _ceil_div(nq, 4) * 4
    if nq_pad * ld * size <= RESIDENT_BYTES:
        chunk, stages = nq_pad, 1
    else:
        fitting = [c for c in CHUNKS if RING_STAGES * c * ld * size <= RING_BYTES]
        if not fitting:
            raise ValueError(
                f"mass_edge: no launch plan fits {SMEM_LIMIT} bytes of shared"
                f" memory for n_h={n_h}, n_v={n_v}."
            )
        chunk, stages = fitting[0], RING_STAGES
        nq_pad = _ceil_div(nq, chunk) * chunk
    table_bytes = stages * chunk * ld * size
    warps = 8 if table_bytes <= 48 * 1024 else 16

    def smem(group: int) -> int:
        # The ring, two sets of three metric rows per element, the tile codes.
        return table_bytes + 2 * group * 3 * nq_pad * size + _ceil_div(len(tiles), 4) * 16

    fitting = [g for g in GROUPS if smem(g) <= SMEM_LIMIT]
    if not fitting:
        raise ValueError(
            f"mass_edge: no launch plan fits {SMEM_LIMIT} bytes of shared"
            f" memory for n_h={n_h}, n_v={n_v}, nq={nq}."
        )

    # Elements per step: the largest group whose items fill whole rounds of
    # the block's warps to within 5% (a step costs a barrier and a wait for
    # the next metric rows), else the one that wastes least.
    def waste(group: int) -> float:
        items = group * len(tiles)
        return _ceil_div(items, warps) * warps / items

    good = [g for g in fitting if waste(g) <= 1.05]
    group = good[-1] if good else min(fitting, key=waste)
    return LaunchPlan(mr, nc, ld, nq_pad, chunk, stages, group, warps, tiles, smem(group))


@functools.cache
def element_plan(n_h: int, n_v: int, nq: int, dtype: torch.dtype) -> LaunchPlan:
    """The plan of the element route, whole elements a block.

    Raises ``ValueError`` when no plan fits ``SMEM_LIMIT`` (a table row
    beyond about 2,000 entries, far above the orders anyone assembles)."""
    # The warp tile whose tiles have the fewest block slots in all, so the
    # fewest unused; the larger tile (fewer fragment loads per MMA) on a tie.
    # On an NVIDIA H100 80GB HBM3 at 700 W (tools/mass_edge_ablation.py, f64,
    # E=1024) the tile so chosen is the faster one, or within 5% of it (2%
    # from p=4 on), at every order from 1 to 12; the other loses up to 20%
    # (4x4 at p=8).
    plans = (plan_with_tile(n_h, n_v, nq, dtype, mr, nc) for mr, nc in WARP_TILES)
    return min(plans, key=lambda plan: len(plan.tiles) * plan.mr * plan.nc)


def blocks_per_sm(plan: LaunchPlan, card: Card) -> int:
    """How many blocks of ``plan`` one SM of ``card`` holds at once."""
    by_smem = card.smem_per_sm // (plan.smem_bytes + card.smem_per_block_reserved)
    by_registers = card.registers_per_sm // (plan.warps * 32 * THREAD_REGISTERS)
    return max(1, min(by_smem, by_registers))


def rounds(plan: LaunchPlan, n_elem: int, card: Card) -> int:
    """The rounds of warp tiles that the busiest SM takes one after the
    other: on the element route, the turns of its blocks times the rounds
    of their warps over a step's tiles; on the panel route, the turns of
    its items, one round each."""
    slots = card.sms * blocks_per_sm(plan, card)
    if plan.route == "panel":
        return _ceil_div(n_elem * len(plan.tiles), slots)
    turns = _ceil_div(_ceil_div(n_elem, plan.group), slots)
    return turns * _ceil_div(plan.group * len(plan.tiles), plan.warps)


def panel_plan(
    n_h: int, n_v: int, nq: int, dtype: torch.dtype, mr: int, nc: int,
    n_elem: int, card: Card, panel: tuple[int, int] | None = None,
) -> LaunchPlan:
    """The plan of the panel route for warp tiles of ``mr x nc`` blocks and
    a batch of ``n_elem`` on ``card``: the panel of ``PANELS`` with the
    fewest rounds, the smaller on a tie; or ``panel``."""
    plans = [
        _panel_plan(n_h, n_v, nq, dtype, mr, nc, shape)
        for shape in ((panel,) if panel else PANELS)
    ]
    # In the sweep of tools/mass_edge_ablation.py (f64, an NVIDIA H100 80GB
    # HBM3 at 700 W) a round took about the same time with either panel
    # (0.035 to 0.045 ms at p=16), and 2 x 2 tiles, which stream twice the
    # table columns per MMA, won where the rounds tie.
    return min(plans, key=lambda plan: (rounds(plan, n_elem, card), plan.warps))


def _panel_plan(
    n_h: int, n_v: int, nq: int, dtype: torch.dtype, mr: int, nc: int,
    panel: tuple[int, int],
) -> LaunchPlan:
    size = torch.empty((), dtype=dtype).element_size()
    nb_h = _ceil_div(n_h, BLOCK)
    nb_v = _ceil_div(n_v, BLOCK)
    rows, cols = panel
    panels = tile_list(nb_h, nb_v, rows * mr, cols * nc)
    # A stage row holds a row range and a column range of the panel.
    slice_ld = _row_length((rows * mr + cols * nc) * BLOCK)

    def smem(chunk: int) -> int:
        # The ring of slices and the metric row of the block's element.
        return (RING_STAGES * chunk * slice_ld + _ceil_div(nq, chunk) * chunk) * size

    fitting = [c for c in CHUNKS if smem(c) <= SMEM_LIMIT]
    if not fitting:
        raise ValueError(
            f"mass_edge: no panel plan fits {SMEM_LIMIT} bytes of shared"
            f" memory for n_h={n_h}, n_v={n_v}, nq={nq}."
        )
    chunk = fitting[0]
    return LaunchPlan(
        mr, nc, ld=_row_length((nb_h + nb_v) * BLOCK), nq_pad=_ceil_div(nq, chunk) * chunk,
        chunk=chunk, stages=RING_STAGES, group=1, warps=rows * cols, tiles=panels,
        smem_bytes=smem(chunk), route="panel", panel=(rows, cols), slice_ld=slice_ld,
    )


@functools.cache
def launch_plan(
    n_h: int, n_v: int, nq: int, dtype: torch.dtype, n_elem: int, card: Card
) -> LaunchPlan:
    """The launch plan of the kernel for a batch of ``n_elem`` on ``card``;
    a pure function of its arguments.

    A batch whose element-route blocks are fewer than the SMs takes the
    panel route where that needs fewer rounds of warp tiles.  In the sweep
    of tools/mass_edge_ablation.py (f64, p=4 to 16 and E=1 to 512, an
    NVIDIA H100 80GB HBM3 at 700 W) the plan so chosen was the fastest of
    the element route and four panels, or within 20% of it, at all 130
    points, and 1.3% off on the geometric mean.  At p=16, E=16 the panels
    take 3 rounds against 43 (0.1278 ms against 2.3294); at p=14, E=128
    whole elements take 9 against 10 and ran 1.64x faster than panels."""
    plan = element_plan(n_h, n_v, nq, dtype)
    if _ceil_div(n_elem, plan.group) >= card.sms:
        return plan
    panels = panel_plan(n_h, n_v, nq, dtype, plan.mr, plan.nc, n_elem, card)
    return panels if rounds(panels, n_elem, card) < rounds(plan, n_elem, card) else plan


def padded_table(tb: TensorBasis, plan: LaunchPlan) -> np.ndarray:
    """Both basis tables as one s-major, zero-padded ``[nq_pad, ld]`` array:
    ``table[s, r] = bh[r, s]`` for the h rows, and ``table[s, n_hp + r] =
    bv[r, s]`` with ``n_hp`` = ``n_h`` rounded up to 8, so that every block
    of 8 columns belongs to one of the two parts and a chunk of quadrature
    points is one contiguous, 16-byte-aligned range."""
    n_h, nq = tb.bh.shape
    n_v = tb.bv.shape[0]
    n_hp = _ceil_div(n_h, BLOCK) * BLOCK
    table = np.zeros((plan.nq_pad, plan.ld))
    table[:nq, :n_h] = tb.bh.T
    table[:nq, n_hp : n_hp + n_v] = tb.bv.T
    return table


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = _build.load("mass_edge")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.mfv2d_mass_edge_card.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.mfv2d_mass_edge_card.restype = ctypes.c_int
    return lib


def _check(tb: TensorBasis, jac: JacobianTerms) -> tuple[int, int]:
    det = jac.det
    if det.dtype not in _ENTRY:
        raise TypeError(f"mass_edge takes float32 or float64, got {det.dtype}.")
    nq = tb.w.size
    if det.ndim != 2 or det.shape[1] != nq:
        raise ValueError(
            f"Jacobian terms must be [E, {nq}], got {tuple(det.shape)}."
        )
    for name, t in zip(JacobianTerms._fields, jac):
        if t.shape != det.shape or t.dtype != det.dtype or t.device != det.device:
            raise ValueError(
                f"Jacobian term {name} must match det in shape, dtype and device."
            )
        if not t.is_contiguous():
            raise ValueError(f"Jacobian term {name} must be contiguous.")
    return det.shape[0], nq


def _device_tables(
    tb: TensorBasis, plan: LaunchPlan, like: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """The padded table, ``w`` and the tile or panel codes of ``plan`` on
    ``like``'s device, the first two in its dtype, from the basis's device
    tables.  Both routes share the table of a layout (rows and ``ld``)."""
    return (
        tb.tables.like(("m1 table", plan.nq_pad, plan.ld), lambda: padded_table(tb, plan), like),
        tb.tensor("w", like),
        tb.tables.get(("m1 tiles", plan.tiles), lambda: plan.tiles, torch.int32, like.device),
    )


@functools.cache
def card(device: torch.device) -> Card:
    """A CUDA device's SMs and what one SM holds, from the CUDA runtime."""
    values = (ctypes.c_int * len(Card._fields))()
    with torch.cuda.device(device):
        rc = library().mfv2d_mass_edge_card(values)
    if rc != 0:
        raise RuntimeError(f"mass_edge: reading {device} failed with CUDA error {rc}.")
    return Card(*values)


def mass_edge(tb: TensorBasis, jac: JacobianTerms) -> torch.Tensor:
    """M1 ``[E, n1, n1]`` for the flattened ``[E, nq]`` Jacobian terms."""
    global launches
    device = jac.det.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"mass_edge runs on CPU or CUDA tensors, not {device}.")
    n_elem, nq = _check(tb, jac)
    if device.type == "cpu":
        return _plain.mass_edge(tb, jac)
    dtype = jac.det.dtype
    n_h = tb.bh.shape[0]
    n_v = tb.bv.shape[0]
    n1 = n_h + n_v
    out = torch.empty((n_elem, n1, n1), dtype=dtype, device=device)
    if n_elem == 0:
        return out
    plan = launch_plan(n_h, n_v, nq, dtype, n_elem, card(device))
    tensors = (*jac, *_device_tables(tb, plan, jac.det), out)
    pointers = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    plan_ints = plan.as_ints()
    plan_array = (ctypes.c_int * len(plan_ints))(*plan_ints)
    fn = getattr(library(), _ENTRY[dtype])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*pointers, n_elem, n_h, n_v, nq, plan_array, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"mass_edge kernel launch failed with CUDA error {rc}.")
    launches += 1
    return out

