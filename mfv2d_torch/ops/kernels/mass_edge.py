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
can be checked without a card: the warp tile, the list of tiles an element
is cut into, the padded table layout, how many quadrature points a ring
stage holds, how many elements a block takes at a time, and the shared
memory all of that needs.  ``launches`` counts the kernel launches made
through this wrapper, so a run can show that its main path used the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
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
# Quadrants of M1 in the tile codes, rows x columns: hh and vv are computed
# on and above the block diagonal and hv once; the kernel stores the mirror
# images, so vh has no tiles.
HH, HV, VV = range(3)
# Device copies of the padded table, the weights and the tile list, one per
# (TensorBasis, dtype, device, plan), dropped when the TensorBasis is collected.
_tables: dict[tuple, tuple[torch.Tensor, ...]] = {}


class LaunchPlan(NamedTuple):
    """What one launch of the kernel is told, for ``(n_h, n_v, nq, dtype)``."""

    mr: int  # warp tile: rows, in blocks of 8 (even: MMAs take row pairs)
    nc: int  # warp tile: columns, in blocks of 8
    ld: int  # row length of the padded s-major table
    nq_pad: int  # quadrature points, padded to whole chunks
    chunk: int  # quadrature points per ring stage (nq_pad when resident)
    stages: int  # ring stages; 1 means the whole table stays resident
    group: int  # elements a block takes per step
    warps: int  # warps per block
    tiles: tuple[int, ...]  # quadrant << 28 | tile row << 14 | tile column
    smem_bytes: int

    def as_ints(self) -> list[int]:
        """The fields the C entry point takes, in its order."""
        return [
            self.mr, self.nc, self.ld, self.nq_pad, self.chunk, self.stages,
            self.group, self.warps, len(self.tiles),
        ]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_list(nb_h: int, nb_v: int, mr: int, nc: int) -> tuple[int, ...]:
    """The warp tiles of one element, as codes, those with the most MMAs
    first.  ``nb_h`` and ``nb_v`` are the blocks of 8 in the h and v parts.
    The tiles of hh and vv that lie wholly below the block diagonal are
    left out."""
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
    n1_pad = (nb_h + nb_v) * BLOCK
    # Rows of ld = 4 (mod 16) entries: the four quadrature points and eight
    # table columns of an MMA fragment load fall into distinct banks.
    ld = n1_pad + (4 - n1_pad) % 16
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
def launch_plan(n_h: int, n_v: int, nq: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of the kernel; a pure function of the shapes.

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
    """The padded table, ``w`` and the tile codes of ``plan`` on ``like``'s
    device, the first two in its dtype."""
    key = (id(tb), like.dtype, like.device, plan)
    tables = _tables.get(key)
    if tables is None:
        tables = (
            torch.tensor(padded_table(tb, plan), dtype=like.dtype, device=like.device),
            torch.tensor(np.asarray(tb.w), dtype=like.dtype, device=like.device),
            torch.tensor(plan.tiles, dtype=torch.int32, device=like.device),
        )
        _tables[key] = tables
        weakref.finalize(tb, _tables.pop, key, None)
    return tables


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
    plan = launch_plan(n_h, n_v, nq, dtype)
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

