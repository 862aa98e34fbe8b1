"""Batched ``[E, n, n]`` inverse through the hand-written Hopper kernel.

``gj_inverse(a)`` computes what
:func:`mfv2d_torch.ops.precision.gj_inverse_plain` computes (its plain
PyTorch version, ``torch.linalg.inv``) in the dtype of ``a``, float32 or
float64.

- For tensors on the CPU it returns the plain version.
- For CUDA tensors it launches ``csrc/gj_inverse.cu`` (built at first use,
  see :mod:`mfv2d_torch.ops.kernels._build`) on the current stream, or
  raises.  There is no fallback.  On the streamed route (n >= 219) a call
  whose rows are not a multiple of 16 bytes (odd n in f64) also allocates
  an ``[E, n, ld]`` work matrix beside the output, ``E n ld`` entries: 687
  MB at n=289, E=1024 and 152 MB at n=1089, E=16 in f64.
- A zero or non-finite pivot raises ``torch.linalg.LinAlgError`` naming the
  first element at fault, as ``torch.linalg.inv`` does for a singular input.

The kernel replaces the Pallas TPU kernel ``gj_inverse_pallas``
(mfv2d_tpu/ops/pallas_factor.py).  Its route and layout depend on n and
the dtype, and are decided here (:func:`launch_plan`), so that they can be
checked without a card; the source note in the ``.cu`` file says what
bounds each route on the card.
``launches`` counts the kernel launches made through this wrapper, so a run
can show that its path used the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mfv2d_torch.ops.kernels import _build
from mfv2d_torch.ops.precision import gj_inverse_plain

launches = 0

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# Route names in the order of their codes in csrc/gj_inverse.cu.
ROUTES = ("register", "blocked", "streamed")
REGISTER_MAX_N = 64
# The blocked route's last n: the largest at which two of its f64 blocks
# fit on one SM (`blocked_route_bytes` in the .cu file).
BLOCKED_MAX_N = 218
# Dynamic and static shared memory a block may use on Hopper after opting in.
SMEM_LIMIT = 232448
# The streamed route's panel launch: threads a block, and the panel rows a
# thread holds in registers for each panel width (64 entries); at most
# MAX_CLUSTER blocks a matrix (the portable cluster size).
THREADS = 256
PANEL_ROWS = {32: 2, 16: 4}
MAX_CLUSTER = 8
# ... its update launch: staged rows of panel + 4 entries, two pivot-row
# strips and a ring of 3 stages of 32-row chunks of M and C; the column
# swaps: at most 4 warps, one row each.
STREAM_PAD = 4
STREAM_ROWS = 32
STREAM_STAGES = 3
UNSWAP_WARPS = 4


class LaunchPlan(NamedTuple):
    """What one call of the kernel is told for an ``n x n`` inverse."""

    route: str
    panel: int = 0  # streamed: columns a panel
    blocks: int = 1  # streamed: blocks of a panel launch per matrix, a cluster above 1
    spill: int = 0  # streamed: panel rows a block holds in L2 beyond its registers
    panel_bytes: int = 0  # streamed: shared memory of a panel block, static included
    update_bytes: int = 0  # ... of an update block
    unswap_warps: int = 0  # ... rows the column swaps hold at once, one a warp
    ld: int = 0  # streamed: row stride of the swept work matrix, n rounded up to 16 bytes


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _streamed_plan(n: int, dtype: torch.dtype, panel: int, blocks: int) -> LaunchPlan:
    """The streamed route at ``panel`` columns with ``blocks`` panel blocks
    a matrix, as ``launch_streamed`` in the .cu file lays it out: each block
    holds ``PANEL_ROWS[panel] * THREADS`` panel rows in registers and its
    share of the rest in L2.  The panels and updates sweep a work matrix
    whose rows start 16 bytes apart (``ld``), so that every row moves in
    16-byte pieces; where ``ld > n`` that is an ``[E, n, ld]`` buffer beside
    the output.  Raises ``ValueError`` where the update or the column swaps
    do not fit in shared memory."""
    size = torch.finfo(dtype).bits // 8
    held = blocks * PANEL_ROWS[panel] * THREADS
    spill = max(0, -(-(n - held) // blocks))
    # src, then one block's pivot row, row k, warp maxima and block maximum
    # (keys and rows), or a cluster's two sets of a candidate row a block,
    # row k, the block's warp maxima and the blocks' maxima
    sets, slots = (2, MAX_CLUSTER) if blocks > 1 else (1, 1)
    step = (slots + 1) * panel * size + (THREADS // 32 + slots) * (size + 4)
    shared = _round16(4 * n) + sets * step
    ld = panel + STREAM_PAD
    update = (2 * panel * ld + STREAM_STAGES * 2 * STREAM_ROWS * ld) * size + 4 * n
    warps = UNSWAP_WARPS
    while warps > 1 and _round16(4 * n) + warps * n * size > SMEM_LIMIT:
        warps //= 2
    if max(shared, update, _round16(4 * n) + warps * n * size) > SMEM_LIMIT:
        raise ValueError(f"gj_inverse: n={n} does not fit the streamed route's shared memory.")
    vec = 16 // size
    ld = -(-n // vec) * vec
    return LaunchPlan("streamed", panel, blocks, spill, shared, update, warps, ld)


def route(n: int, dtype: torch.dtype) -> str:
    """The kernel route an ``n x n`` inverse in ``dtype`` takes.

    - ``"register"``, n <= 64: one matrix row per thread in registers, a
      group of 32 or 64 threads per matrix.
    - ``"blocked"``, to n = 218, while two of its f64 blocks fit on one SM:
      one block per matrix, panels of 32 columns and rank-32 tile updates.
    - ``"streamed"``, every larger n: per panel, a sweep launch and a
      tile-update launch on the FP64 tensor cores, with the tiles streamed
      through shared memory; :func:`launch_plan` lays it out.

    The blocked route beats the streamed one at n=208 (E=1000 and 4096,
    f64) and loses from n=224 (f64, E=1000), where one of its blocks fills
    an SM; ``tools/gj_inverse_ablation.py`` times both at the boundary and
    the streamed layouts above n = 1024.  f32 keeps the f64 boundaries.
    """
    if n < 1:
        raise ValueError(f"gj_inverse: no route for n={n}.")
    if n <= REGISTER_MAX_N:
        return "register"
    if n <= BLOCKED_MAX_N:
        return "blocked"
    return "streamed"


def launch_plan(n: int, dtype: torch.dtype) -> LaunchPlan:
    """The route of an ``n x n`` inverse in ``dtype`` and its layout: the
    streamed route's panels are 32 columns held in the registers of one
    block to n = 512, 16 to n = 1024 (four rows a thread), and 32 again
    above, over a cluster of ceil(n / 512) blocks (at most 8), whose rows
    past 4,096 go to L2; its work matrix has rows ``ld`` entries apart, n
    rounded up to 16 bytes (n + 1 for odd n in f64).  Raises
    ``ValueError`` past the streamed route's largest n (19,370 in f64),
    where the column swaps' one row and the row permutation no longer fit
    in shared memory."""
    name = route(n, dtype)
    if name != "streamed":
        return LaunchPlan(name)
    if n <= 2 * THREADS:
        return _streamed_plan(n, dtype, 32, 1)
    if n <= 4 * THREADS:
        return _streamed_plan(n, dtype, 16, 1)
    return _streamed_plan(n, dtype, 32, min(MAX_CLUSTER, -(-n // (2 * THREADS))))


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = _build.load("gj_inverse")
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"mfv2d_gj_inverse_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor) -> None:
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"gj_inverse takes a tensor, got {type(a).__name__}.")
    if a.dtype not in _SUFFIX:
        raise TypeError(f"gj_inverse takes float32 or float64, got {a.dtype}.")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gj_inverse runs on CPU or CUDA tensors, not {a.device}.")
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"gj_inverse takes [E, n, n] matrices, got {tuple(a.shape)}.")
    if not a.is_contiguous():
        raise ValueError("gj_inverse takes a contiguous tensor.")


def gj_inverse(a: torch.Tensor) -> torch.Tensor:
    """The inverses of the ``[E, n, n]`` matrices ``a``."""
    global launches
    _check(a)
    if a.device.type == "cpu":
        return gj_inverse_plain(a)
    n_elem, n = a.shape[0], a.shape[1]
    out = torch.empty_like(a)
    if n_elem == 0 or n == 0:
        return out
    plan = launch_plan(n, a.dtype)
    info = torch.empty(n_elem, dtype=torch.int32, device=a.device)
    # The streamed route's row gather and row permutation, per matrix, and
    # its work matrix where the rows of ``out`` are not 16 bytes apart.
    scratch = work = None
    if plan.route == "streamed":
        scratch = torch.empty((2, n_elem, n), dtype=torch.int32, device=a.device)
        if plan.ld != n:
            work = torch.empty((n_elem, n, plan.ld), dtype=a.dtype, device=a.device)
    fn = getattr(library(), f"mfv2d_gj_inverse_{_SUFFIX[a.dtype]}")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
            ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(info.data_ptr()),
            ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
            ctypes.c_void_p(None if work is None else work.data_ptr()),
            n_elem,
            n,
            ROUTES.index(plan.route),
            plan.panel,
            plan.blocks,
            plan.ld,
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"gj_inverse kernel launch failed with CUDA error {rc}.")
    launches += 1
    bad = torch.nonzero(info).flatten()
    if bad.numel():
        e = int(bad[0])
        raise torch.linalg.LinAlgError(
            f"gj_inverse: matrix {e} of the batch is singular: pivot"
            f" {int(info[e])} is zero or not finite."
        )
    return out
