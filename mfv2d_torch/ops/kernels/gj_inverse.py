"""Batched ``[E, n, n]`` inverse through the hand-written Hopper kernel.

``gj_inverse(a)`` computes what
:func:`mfv2d_torch.ops.precision.gj_inverse_plain` computes (its plain
PyTorch version, ``torch.linalg.inv``) in the dtype of ``a``, float32 or
float64.

- For tensors on the CPU it returns the plain version.
- For CUDA tensors it launches ``csrc/gj_inverse.cu`` (built at first use,
  see :mod:`mfv2d_torch.ops.kernels._build`) on the current stream, or
  raises.  There is no fallback.
- A zero or non-finite pivot raises ``torch.linalg.LinAlgError`` naming the
  first element at fault, as ``torch.linalg.inv`` does for a singular input.

The kernel replaces the Pallas TPU kernel ``gj_inverse_pallas``
(mfv2d_tpu/ops/pallas_factor.py).  Its route depends on n (:func:`route`);
the source note in the ``.cu`` file says what bounds each on the card.
``launches`` counts the kernel launches made through this wrapper, so a run
can show that its path used the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mfv2d_torch.ops.kernels import _build
from mfv2d_torch.ops.precision import gj_inverse_plain

launches = 0

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# Route names in the order of their codes in csrc/gj_inverse.cu.
ROUTES = ("register", "blocked", "streamed", "global")
REGISTER_MAX_N = 64
# The blocked route's last n: the largest at which two of its f64 blocks
# fit on one SM (`blocked_route_bytes` in the .cu file).
BLOCKED_MAX_N = 218
# The streamed route holds two rows of a 32-column panel or four of a
# 16-column one a thread (256 threads).
STREAMED_MAX_N = 1024
PANEL = 32


def route(n: int, dtype: torch.dtype) -> str:
    """The kernel route an ``n x n`` inverse in ``dtype`` takes.

    - ``"register"``, n <= 64: one matrix row per thread in registers, a
      group of 32 or 64 threads per matrix.
    - ``"blocked"``, to n = 218, while two of its f64 blocks fit on one SM:
      one block per matrix, panels of 32 columns and rank-32 tile updates.
    - ``"streamed"``, to n = 1024: the same panel sweep in one launch and
      the tile updates in another, for each panel, with the tiles streamed
      through shared memory and the update on the FP64 tensor cores; panels
      of :func:`panel_width` columns.
    - ``"global"``, above (Navier-Stokes from p = 16, n = 1089): in place
      in global memory, one step at a time.

    The blocked route beats the streamed one at n=208 (E=1000 and 4096,
    f64) and loses from n=224 (f64, E=1000), where one of its blocks fills
    an SM; ``tools/gj_inverse_ablation.py`` times both at the boundary.
    f32 keeps the f64 boundary, though the streamed route is a few percent
    faster there in f32 too.
    """
    if n < 1:
        raise ValueError(f"gj_inverse: no route for n={n}.")
    if n <= REGISTER_MAX_N:
        return "register"
    if n <= BLOCKED_MAX_N:
        return "blocked"
    if n <= STREAMED_MAX_N:
        return "streamed"
    return "global"


def panel_width(n: int) -> int:
    """Columns of a streamed panel: 32 while a thread's panel rows (n / 256
    of them) hold at most 64 entries, 16 above n = 512."""
    return PANEL if n <= 512 else PANEL // 2


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = _build.load("gj_inverse")
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"mfv2d_gj_inverse_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    name = route(n, a.dtype)
    info = torch.empty(n_elem, dtype=torch.int32, device=a.device)
    # The streamed route's row gather and row permutation, per matrix.
    scratch = None
    if name == "streamed":
        scratch = torch.empty((2, n_elem, n), dtype=torch.int32, device=a.device)
    fn = getattr(library(), f"mfv2d_gj_inverse_{_SUFFIX[a.dtype]}")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
            ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(info.data_ptr()),
            ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
            n_elem,
            n,
            ROUTES.index(name),
            panel_width(n),
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
