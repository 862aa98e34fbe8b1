"""M1, the 1-form mass matrix, through the hand-written Hopper kernel.

``mass_edge(tb, jac)`` computes what :func:`mfv2d_torch.ops.mass.mass_edge`
computes (its plain PyTorch version) for a batch of ``E`` elements:
``[E, n1, n1]`` in the dtype of the Jacobian terms, float32 or float64.

- For tensors on the CPU it returns the plain version.
- For CUDA tensors it launches ``csrc/mass_edge.cu`` (built at first use,
  see :mod:`mfv2d_torch.ops.kernels._build`) on the current stream, or
  raises.  There is no fallback.

The kernel replaces the Pallas TPU kernel ``mass_edge_pallas``
(mfv2d_tpu/ops/pallas_mass.py); the source note in the ``.cu`` file says
what bounds it on the card.  ``launches`` counts the kernel launches made
through this wrapper, so a run can show that its main path used the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from mfv2d_torch.ops import mass as _plain
from mfv2d_torch.ops.geometry import JacobianTerms
from mfv2d_torch.ops.kernels import _build
from mfv2d_torch.ops.mass import TensorBasis, as_like

launches = 0

_ENTRY = {
    torch.float64: "mfv2d_mass_edge_f64",
    torch.float32: "mfv2d_mass_edge_f32",
}
# Dynamic shared memory a block may use on Hopper after opting in.
_SMEM_LIMIT = 232448
# Device copies of the basis tables, one per (TensorBasis, dtype, device),
# dropped when the TensorBasis is collected.
_tables: dict[tuple, tuple[torch.Tensor, ...]] = {}


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C entry points declared."""
    lib = _build.load("mass_edge")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    # Two transposed [nq, ld] basis tables and three [nq] metric rows.
    ld = -(-max(tb.bh.shape[0], tb.bv.shape[0]) // 4) * 4
    if (2 * nq * ld + 3 * nq) * det.element_size() > _SMEM_LIMIT:
        raise ValueError(
            f"Orders ({tb.p1}, {tb.p2}) exceed the kernel's shared-memory budget."
        )
    return det.shape[0], nq


def _device_tables(tb: TensorBasis, like: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``bh``, ``bv`` and ``w`` of ``tb`` in ``like``'s dtype and device."""
    key = (id(tb), like.dtype, like.device)
    tables = _tables.get(key)
    if tables is None:
        tables = tuple(as_like(a, like).contiguous() for a in (tb.bh, tb.bv, tb.w))
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
    n_h = tb.bh.shape[0]
    n_v = tb.bv.shape[0]
    n1 = n_h + n_v
    dtype = jac.det.dtype
    bh, bv, w = _device_tables(tb, jac.det)
    out = torch.empty((n_elem, n1, n1), dtype=dtype, device=device)
    if n_elem == 0:
        return out
    fn = getattr(library(), _ENTRY[dtype])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*jac, bh, bv, w, out)]
        rc = fn(*ptrs, n_elem, n_h, n_v, nq, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"mass_edge kernel launch failed with CUDA error {rc}.")
    launches += 1
    return out
