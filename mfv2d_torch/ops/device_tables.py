"""Device copies of the constant host tables, one per (table, dtype, device).

The basis tables, quadrature weights and nodes, incidence matrices, the
fused assembly's pair tables and constant blocks, and the M1 kernel's
padded table and tile codes are NumPy arrays built on the host.  The first
request for one of them in a dtype on a device uploads it; every later
request is served from that copy.  The JAX package gets the same effect
from ``jax.jit``, which keeps these arrays on the device as constants of
its executables.

A table belongs to an owner, which holds its :class:`Tables`: a
``TensorBasis`` (one per orders and integration orders, see
:func:`mfv2d_torch.ops.mass.tensor_basis`) or a fused ``BlockPlan`` (one
per op chain and orders, see ``fused_assembly._cached_plan``).  The copies
go when their owner is collected, so the device holds tables only for
orders that a memoized basis or plan still uses.

A cached tensor is shared by every caller: it is read, never written in
place.  On the CPU a writable host table of the requested dtype is not
copied: the tensor shares its memory and its strides.

``uploads`` and ``upload_bytes`` count the tables uploaded (set them to 0
before a run to count that run's); :func:`resident_bytes` gives what the
copies hold now, and :func:`clear` drops them all.
"""

from __future__ import annotations

import weakref
from collections.abc import Callable, Hashable

import numpy as np
import torch

from mfv2d_torch.transfer import to_device

uploads = 0
upload_bytes = 0
# Every live Tables object, for resident_bytes and clear.
_live: weakref.WeakSet = weakref.WeakSet()


class Tables:
    """The device copies of one owner's host tables, keyed by the table's
    name within its owner, the dtype and the device."""

    __slots__ = ("_copies", "__weakref__")

    def __init__(self) -> None:
        self._copies: dict[tuple, torch.Tensor] = {}
        _live.add(self)

    def get(
        self,
        name: Hashable,
        make: Callable[[], object],
        dtype: torch.dtype,
        device: torch.device,
    ) -> torch.Tensor:
        """The table ``name`` in ``dtype`` on ``device``; on the first
        request ``make()`` gives the host array, which is uploaded."""
        global uploads, upload_bytes
        device = torch.device(device)
        key = (name, dtype, device)
        tensor = self._copies.get(key)
        if tensor is None:
            host = np.asarray(make())
            if device.type == "cpu" and host.flags.writeable:
                # On the CPU the host table itself serves, in its layout,
                # where its dtype is the one asked for: no second copy (2.9
                # GB at p=16).
                tensor = torch.from_numpy(host).to(dtype)
            else:
                tensor = to_device(host, device, dtype, copy=True)
            self._copies[key] = tensor
            uploads += 1
            upload_bytes += tensor.nbytes
        return tensor

    def like(self, name: Hashable, make: Callable[[], object], like: torch.Tensor):
        """:meth:`get` in ``like``'s dtype on ``like``'s device."""
        return self.get(name, make, like.dtype, like.device)

    def tensors(self) -> list[torch.Tensor]:
        return list(self._copies.values())


def cached_tensors() -> list[torch.Tensor]:
    """Every device copy that a live owner holds."""
    return [t for tables in list(_live) for t in tables.tensors()]


def resident_bytes(device=None) -> int:
    """The bytes that the copies hold, on ``device`` or on every device."""
    device = None if device is None else torch.device(device)
    return sum(
        t.nbytes
        for t in cached_tensors()
        if device is None
        or (t.device.type == device.type and device.index in (None, t.device.index))
    )


def clear() -> None:
    """Drop every copy, so the next request uploads again (a cold cache)."""
    for tables in list(_live):
        tables._copies.clear()
