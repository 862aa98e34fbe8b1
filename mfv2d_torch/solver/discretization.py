"""Mesh discretization: order buckets and global DoF bookkeeping.

Elements are grouped into *buckets* by (p1, p2) so each bucket forms one
``[E, ...]`` batch for the device kernels, on the device the caller names.
The global DoF vector is the concatenation of per-leaf element DoFs in leaf order (identical layout to the
reference, solve_system_2d.py:173-189), and each bucket carries a static
``[E, n]`` gather-index map into it — the element <-> global exchange is pure
gather/scatter with indices computed once on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import numpy.typing as npt

from mfv2d_torch.evaluation import ElementBatch, check_device
from mfv2d_torch.mesh.quadtree import Mesh
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.system import ElementFormSpecification


@dataclass
class OrderBucket:
    """All leaf elements sharing one (p1, p2) pair."""

    orders: tuple[int, int]
    leaf_ranks: npt.NDArray[np.int64]  # positions in the leaf ordering
    batch: ElementBatch
    gather: npt.NDArray[np.int64]  # [E, n_dofs] indices into the global vector


@dataclass
class Discretization:
    """Derived per-mesh data shared by assembly and the solvers."""

    mesh: Mesh
    form_spec: ElementFormSpecification
    basis_cache: FemCache
    leaf_indices: tuple[int, ...]
    element_orders: npt.NDArray[np.int64]  # [n_leaves, 2]
    element_sizes: npt.NDArray[np.int64]
    element_offsets: npt.NDArray[np.int64]  # [n_leaves + 1]
    buckets: list[OrderBucket] = field(default_factory=list)

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_indices)

    @property
    def n_dofs(self) -> int:
        return int(self.element_offsets[-1])


def discretize_mesh(
    mesh: Mesh,
    form_spec: ElementFormSpecification,
    basis_cache: FemCache,
    device="cuda",
) -> Discretization:
    """Build the bucketed discretization from a mesh.

    Each bucket's geometry lives on ``device`` (the CUDA device unless the
    caller asks for ``"cpu"``); the DoF bookkeeping stays on the host.
    """
    device = check_device(device)
    leaf_indices = tuple(int(v) for v in mesh.get_leaf_indices())
    n_leaves = len(leaf_indices)
    element_orders = np.array(
        [mesh.get_leaf_orders(i) for i in leaf_indices], np.int64
    )
    element_sizes = np.array(
        [form_spec.total_size(int(o1), int(o2)) for o1, o2 in element_orders],
        np.int64,
    )
    element_offsets = np.concatenate([[0], np.cumsum(element_sizes)])

    disc = Discretization(
        mesh=mesh,
        form_spec=form_spec,
        basis_cache=basis_cache,
        leaf_indices=leaf_indices,
        element_orders=element_orders,
        element_sizes=element_sizes,
        element_offsets=element_offsets,
    )

    # Group leaves by orders; keep deterministic (sorted) bucket order.
    unique_orders = sorted({(int(o1), int(o2)) for o1, o2 in element_orders})
    for p1, p2 in unique_orders:
        mask = (element_orders[:, 0] == p1) & (element_orders[:, 1] == p2)
        ranks = np.nonzero(mask)[0]
        corners = np.stack(
            [mesh.get_leaf_corners(leaf_indices[r]) for r in ranks]
        )
        batch = ElementBatch(basis_cache.get_basis2d(p1, p2), corners, device)
        n = form_spec.total_size(p1, p2)
        gather = (
            element_offsets[ranks][:, None] + np.arange(n, dtype=np.int64)[None, :]
        )
        disc.buckets.append(
            OrderBucket(orders=(p1, p2), leaf_ranks=ranks, batch=batch, gather=gather)
        )
    return disc


def scatter_bucket_vectors(disc: Discretization, per_bucket: list[np.ndarray]) -> np.ndarray:
    """Assemble per-bucket ``[E, n]`` vectors into the global DoF vector."""
    out = np.zeros(disc.n_dofs, np.float64)
    for bucket, vecs in zip(disc.buckets, per_bucket):
        out[bucket.gather] = np.asarray(vecs)
    return out


def gather_bucket_vectors(disc: Discretization, solution: np.ndarray) -> list[np.ndarray]:
    """Slice the global DoF vector into per-bucket ``[E, n]`` batches."""
    return [np.asarray(solution)[bucket.gather] for bucket in disc.buckets]


def per_leaf(disc: Discretization, per_bucket) -> list:
    """Per-bucket ``[E, ...]`` batches as one list in leaf order."""
    out: list = [None] * disc.n_leaves
    for bucket, arr in zip(disc.buckets, per_bucket):
        for j, rank in enumerate(bucket.leaf_ranks):
            out[int(rank)] = arr[j]
    assert all(item is not None for item in out)
    return out
