"""Carrying state between the JAX package and the port.

The solver has no trained weights: its state is the mesh corners, the NumPy
basis tables and the DoF and multiplier vectors, which both packages hold as
NumPy arrays in the same global layout (solver/discretization.py).  The one
device-side object the packages exchange is the per-element geometry.  A
refined mesh crosses as NumPy arrays of its split tree, corners and orders.
"""

from __future__ import annotations

import numpy as np
import torch

from mfv2d_torch.evaluation import check_device
from mfv2d_torch.mesh.quadtree import Mesh, _Element
from mfv2d_torch.ops.geometry import JacobianTerms


def jacobian_terms_from_numpy(j00, j01, j10, j11, det, device="cuda") -> JacobianTerms:
    """The port's ``JacobianTerms`` from NumPy arrays of the same terms.

    Each array is copied into a contiguous tensor of its own dtype on
    ``device``, the CUDA device unless the caller asks for ``"cpu"``.
    """
    device = check_device(device)
    return JacobianTerms(
        *(
            torch.tensor(np.asarray(v), device=device)
            for v in (j00, j01, j10, j11, det)
        )
    )


def mesh_arrays(mesh) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The split tree, corners and orders of a (refined) quadtree mesh.

    Works on any mesh with the quadtree's public queries (the port's or the
    JAX package's).  Returns ``children`` ``[N, 4]`` (element indices, -1 for
    a leaf), ``corners`` ``[N, 4, 2]`` and ``orders`` ``[N, 2]`` (0 for an
    element that was split).  A split element's corners are its children's
    outer corners.
    """
    n = mesh.element_count
    children = np.full((n, 4), -1, np.int64)
    corners = np.zeros((n, 4, 2))
    orders = np.zeros((n, 2), np.int64)
    # Children always come after their parent, so walk from the last element.
    for i in reversed(range(n)):
        kids = mesh.get_element_children(i)
        if kids is None:
            corners[i] = mesh.get_leaf_corners(i)
            orders[i] = mesh.get_leaf_orders(i)
        else:
            children[i] = kids
            corners[i] = [corners[int(k), j] for j, k in enumerate(kids)]
    return children, corners, orders


def mesh_from_arrays(root: Mesh, children, corners, orders) -> Mesh:
    """The port's ``Mesh`` of a refined mesh given as NumPy arrays.

    ``root`` is the port's unrefined mesh the refinement started from: it
    gives the primal and dual topology and the boundary.  ``children``,
    ``corners`` and ``orders`` are as :func:`mesh_arrays` returns them; the
    first ``root.element_count`` elements must be the root's own.
    """
    children = np.asarray(children, np.int64)
    corners = np.asarray(corners, np.float64)
    orders = np.asarray(orders, np.int64)
    n = children.shape[0]
    if corners.shape != (n, 4, 2) or orders.shape != (n, 2) or children.shape != (n, 4):
        raise ValueError("children, corners and orders must be [N, 4], [N, 4, 2], [N, 2].")
    n_root = root.element_count
    if n < n_root or any(root.get_element_parent(i) is not None for i in range(n_root)):
        raise ValueError("The root mesh must be unrefined and no larger than the tree.")
    root_corners = np.stack([root.get_leaf_corners(i) for i in range(n_root)])
    if not np.array_equal(root_corners, corners[:n_root]):
        raise ValueError("The tree's first elements are not the root mesh's.")
    parents: list[int | None] = [None] * n
    for i in range(n):
        for k in children[i]:
            if k >= 0:
                if k <= i or parents[k] is not None:
                    raise ValueError(f"Element {k} is not a proper child of {i}.")
                parents[k] = i
    if any(p is None for p in parents[n_root:]):
        raise ValueError("Every element past the root's must have a parent.")
    mesh = root.copy()
    mesh._elements = [
        _Element(
            parents[i],
            corners[i].copy(),
            None if children[i, 0] >= 0 else (int(orders[i, 0]), int(orders[i, 1])),
            tuple(int(k) for k in children[i]) if children[i, 0] >= 0 else None,
        )
        for i in range(n)
    ]
    return mesh
