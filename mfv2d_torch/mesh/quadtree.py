"""Hierarchical quadrilateral mesh (quadtree of elements).

Host-side equivalent of the reference C ``Mesh`` type
(src/geometry/mesh.c:8-199): a flat array of elements, each either a leaf
(orders + corners) or a node with four children (bottom-left, bottom-right,
top-right, top-left).  Splitting bisects the corner quad through edge
midpoints and the centroid.  Topology here is only traversed at setup time to
emit static index maps for the device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import numpy.typing as npt

from mfv2d_torch.mesh.manifold import Manifold2D


@dataclass
class _Element:
    parent: int | None
    corners: npt.NDArray[np.float64]  # (4, 2)
    orders: tuple[int, int] | None  # None for non-leaf nodes
    children: tuple[int, int, int, int] | None = None

    @property
    def is_leaf(self) -> bool:
        return self.children is None


class Mesh:
    """Mesh with primal/dual topology, element corners, orders, boundary."""

    def __init__(
        self,
        primal: Manifold2D,
        dual: Manifold2D,
        corners,
        orders,
        boundary,
    ) -> None:
        corners = np.asarray(corners, np.float64)
        orders = np.asarray(orders)
        if corners.ndim != 3 or corners.shape[1:] != (4, 2):
            raise ValueError("Corners must be an (N, 4, 2) array.")
        if orders.shape != (corners.shape[0], 2):
            raise ValueError("Orders must be an (N, 2) array.")
        if corners.shape[0] != primal.n_surfaces:
            raise ValueError("Need corners for every primal surface.")
        self.primal = primal
        self.dual = dual
        self.boundary_indices = np.asarray(boundary, np.uint32)
        self._elements: list[_Element] = [
            _Element(None, corners[i].copy(), (int(orders[i, 0]), int(orders[i, 1])))
            for i in range(corners.shape[0])
        ]

    # -- basic queries ---------------------------------------------------

    @property
    def element_count(self) -> int:
        return len(self._elements)

    @property
    def leaf_count(self) -> int:
        return sum(1 for e in self._elements if e.is_leaf)

    def get_element_parent(self, idx, /) -> int | None:
        return self._elements[int(idx)].parent

    def get_element_children(self, idx, /) -> tuple[int, int, int, int] | None:
        return self._elements[int(idx)].children

    def get_leaf_corners(self, idx, /) -> npt.NDArray[np.float64]:
        e = self._elements[int(idx)]
        if not e.is_leaf:
            raise ValueError(f"Element {idx} is not a leaf.")
        return e.corners.copy()

    def get_leaf_orders(self, idx, /) -> tuple[int, int]:
        e = self._elements[int(idx)]
        if not e.is_leaf:
            raise ValueError(f"Element {idx} is not a leaf.")
        assert e.orders is not None
        return e.orders

    def set_leaf_orders(self, idx, /, order_1: int, order_2: int) -> None:
        e = self._elements[int(idx)]
        if not e.is_leaf:
            raise ValueError(f"Element {idx} is not a leaf.")
        if order_1 < 1 or order_2 < 1:
            raise ValueError("Orders must be at least 1.")
        e.orders = (int(order_1), int(order_2))

    def _leaf_rank_map(self) -> dict[int, int]:
        """element index -> leaf rank, cached until the element list changes.

        get_leaf_index is called O(N) times per constraint assembly; a
        linear scan per call made continuity assembly O(N^2) (12 s at the
        64x64 BASELINE mesh before caching).
        """
        cache = getattr(self, "_leaf_cache", None)
        if cache is not None and cache[0] == len(self._elements):
            return cache[1]
        ranks = {}
        for i, e in enumerate(self._elements):
            if e.is_leaf:
                ranks[i] = len(ranks)
        self._leaf_cache = (
            len(self._elements),
            ranks,
            np.fromiter(ranks, np.uintc),
        )
        return ranks

    def get_leaf_indices(self) -> npt.NDArray[np.uintc]:
        self._leaf_rank_map()
        return self._leaf_cache[2].copy()

    def get_leaf_index(self, idx, /) -> int:
        """Rank of the leaf element among all leaves (array order)."""
        rank = self._leaf_rank_map().get(int(idx))
        if rank is None:
            raise ValueError(f"Element {idx} is not a leaf.")
        return rank

    def find_leaf_by_index(self, idx, /) -> int:
        """Element index of the leaf with the given leaf rank."""
        ranks = self._leaf_rank_map()
        want = int(idx)
        if want < 0 or want >= len(ranks):
            raise IndexError(f"No leaf with index {idx}.")
        return int(self._leaf_cache[2][want])

    def get_element_depth(self, idx, /) -> int:
        depth = 0
        p = self._elements[int(idx)].parent
        while p is not None:
            depth += 1
            p = self._elements[p].parent
        return depth

    # -- refinement ------------------------------------------------------

    def split_element(
        self,
        idx,
        /,
        orders_bottom_left,
        orders_bottom_right,
        orders_top_right,
        orders_top_left,
    ) -> None:
        """Split a leaf into 4 children through edge midpoints + centroid."""
        i = int(idx)
        e = self._elements[i]
        if not e.is_leaf:
            raise ValueError(f"Element {idx} is not a leaf.")
        c = e.corners
        m01 = (c[0] + c[1]) / 2
        m12 = (c[1] + c[2]) / 2
        m23 = (c[2] + c[3]) / 2
        m30 = (c[3] + c[0]) / 2
        ctr = c.mean(axis=0)
        child_corners = (
            np.stack([c[0], m01, ctr, m30]),
            np.stack([m01, c[1], m12, ctr]),
            np.stack([ctr, m12, c[2], m23]),
            np.stack([m30, ctr, m23, c[3]]),
        )
        child_orders = (
            orders_bottom_left,
            orders_bottom_right,
            orders_top_right,
            orders_top_left,
        )
        base = len(self._elements)
        for cc, co in zip(child_corners, child_orders):
            o1, o2 = int(co[0]), int(co[1])
            if o1 < 1 or o2 < 1:
                raise ValueError("Child orders must be at least 1.")
            self._elements.append(_Element(i, cc, (o1, o2)))
        e.children = (base, base + 1, base + 2, base + 3)
        e.orders = None

    def uniform_p_change(self, dp_1: int, dp_2: int, /) -> None:
        for e in self._elements:
            if e.is_leaf:
                assert e.orders is not None
                o1 = e.orders[0] + dp_1
                o2 = e.orders[1] + dp_2
                if o1 < 1 or o2 < 1:
                    raise ValueError(
                        "Order change would result in an order below 1."
                    )
                e.orders = (o1, o2)

    def split_depth_first(self, maximum_depth: int, predicate, *args, **kwargs):
        """Split leaves by predicate, descending into new children first."""
        out = self.copy()
        stack = [i for i, e in enumerate(out._elements) if e.is_leaf]
        stack.reverse()
        while stack:
            i = stack.pop()
            if out.get_element_depth(i) >= maximum_depth:
                continue
            res = predicate(out, i, *args, **kwargs)
            if res is None:
                continue
            out.split_element(i, *res)
            children = out._elements[i].children
            assert children is not None
            stack.extend(reversed(children))
        return out

    def split_breath_first(self, maximum_depth: int, predicate, *args, **kwargs):
        """Split leaves by predicate, one full level at a time."""
        from collections import deque

        out = self.copy()
        queue = deque(i for i, e in enumerate(out._elements) if e.is_leaf)
        while queue:
            i = queue.popleft()
            if out.get_element_depth(i) >= maximum_depth:
                continue
            res = predicate(out, i, *args, **kwargs)
            if res is None:
                continue
            out.split_element(i, *res)
            children = out._elements[i].children
            assert children is not None
            queue.extend(children)
        return out

    def copy(self) -> Mesh:
        out = Mesh.__new__(Mesh)
        out.primal = self.primal
        out.dual = self.dual
        out.boundary_indices = self.boundary_indices.copy()
        out._elements = [
            _Element(e.parent, e.corners.copy(), e.orders, e.children)
            for e in self._elements
        ]
        return out
