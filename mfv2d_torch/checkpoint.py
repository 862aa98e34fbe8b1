"""Checkpoint and resume of meshes, time marches and steady solves.

A checkpoint is one ``.npz`` file: the full mesh (primal and dual topology,
the element quadtree with corners and orders), the solution and multiplier
vectors, and the trapezoidal carry of a march or the iteration count of a
steady solve.  The keys are the JAX package's (``mfv2d_tpu/checkpoint.py``),
so a file written by either package loads in the other.  A split element
stores the order ``-1``; the arrays are NumPy on the host.

Steady and march files are written to ``<path>.tmp.npz`` and moved over
``path`` with ``os.replace``, so a crash while writing never corrupts the
previous good checkpoint.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from mfv2d_torch.mesh.manifold import GeoID, Line, Manifold2D, Surface
from mfv2d_torch.mesh.quadtree import Mesh, _Element


@dataclass(frozen=True)
class CheckpointSettings:
    """Periodic checkpointing of a solve.

    Pass to :func:`mfv2d_torch.solve_system_2d`.  A march writes its state to
    ``path`` every ``every`` completed steps and at its last step; a steady
    Picard solve every ``every`` iterations and at its end.  Set
    ``resume_from`` to a previous checkpoint to continue: a march skips the
    steps already taken and returns grids of the resumed part only; a steady
    solve starts from the saved iterate, and a missing steady file means a
    first attempt.
    """

    path: str
    every: int = 10
    resume_from: str | None = None


def manifold_to_arrays(m: Manifold2D) -> dict:
    """Serialize a manifold to flat integer arrays (1-based signed ids)."""
    lines = np.array(
        [(ln.begin.unpack(), ln.end.unpack()) for ln in m._lines], np.int64
    ).reshape(-1, 2)
    surf_flat: list[int] = []
    surf_offsets = [0]
    for s in m._surfaces:
        surf_flat.extend(g.unpack() for g in s.lines)
        surf_offsets.append(len(surf_flat))
    return {
        "n_points": np.int64(m.n_points),
        "lines": lines,
        "surf_flat": np.asarray(surf_flat, np.int64),
        "surf_offsets": np.asarray(surf_offsets, np.int64),
    }


def manifold_from_arrays(d: dict, prefix: str = "") -> Manifold2D:
    """The manifold that :func:`manifold_to_arrays` wrote under ``prefix``."""
    lines = [
        Line(GeoID.pack(int(b)), GeoID.pack(int(e))) for b, e in d[prefix + "lines"]
    ]
    offsets = d[prefix + "surf_offsets"]
    flat = d[prefix + "surf_flat"]
    surfaces = [
        Surface(*(int(v) for v in flat[a:b])) for a, b in zip(offsets[:-1], offsets[1:])
    ]
    return Manifold2D(int(d[prefix + "n_points"]), lines, surfaces)


def mesh_to_arrays(mesh: Mesh) -> dict:
    """Serialize the mesh: topology plus the full element quadtree."""
    out = {}
    for k, v in manifold_to_arrays(mesh.primal).items():
        out["primal_" + k] = v
    for k, v in manifold_to_arrays(mesh.dual).items():
        out["dual_" + k] = v
    out["boundary"] = np.asarray(mesh.boundary_indices, np.int64)
    n = mesh.element_count
    parents = np.full(n, -1, np.int64)
    orders = np.full((n, 2), -1, np.int64)
    children = np.full((n, 4), -1, np.int64)
    corners = np.zeros((n, 4, 2))
    for i, e in enumerate(mesh._elements):
        if e.parent is not None:
            parents[i] = e.parent
        if e.orders is not None:
            orders[i] = e.orders
        if e.children is not None:
            children[i] = e.children
        corners[i] = e.corners
    out["parents"] = parents
    out["orders"] = orders
    out["children"] = children
    out["corners"] = corners
    return out


def mesh_from_arrays(d: dict) -> Mesh:
    """The mesh that :func:`mesh_to_arrays` serialized."""
    mesh = Mesh.__new__(Mesh)
    mesh.primal = manifold_from_arrays(d, "primal_")
    mesh.dual = manifold_from_arrays(d, "dual_")
    mesh.boundary_indices = np.asarray(d["boundary"], np.uint32)
    parents, orders, children, corners = (
        d["parents"], d["orders"], d["children"], d["corners"]
    )
    mesh._elements = [
        _Element(
            parent=None if parents[i] < 0 else int(parents[i]),
            corners=np.array(corners[i], np.float64),
            orders=None if orders[i, 0] < 0 else (int(orders[i, 0]), int(orders[i, 1])),
            children=None if children[i, 0] < 0 else tuple(int(c) for c in children[i]),
        )
        for i in range(parents.shape[0])
    ]
    return mesh


def _save_atomic(path, arrays: dict) -> None:
    # np.savez appends ".npz" to a name without it, so the temporary name
    # ends in it already.
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, str(path))


def save_mesh(path, mesh: Mesh) -> None:
    """Save a mesh alone."""
    np.savez(path, **mesh_to_arrays(mesh))


def load_mesh(path) -> Mesh:
    with np.load(path) as d:
        return mesh_from_arrays(dict(d))


def save_march_state(
    path,
    mesh: Mesh,
    solution: np.ndarray,
    lagrange: np.ndarray,
    old_carry: np.ndarray,
    carry_term: np.ndarray,
    time_index: int,
    dt: float,
) -> None:
    """Checkpoint a time march after ``time_index`` completed steps."""
    arrays = mesh_to_arrays(mesh)
    arrays.update(
        solution=np.asarray(solution),
        lagrange=np.asarray(lagrange),
        old_carry=np.asarray(old_carry),
        carry_term=np.asarray(carry_term),
        time_index=np.int64(time_index),
        dt=np.float64(dt),
    )
    _save_atomic(path, arrays)


def load_march_state(path) -> dict:
    """Load a march checkpoint: the mesh plus the state vectors."""
    with np.load(path) as d:
        d = dict(d)
    return {
        "mesh": mesh_from_arrays(d),
        "solution": d["solution"],
        "lagrange": d["lagrange"],
        "old_carry": d["old_carry"],
        "carry_term": d["carry_term"],
        "time_index": int(d["time_index"]),
        "dt": float(d["dt"]),
    }


def save_steady_state(
    path,
    solution: np.ndarray,
    lagrange: np.ndarray,
    fine_scales: np.ndarray | None,
    iteration: int,
    elapsed: float,
) -> None:
    """Checkpoint a steady Picard solve after ``iteration`` iterations.

    ``fine_scales`` carries the VMS unresolved scales, the other iterate
    besides the solution; ``elapsed`` sums the wall time over resumed
    attempts.
    """
    _save_atomic(
        path,
        {
            "steady": np.int64(1),
            "solution": np.asarray(solution),
            "lagrange": np.asarray(lagrange),
            "fine_scales": (
                np.zeros(0) if fine_scales is None else np.asarray(fine_scales)
            ),
            "has_fine": np.int64(fine_scales is not None),
            "iteration": np.int64(iteration),
            "elapsed": np.float64(elapsed),
        },
    )


def load_steady_state(path) -> dict:
    """Load a steady-solve checkpoint written by :func:`save_steady_state`."""
    with np.load(path) as d:
        d = dict(d)
    if "steady" not in d:
        raise ValueError(f"{path} is not a steady-solve checkpoint.")
    return {
        "solution": d["solution"],
        "lagrange": d["lagrange"],
        "fine_scales": d["fine_scales"] if int(d["has_fine"]) else None,
        "iteration": int(d["iteration"]),
        "elapsed": float(d["elapsed"]),
    }
