"""Host-side 2D manifold topology: points, oriented lines, surfaces, duals.

Pure-Python equivalent of the reference C geometry layer
(src/geometry/geoidobject.c, lineobject.c, surfaceobject.c, manifold2d.c).
IDs follow the reference convention: externally 1-based signed integers
(negative = reversed orientation, 0 = invalid), internally 0-based indices.

Topology is consumed once at setup to emit static index maps for the device
kernels, so plain Python objects are fine here; a C++ accelerated version can
be slotted in behind the same interface for very large meshes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_INVALID = -1


@dataclass(frozen=True)
class GeoID:
    """Reference to a geometric object: 0-based index plus orientation."""

    index: int
    reversed: bool = False

    def __bool__(self) -> bool:
        return self.index != _INVALID

    def __neg__(self) -> GeoID:
        return GeoID(self.index, not self.reversed)

    @staticmethod
    def pack(v: int) -> GeoID:
        """From a 1-based signed external id (0 -> invalid)."""
        if v < 0:
            return GeoID(-(v + 1), True)
        if v > 0:
            return GeoID(v - 1, False)
        return GeoID(_INVALID, False)

    def unpack(self) -> int:
        """To a 1-based signed external id."""
        v = self.index + 1
        return -v if self.reversed else v

    def __str__(self) -> str:
        return f"GeoID({self.index}, {int(self.reversed)})"

    @staticmethod
    def coerce(v) -> GeoID:
        if isinstance(v, GeoID):
            return v
        return GeoID.pack(int(v))


@dataclass(frozen=True)
class Line:
    """An oriented line between two point ids."""

    begin: GeoID
    end: GeoID

    def __post_init__(self) -> None:
        object.__setattr__(self, "begin", GeoID.coerce(self.begin))
        object.__setattr__(self, "end", GeoID.coerce(self.end))

    def reversed_line(self) -> Line:
        return Line(self.end, self.begin)


class Surface:
    """A surface bounded by oriented line ids."""

    __slots__ = ("lines",)

    def __init__(self, *ids) -> None:
        self.lines = tuple(GeoID.coerce(i) for i in ids)

    def __getitem__(self, idx) -> GeoID:
        return self.lines[idx]

    def __len__(self) -> int:
        return len(self.lines)

    def __iter__(self):
        return iter(self.lines)

    def __eq__(self, other) -> bool:
        return isinstance(other, Surface) and self.lines == other.lines

    def __repr__(self) -> str:
        return "Surface(" + ", ".join(str(i.unpack()) for i in self.lines) + ")"


class Manifold2D:
    """Two-dimensional manifold: lines over points, surfaces over lines."""

    def __init__(
        self,
        n_points: int,
        lines: list[Line],
        surfaces: list[Surface],
    ) -> None:
        self._n_points = int(n_points)
        self._lines = lines
        self._surfaces = surfaces

    @property
    def dimension(self) -> int:
        return 2

    @property
    def n_points(self) -> int:
        return self._n_points

    @property
    def n_lines(self) -> int:
        return len(self._lines)

    @property
    def n_surfaces(self) -> int:
        return len(self._surfaces)

    def get_line(self, index, /) -> Line:
        """Line by 1-based signed id or GeoID (negative = reversed)."""
        gid = GeoID.coerce(index)
        if gid.index < 0 or gid.index >= len(self._lines):
            raise IndexError(f"Line id {gid} out of range.")
        ln = self._lines[gid.index]
        return ln.reversed_line() if gid.reversed else ln

    def get_surface(self, index, /) -> Surface:
        """Surface by 1-based signed id or GeoID (negative = flipped lines)."""
        gid = GeoID.coerce(index)
        if gid.index < 0 or gid.index >= len(self._surfaces):
            raise IndexError(f"Surface id {gid} out of range.")
        s = self._surfaces[gid.index]
        if gid.reversed:
            return Surface(*(-line_id for line_id in s.lines))
        return s

    @classmethod
    def from_irregular(
        cls,
        n_points: int,
        line_connectivity,
        surface_connectivity,
    ) -> Manifold2D:
        """Build from per-surface line lists of possibly varying length."""
        lns = np.asarray(line_connectivity, np.int64)
        if lns.ndim != 2 or lns.shape[1] != 2:
            raise ValueError("Line connectivity must be an (N, 2) array.")
        lines: list[Line] = []
        for begin, end in lns:
            b = GeoID.pack(int(begin))
            e = GeoID.pack(int(end))
            if b.index >= n_points or e.index >= n_points:
                raise ValueError(
                    f"Line ({begin}, {end}) refers to points beyond {n_points}."
                )
            lines.append(Line(b, e))

        surfaces: list[Surface] = []
        for i_surf, surf in enumerate(surface_connectivity):
            ids = [GeoID.pack(int(v)) for v in np.asarray(surf, np.int64)]
            # Validate the loop is connected with consistent orientation.
            for j, gid in enumerate(ids):
                if gid.index < 0 or gid.index >= len(lines):
                    raise ValueError(
                        f"Surface {i_surf} refers to invalid line {gid.unpack()}."
                    )
                prev = ids[j - 1]
                ln_prev = lines[prev.index]
                end_prev = ln_prev.begin if prev.reversed else ln_prev.end
                ln_cur = lines[gid.index]
                begin_cur = ln_cur.end if gid.reversed else ln_cur.begin
                if end_prev.index != begin_cur.index:
                    raise ValueError(
                        f"Surface {i_surf}: line {j} does not begin (point"
                        f" {begin_cur.index}) where line {j - 1} ends (point"
                        f" {end_prev.index})."
                    )
            surfaces.append(Surface(*ids))

        return cls(n_points, lines, surfaces)

    @classmethod
    def from_regular(
        cls,
        n_points: int,
        line_connectivity,
        surface_connectivity,
    ) -> Manifold2D:
        """Build when all surfaces have the same number of lines."""
        surf = np.asarray(surface_connectivity, np.int64)
        if surf.ndim != 2:
            raise ValueError("Surface connectivity must be a 2D array.")
        return cls.from_irregular(n_points, line_connectivity, surf)

    def compute_dual(self) -> Manifold2D:
        """The dual manifold (mirrors manifold2d.c:280-390).

        Dual line of primal line i: *end* point = surface containing line i
        with positive orientation, *begin* point = surface containing it with
        negative orientation; missing side -> invalid id (a boundary line).

        Dual surface of primal point p: all primal lines touching p, in line
        index order, positively oriented if the line begins at p.
        """
        n_lines = self.n_lines
        begins = [GeoID(_INVALID) for _ in range(n_lines)]
        ends = [GeoID(_INVALID) for _ in range(n_lines)]
        for i_surf, s in enumerate(self._surfaces):
            for gid in s.lines:
                if gid.reversed:
                    if begins[gid.index]:
                        raise ValueError(
                            f"Line {gid.index} appears twice with negative"
                            " orientation; manifold is invalid."
                        )
                    begins[gid.index] = GeoID(i_surf)
                else:
                    if ends[gid.index]:
                        raise ValueError(
                            f"Line {gid.index} appears twice with positive"
                            " orientation; manifold is invalid."
                        )
                    ends[gid.index] = GeoID(i_surf)
        dual_lines = [Line(b, e) for b, e in zip(begins, ends)]

        per_point: list[list[GeoID]] = [[] for _ in range(self._n_points)]
        for i_ln, ln in enumerate(self._lines):
            if ln.begin.index >= 0:
                per_point[ln.begin.index].append(GeoID(i_ln, False))
            if ln.end.index >= 0:
                per_point[ln.end.index].append(GeoID(i_ln, True))
        dual_surfaces = [Surface(*ids) for ids in per_point]

        return Manifold2D(self.n_surfaces, dual_lines, dual_surfaces)

    def __repr__(self) -> str:
        return (
            f"Manifold2D(points={self.n_points}, lines={self.n_lines},"
            f" surfaces={self.n_surfaces})"
        )
