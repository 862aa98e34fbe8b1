"""Solution output grids (VTK Lagrange-quadrilateral layout).

The reference emits PyVista ``UnstructuredGrid`` objects; this environment
has no pyvista, so :class:`ReconstructedGrid` carries the same data (points,
VTK Lagrange cell connectivity, per-point form values, per-cell orders) and
can convert to pyvista when available.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import numpy.typing as npt

VTK_LAGRANGE_QUADRILATERAL = 70


@dataclass
class ReconstructedGrid:
    """Unstructured grid of VTK Lagrange quadrilateral cells."""

    points: npt.NDArray[np.float64]  # (n_points, 3)
    cells: npt.NDArray[np.int64]  # VTK cell array: [n, i0...in-1, n, ...]
    cell_types: npt.NDArray[np.uint8]
    point_data: dict[str, npt.NDArray[np.float64]] = field(default_factory=dict)
    cell_data: dict[str, npt.NDArray] = field(default_factory=dict)
    field_data: dict[str, npt.NDArray] = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return len(self.cell_types)

    def to_pyvista(self):
        """Convert to a pyvista.UnstructuredGrid (requires pyvista)."""
        import pyvista as pv

        grid = pv.UnstructuredGrid(self.cells, self.cell_types, self.points)
        for k, v in self.point_data.items():
            grid.point_data[k] = v
        for k, v in self.cell_data.items():
            grid.cell_data[k] = v
        for k, v in self.field_data.items():
            grid.field_data[k] = v
        return grid

    def save_vtu(self, path) -> None:
        """Write the grid as a VTK XML UnstructuredGrid (.vtu) file.

        Plain-ascii writer with no external dependencies; the output loads
        in ParaView/VTK (Lagrange quadrilateral cells need VTK >= 8.2).
        """
        import io

        def arr_to_text(a):
            a = np.asarray(a)
            if a.ndim == 1:
                return " ".join(repr(float(v)) if a.dtype.kind == "f" else str(int(v)) for v in a)
            return "\n".join(
                " ".join(repr(float(v)) if a.dtype.kind == "f" else str(int(v)) for v in row)
                for row in a
            )

        # Unpack the VTK cell array [n, i0..in-1, n, ...] into conn/offsets.
        conn: list[int] = []
        offsets: list[int] = []
        i = 0
        cells = np.asarray(self.cells)
        while i < cells.size:
            n = int(cells[i])
            conn.extend(int(v) for v in cells[i + 1 : i + 1 + n])
            offsets.append(len(conn))
            i += 1 + n

        buf = io.StringIO()
        w = buf.write
        w('<?xml version="1.0"?>\n')
        w('<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian">\n')
        w("<UnstructuredGrid>\n")
        w(
            f'<Piece NumberOfPoints="{len(self.points)}"'
            f' NumberOfCells="{self.n_cells}">\n'
        )
        w("<Points>\n")
        w('<DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        w(arr_to_text(self.points))
        w("\n</DataArray>\n</Points>\n")
        w("<Cells>\n")
        w('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        w(arr_to_text(np.asarray(conn, np.int64)))
        w("\n</DataArray>\n")
        w('<DataArray type="Int64" Name="offsets" format="ascii">\n')
        w(arr_to_text(np.asarray(offsets, np.int64)))
        w("\n</DataArray>\n")
        w('<DataArray type="UInt8" Name="types" format="ascii">\n')
        w(arr_to_text(self.cell_types))
        w("\n</DataArray>\n</Cells>\n")

        def data_section(tag, data):
            w(f"<{tag}>\n")
            for name, vals in data.items():
                vals = np.asarray(vals)
                ncomp = 1 if vals.ndim == 1 else vals.shape[1]
                dtype = "Float64" if vals.dtype.kind == "f" else "Int64"
                w(
                    f'<DataArray type="{dtype}" Name="{name}"'
                    f' NumberOfComponents="{ncomp}" format="ascii">\n'
                )
                w(arr_to_text(vals.astype(np.float64 if dtype == "Float64" else np.int64)))
                w("\n</DataArray>\n")
            w(f"</{tag}>\n")

        data_section("PointData", self.point_data)
        data_section("CellData", self.cell_data)
        w("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
        with open(path, "w") as f:
            f.write(buf.getvalue())
