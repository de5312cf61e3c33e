"""Minimal VTU (XML unstructured grid) writer for ParaView output.

Role of deal.II DataOut + .pvtu in the reference (e.g.
source/mpi_fluid_solver.cpp:490-579).  Writes bilinear cells with
vertex-valued point data and optional cell data."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# z-order -> VTK node order
_VTK_ORDER = {2: [0, 1, 3, 2], 3: [0, 1, 3, 2, 4, 5, 7, 6]}
_VTK_TYPE = {2: 9, 3: 12}  # QUAD, HEXAHEDRON


def write_vtu(path: str, mesh, point_data: Optional[Dict] = None,
              cell_data: Optional[Dict] = None):
    """point_data: name -> (n_vertices,) or (n_vertices, k) arrays;
    cell_data: name -> (n_cells,)"""
    dim = mesh.dim
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    if dim == 2:
        verts = np.concatenate([verts, np.zeros((len(verts), 1))], axis=1)
    cells = np.asarray(mesh.cells)[:, _VTK_ORDER[dim]]
    n_v, n_c = len(verts), len(cells)
    npc = cells.shape[1]

    def arr2str(a, per_line=6):
        a = np.asarray(a)
        return "\n".join(" ".join(f"{x:.12g}" for x in row)
                         for row in a.reshape(len(a), -1))

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{n_v}" NumberOfCells="{n_c}">\n')
        f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        f.write(arr2str(verts))
        f.write('\n</DataArray>\n</Points>\n<Cells>\n')
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">'
                '\n')
        f.write(arr2str(cells))
        f.write('\n</DataArray>\n<DataArray type="Int32" Name="offsets" '
                'format="ascii">\n')
        f.write(" ".join(str(npc * (i + 1)) for i in range(n_c)))
        f.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(" ".join(str(_VTK_TYPE[dim]) for _ in range(n_c)))
        f.write('\n</DataArray>\n</Cells>\n')
        f.write('<PointData>\n')
        for name, data in (point_data or {}).items():
            data = np.asarray(data)
            nc = 1 if data.ndim == 1 else data.shape[1]
            if nc == 2:  # pad 2D vectors for ParaView
                data = np.concatenate([data, np.zeros((len(data), 1))],
                                      axis=1)
                nc = 3
            f.write(f'<DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{nc}" format="ascii">\n')
            f.write(arr2str(data))
            f.write('\n</DataArray>\n')
        f.write('</PointData>\n<CellData>\n')
        for name, data in (cell_data or {}).items():
            f.write(f'<DataArray type="Float64" Name="{name}" '
                    'format="ascii">\n')
            f.write(" ".join(f"{float(x):.12g}" for x in np.asarray(data)))
            f.write('\n</DataArray>\n')
        f.write('</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')
