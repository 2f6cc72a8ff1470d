"""Legacy-ASCII VTK writer for cell fields (counterpart of
``stormx/io/vtk.py``; reference ``save_vtk`` in
``source_apps/playground/Playground.cpp:66-109``).  For the same mesh and
fields the file is byte-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from stormx_torch.sparse.formats import host

__all__ = ["write_vtk"]

_VTK_CELL_TYPES = {3: 5, 4: 9}  # triangle, quad (2D)
# 3D by node count (unambiguous across the shape catalog, Shape.hpp:559-854):
# tetra, pyramid, wedge/pentahedron, hexahedron.
_VTK_CELL_TYPES_3D = {4: 10, 5: 14, 6: 13, 8: 12}



def _savetxt(f, a, fmt: str) -> None:
    """Write what ``np.savetxt(f, a, fmt=fmt)`` writes, formatting Python
    scalars (``tolist``) instead of NumPy ones: the same text (a NumPy
    scalar formats through the Python float or int it equals), in a
    fraction of the time."""
    a = np.asarray(a)
    if a.dtype.kind == "c":
        np.savetxt(f, a, fmt=fmt)
        return
    if a.ndim == 1:
        lines = [fmt % v for v in a.tolist()]
    else:
        row_fmt = " ".join([fmt] * a.shape[1])
        lines = [row_fmt % tuple(r) for r in a.tolist()]
    if lines:
        f.write("\n".join(lines) + "\n")


def write_vtk(mesh, path: str, cell_fields: dict | None = None) -> None:
    """Write the mesh + named scalar cell fields as legacy VTK.

    Hybrid meshes (``cell_nodes`` padded with −1, per-cell shapes) emit
    variable-length cell records with per-cell VTK types.  Fields may be
    tensors on any device or NumPy arrays; a field with components writes
    its first.
    """
    cell_fields = cell_fields or {}
    cell_nodes = np.asarray(mesh.cell_nodes)
    npc_per_cell = (cell_nodes >= 0).sum(axis=1)
    types_map = _VTK_CELL_TYPES if mesh.dim == 2 else _VTK_CELL_TYPES_3D
    ctypes = np.array([types_map[int(k)] for k in npc_per_cell], dtype=np.int64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write("# Generated by stormx Mesh2VTK\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {mesh.num_nodes} double\n")
        pos = mesh.node_positions
        if mesh.dim == 2:
            pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
        _savetxt(f, pos, "%.17g")
        f.write("\n")
        total = int(npc_per_cell.sum()) + mesh.num_cells
        f.write(f"CELLS {mesh.num_cells} {total}\n")
        f.write("".join(f"{k} " + " ".join(map(str, row[:k])) + "\n"
                        for row, k in zip(cell_nodes.tolist(), npc_per_cell.tolist())))
        f.write("\n")
        f.write(f"CELL_TYPES {mesh.num_cells}\n")
        _savetxt(f, ctypes, "%d")
        f.write("\n")
        if cell_fields:
            f.write(f"CELL_DATA {mesh.num_cells}\n")
            for name, data in cell_fields.items():
                data = host(data)
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                _savetxt(f, data.reshape(mesh.num_cells, -1)[:, 0], "%.17g")
                f.write("\n")
