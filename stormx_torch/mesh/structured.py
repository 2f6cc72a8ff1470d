"""Structured mesh builders (counterpart of ``structured_tri_rect`` in
``stormx/mesh/structured.py``)."""

from __future__ import annotations

import numpy as np

from stormx_torch.mesh.unstructured import UnstructuredMesh, build_mesh

__all__ = ["structured_tri_rect"]


def structured_tri_rect(nx: int, ny: int, lengths=(1.0, 1.0)) -> UnstructuredMesh:
    """[0,Lx]×[0,Ly] split into 2·nx·ny CCW triangles."""
    xs = np.linspace(0, lengths[0], nx + 1)
    ys = np.linspace(0, lengths[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    cells = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)
            cells.append([a, b, c])
            cells.append([a, c, d])
    return build_mesh(nodes, np.asarray(cells))
