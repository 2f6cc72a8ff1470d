"""Structured mesh builders (counterpart of ``stormx/mesh/structured.py``):
triangulated rectangles (2-D) and Kuhn-subdivided boxes (3-D tets, whose
6-tet-per-cube decomposition is face-compatible across neighboring cubes)."""

from __future__ import annotations

from itertools import permutations

import numpy as np

from stormx_torch.mesh.unstructured import UnstructuredMesh, build_mesh

__all__ = ["structured_tri_rect", "structured_tet_box"]


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


def structured_tet_box(
    nx: int, ny: int, nz: int, lengths=(1.0, 1.0, 1.0)
) -> UnstructuredMesh:
    """[0,L]³ box split into 6·nx·ny·nz tetrahedra (Kuhn subdivision).

    Each unit cube is cut along node-order chains v₀ → v₀+e_{π(0)} → … →
    v₀+e₀+e₁+e₂ over all 6 axis permutations π — the standard Freudenthal/
    Kuhn triangulation, which matches faces across neighboring cubes.
    """
    dims = np.array([nx, ny, nz])
    xs = [np.linspace(0, lengths[d], dims[d] + 1) for d in range(3)]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    e = np.eye(3, dtype=np.int64)
    cells = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                v0 = np.array([i, j, k])
                for pi in permutations(range(3)):
                    c0 = v0
                    c1 = c0 + e[pi[0]]
                    c2 = c1 + e[pi[1]]
                    c3 = c2 + e[pi[2]]
                    cells.append([nid(*c0), nid(*c1), nid(*c2), nid(*c3)])
    return build_mesh(nodes, np.asarray(cells))
