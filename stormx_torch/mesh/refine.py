"""Uniform (red) mesh refinement — host-side, fully vectorized
(counterpart of ``stormx/mesh/refine.py``, the same NumPy passes, so both
packages give identical meshes).

The reference has no refinement: its largest checked-in problem is the
79,672-triangle "step" mesh and its serial loops cap there
(``Playground.cpp:176-210``).  ``refine(step)`` × 2 yields a
1,274,752-cell unstructured problem with the same geometry and boundary
labels.

Schemes (standard red refinement — every cell splits self-similarly, so
mesh quality is preserved under repeated refinement):

* triangle → 4 children via the 3 edge midpoints;
* tetrahedron → 8 children via the 6 edge midpoints (Bey's scheme: 4
  corner tets + the inner octahedron cut along the m02–m13 diagonal).

Boundary faces inherit their parent's label (child faces of a labeled
boundary edge/triangle carry the same label), so FVM boundary-condition
wiring survives refinement unchanged.
"""

from __future__ import annotations

import numpy as np

from stormx_torch.mesh import shapes
from stormx_torch.mesh.unstructured import UnstructuredMesh, build_mesh

__all__ = ["refine"]


def _edge_ids(pairs: np.ndarray, num_nodes: int):
    """Unique-edge ids for (m, 2) node pairs (any order) → (uniq (e,2) sorted
    pairs, inverse (m,)).  Encodes each sorted pair as one int64 key so the
    unique runs on a 1-D array (fast path; ``np.unique(axis=0)`` sorts void
    views and is several times slower at 4M+ rows)."""
    lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    keys = lo * np.int64(num_nodes) + hi
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    uniq = np.stack([uniq_keys // num_nodes, uniq_keys % num_nodes], axis=1)
    return uniq, inv


def refine(mesh: UnstructuredMesh, times: int = 1) -> UnstructuredMesh:
    """Return the uniformly red-refined mesh (``times`` rounds).

    Single-shape triangle (2-D) or tetrahedron (3-D) meshes only; each round
    multiplies cell count by 4 (tri) or 8 (tet).
    """
    for _ in range(times):
        mesh = _refine_once(mesh)
    return mesh


def _refine_once(mesh: UnstructuredMesh) -> UnstructuredMesh:
    if mesh.cell_shape == shapes.TRIANGLE:
        return _refine_simplex(mesh, 3)
    if mesh.cell_shape == shapes.TETRAHEDRON:
        return _refine_simplex(mesh, 4)
    raise NotImplementedError(
        "refine() supports single-shape triangle/tetrahedron meshes; got "
        f"cell_shape={mesh.cell_shape}"
    )


def _refine_simplex(mesh: UnstructuredMesh, nv: int) -> UnstructuredMesh:
    cn = np.asarray(mesh.cell_nodes[:, :nv], dtype=np.int64)
    nn = mesh.num_nodes
    # Local edge list of the simplex, in (lo, hi) vertex-index order.
    ledges = [(i, j) for i in range(nv) for j in range(i + 1, nv)]
    pairs = np.concatenate([cn[:, [i, j]] for (i, j) in ledges], axis=0)
    uniq, inv = _edge_ids(pairs, nn)
    mid_of = inv.reshape(len(ledges), -1)  # [local_edge, cell] → edge id
    mid_pos = mesh.node_positions[uniq].mean(axis=1)
    positions = np.concatenate([mesh.node_positions, mid_pos], axis=0)
    # Global node id of each cell's edge midpoint, per local edge.
    m = {e: nn + mid_of[k] for k, e in enumerate(ledges)}
    v = [cn[:, i] for i in range(nv)]
    if nv == 3:
        m01, m12, m02 = m[(0, 1)], m[(1, 2)], m[(0, 2)]
        children = [
            (v[0], m01, m02),
            (m01, v[1], m12),
            (m02, m12, v[2]),
            (m01, m12, m02),
        ]
    else:
        m01, m02, m03 = m[(0, 1)], m[(0, 2)], m[(0, 3)]
        m12, m13, m23 = m[(1, 2)], m[(1, 3)], m[(2, 3)]
        children = [
            (v[0], m01, m02, m03),
            (m01, v[1], m12, m13),
            (m02, m12, v[2], m23),
            (m03, m13, m23, v[3]),
            # Inner octahedron, Bey's m02–m13 diagonal.
            (m01, m02, m03, m13),
            (m01, m02, m12, m13),
            (m02, m03, m13, m23),
            (m02, m12, m13, m23),
        ]
    # Interleave children per parent (cell c's children are 4c..4c+3 / 8c..)
    # so locality-improving parent orders survive refinement.
    new_cells = np.stack(
        [np.stack(ch, axis=1) for ch in children], axis=1
    ).reshape(-1, nv)

    ckeys = uniq[:, 0] * np.int64(nn) + uniq[:, 1]  # sorted unique edge keys
    bfl = _child_boundary_labels(mesh, nn, ckeys)
    return build_mesh(
        positions,
        new_cells,
        cell_shape=mesh.cell_shape,
        boundary_face_labels=bfl,
    )


def _child_boundary_labels(mesh: UnstructuredMesh, nn: int, ckeys) -> dict:
    """Map each refined boundary face (sorted node tuple) → parent label.

    Midpoint node ids come from ``ckeys``, the sorted unique CELL-edge key
    table that numbered the midpoints in :func:`_refine_simplex` (every
    boundary face's edges are cell edges, so the lookup always hits).
    """
    bidx = mesh.boundary_faces()
    if len(bidx) == 0:
        return {}
    labels = mesh.face_labels[bidx]
    fn = np.asarray(mesh.face_nodes[bidx], dtype=np.int64)

    def edge_mid(a, b):
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        pos = np.searchsorted(ckeys, lo * np.int64(nn) + hi)
        return nn + pos

    out: dict = {}
    if fn.shape[1] == 2:  # 2-D: boundary faces are segments → 2 children
        mid = edge_mid(fn[:, 0], fn[:, 1])
        for a, b in ((fn[:, 0], mid), (mid, fn[:, 1])):
            keys = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
            for row, lab in zip(keys, labels):
                out[tuple(row)] = int(lab)
        return out
    # 3-D: boundary faces are triangles → 4 children via edge midpoints.
    u, vv, w = fn[:, 0], fn[:, 1], fn[:, 2]
    muv, mvw, muw = edge_mid(u, vv), edge_mid(vv, w), edge_mid(u, w)
    for tri in ((u, muv, muw), (muv, vv, mvw), (muw, mvw, w), (muv, mvw, muw)):
        keys = np.sort(np.stack(tri, axis=1), axis=1)
        for row, lab in zip(keys, labels):
            out[tuple(row)] = int(lab)
    return out
