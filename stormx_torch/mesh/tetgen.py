"""TetGen / Triangle mesh reader (counterpart of ``stormx/mesh/tetgen.py``).

Reference: ``Mallard/IoTetgen.hpp:44-235`` — reads ``.node`` / ``.edge`` /
(``.face``) / ``.ele`` with ``#``-comment filtering, then assigns boundary
labels at the end, which handing the markers to :func:`build_mesh` keyed by
sorted node tuple reproduces.
"""

from __future__ import annotations

import os

import numpy as np

from stormx_torch.core.exceptions import StormIoError
from stormx_torch.mesh.unstructured import UnstructuredMesh, build_mesh

__all__ = ["read_tetgen"]


def _load_rows(path: str) -> list:
    """Whitespace-separated numeric rows, '#' comments stripped."""
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    rows.append(line.split())
    except OSError as e:
        raise StormIoError(f"cannot open '{path}': {e}") from e
    return rows


def read_tetgen(prefix: str) -> UnstructuredMesh:
    """Read a Triangle (2D) or TetGen (3D) mesh from ``prefix`` (``mesh.1.`` →
    ``mesh.1.node`` / ``.edge`` / ``.ele``)."""
    prefix = prefix.rstrip(".") + "."

    node_rows = _load_rows(prefix + "node")
    num_nodes, dim, num_attribs, has_labels = (int(x) for x in node_rows[0][:4])
    if dim not in (2, 3):
        raise StormIoError(f"unsupported dimension {dim}")
    body = np.asarray(node_rows[1 : 1 + num_nodes], dtype=np.float64)
    ids = body[:, 0].astype(np.int64)
    base = int(ids.min())  # Triangle may index from 0 or 1
    positions = body[:, 1 : 1 + dim]
    node_labels = None
    if has_labels and body.shape[1] > 1 + dim + num_attribs:
        node_labels = body[:, 1 + dim + num_attribs].astype(np.int64)

    marker_file = prefix + ("edge" if dim == 2 else "face")
    npf = 2 if dim == 2 else 3
    boundary_labels: dict[tuple, int] = {}
    if os.path.exists(marker_file):
        rows = _load_rows(marker_file)
        header = rows[0]
        count = int(header[0])
        has_marks = int(header[-1]) == 1 if len(header) > 1 else False
        if has_marks:
            arr = np.asarray(rows[1 : 1 + count], dtype=np.int64)
            nodes = arr[:, 1 : 1 + npf] - base
            marks = arr[:, 1 + npf]
            for tup, m in zip(map(tuple, np.sort(nodes, axis=1)), marks):
                if m != 0:
                    boundary_labels[tup] = int(m)

    ele_rows = _load_rows(prefix + "ele")
    num_cells, nodes_per_cell = int(ele_rows[0][0]), int(ele_rows[0][1])
    if nodes_per_cell != dim + 1:
        raise StormIoError(f"expected {dim + 1} nodes per cell, got {nodes_per_cell}")
    cells = (
        np.asarray(ele_rows[1 : 1 + num_cells], dtype=np.int64)[:, 1 : 1 + nodes_per_cell]
        - base
    )
    return build_mesh(
        positions, cells, boundary_face_labels=boundary_labels, node_labels=node_labels
    )
