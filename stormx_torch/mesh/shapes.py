"""Element shape catalog: vectorized volume / barycenter / normal geometry.

Reference: ``Mallard/Shape.hpp:39-858`` — 8 shape types (Seg, Triangle,
Quadrangle, TriangleStrip, Polygon, Tetrahedron, Pyramid, Pentahedron,
Hexahedron), each carrying node lists and generic geometry computed by
decomposing complex shapes into simplex ``pieces`` and accumulating
volume-weighted barycenters (``Shape.hpp:141-199``).

No per-shape objects: geometry functions take ``coords`` of shape
``(..., num_nodes, dim)`` (all cells of one shape type at once — a hybrid
mesh groups cells by type) and return batched volumes/centers/normals in
NumPy, on the host.  The port's own copy of ``stormx/mesh/shapes.py``,
unchanged in substance, so that the mesh builder gives identical geometry.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SEG",
    "TRIANGLE",
    "QUADRANGLE",
    "TETRAHEDRON",
    "PYRAMID",
    "PENTAHEDRON",
    "HEXAHEDRON",
    "TRIANGLE_STRIP",
    "POLYGON",
    "SHAPE_FACES_2D",
    "SHAPE_FACES_3D",
    "SHAPE_EDGES_3D",
    "shape_faces_2d",
    "strip_pieces",
    "polygon_pieces",
    "strip_faces",
    "polygon_faces",
    "normalize_shape",
    "volume",
    "barycenter",
    "face_normal_2d",
    "face_normal_3d",
    "face_geometry_3d",
]

# Shape type ids (order mirrors the reference catalog).
SEG = 1
TRIANGLE = 2
QUADRANGLE = 3
TETRAHEDRON = 4
PYRAMID = 5
PENTAHEDRON = 6
HEXAHEDRON = 7
# Variable-arity 2D shapes (reference ``Shape.hpp:410-528``); a mesh group
# of these fixes one node count k per group (3/4-node instances fall back to
# triangle/quadrangle, mirroring the reference's ``type()`` fallback).
TRIANGLE_STRIP = 8
POLYGON = 9

_NUM_NODES = {
    SEG: 2,
    TRIANGLE: 3,
    QUADRANGLE: 4,
    TETRAHEDRON: 4,
    PYRAMID: 5,
    PENTAHEDRON: 6,
    HEXAHEDRON: 8,
}


def normalize_shape(shape_type: int, k: int) -> int:
    """Variable-arity fallback (``Shape.hpp:426-433,498-505``): 3-node
    strips/polygons are triangles; 4-node polygons are quadrangles.

    Deviation from the reference: a 4-node *strip* stays a strip — its node
    order (zig-zag) differs from the quadrangle's boundary order, so the
    reference's blanket ``case 4: return Type::quadrangle`` would
    mis-triangulate it."""
    if shape_type in (TRIANGLE_STRIP, POLYGON) and k == 3:
        return TRIANGLE
    if shape_type == POLYGON and k == 4:
        return QUADRANGLE
    return shape_type


def strip_pieces(k: int) -> list:
    """Triangle pieces of a k-node strip: (i−2, i−1, i) sliding window
    (``Shape.hpp:449-457``), winding flipped on odd steps so every piece has
    consistent (CCW) orientation for signed-area accumulation."""
    out = []
    for i in range(2, k):
        if i % 2 == 0:
            out.append((i - 2, i - 1, i))
        else:
            out.append((i - 1, i - 2, i))
    return out


def polygon_pieces(k: int) -> list:
    """Triangle-fan pieces of a convex k-gon (the reference leaves
    ``Polygon::pieces`` unimplemented, ``Shape.hpp:520-527``; the fan is the
    standard convex decomposition its @todo points at)."""
    return [(0, i, i + 1) for i in range(1, k - 1)]


def strip_faces(k: int) -> list:
    """Perimeter edges of a k-node strip, traversed as one CCW cycle
    (``Shape.hpp:442-446`` is unimplemented in the reference; this is the
    strip boundary): along the even (bottom) chain, then back along the odd
    (top) chain."""
    cycle = list(range(0, k, 2)) + list(range(1, k, 2))[::-1]
    return [(cycle[i], cycle[(i + 1) % k]) for i in range(k)]


def polygon_faces(k: int) -> list:
    """Boundary edges of a k-gon, *including* the closing edge (the
    reference's ``Polygon::edges`` omits it — ``Shape.hpp:512-518`` iterates
    i ∈ [1, k) only — which is a latent bug we do not reproduce)."""
    return [(i, (i + 1) % k) for i in range(k)]


def shape_faces_2d(shape_type: int, k: int) -> list:
    """Local face (edge) lists for any 2D cell shape, fixed or variable."""
    shape_type = normalize_shape(shape_type, k)
    if shape_type in SHAPE_FACES_2D:
        return SHAPE_FACES_2D[shape_type]
    if shape_type == TRIANGLE_STRIP:
        return strip_faces(k)
    if shape_type == POLYGON:
        return polygon_faces(k)
    raise ValueError(f"unknown 2D shape type {shape_type}")

# Faces (as local node index tuples) of 2D cells — their "faces" are edges
# (reference ``Mallard/Fwd.hpp``: Face = rank TopoDim−1 entity).
SHAPE_FACES_2D = {
    TRIANGLE: [(0, 1), (1, 2), (2, 0)],  # Shape.hpp:278-334
    QUADRANGLE: [(0, 1), (1, 2), (2, 3), (3, 0)],  # Shape.hpp:353-392
}

# Faces of 3D cells (outward-ordered), reference Shape.hpp:559-854.
SHAPE_FACES_3D = {
    TETRAHEDRON: [(0, 2, 1), (0, 1, 3), (1, 2, 3), (2, 0, 3)],
    PYRAMID: [(0, 3, 2, 1), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
    PENTAHEDRON: [(0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5), (0, 2, 1), (3, 4, 5)],
    HEXAHEDRON: [
        (0, 3, 2, 1),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (0, 4, 7, 3),
        (4, 5, 6, 7),
    ],
}

# Edges (local node index pairs) of 3D cells, reference Shape.hpp:559-854
# (``edges()`` lists of each shape).
SHAPE_EDGES_3D = {
    TETRAHEDRON: [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)],
    PYRAMID: [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (0, 4), (1, 4), (2, 4), (3, 4),
    ],
    PENTAHEDRON: [
        (0, 1), (1, 2), (2, 0),
        (3, 4), (4, 5), (5, 3),
        (0, 3), (1, 4), (2, 5),
    ],
    HEXAHEDRON: [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
}

# Simplex decompositions ("pieces", reference Shape.hpp:410-528) for volume /
# barycenter of non-simplex cells.
_TET_PIECES = {
    PYRAMID: [(0, 1, 2, 4), (0, 2, 3, 4)],
    PENTAHEDRON: [(0, 1, 2, 4), (0, 2, 5, 4), (0, 3, 4, 5)],
    HEXAHEDRON: [  # six positively-oriented tets sharing diagonal 0–6
        (0, 1, 2, 6),
        (0, 2, 3, 6),
        (0, 3, 7, 6),
        (0, 7, 4, 6),
        (0, 4, 5, 6),
        (0, 5, 1, 6),
    ],
}
_TRI_PIECES = {QUADRANGLE: [(0, 1, 2), (0, 2, 3)]}


def _tri_area(coords):
    """Signed area (2D) or unsigned area (3D) of triangles (..., 3, dim)."""
    a = coords[..., 1, :] - coords[..., 0, :]
    b = coords[..., 2, :] - coords[..., 0, :]
    if coords.shape[-1] == 2:
        return 0.5 * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])
    cr = np.cross(a, b)
    return 0.5 * np.linalg.norm(cr, axis=-1)


def _tet_volume(coords):
    """Signed volume of tetrahedra (..., 4, 3)."""
    a = coords[..., 1, :] - coords[..., 0, :]
    b = coords[..., 2, :] - coords[..., 0, :]
    c = coords[..., 3, :] - coords[..., 0, :]
    return np.einsum("...i,...i->...", np.cross(a, b), c) / 6.0


def volume(shape_type: int, coords):
    """Cell measure: length (Seg) / area (2D) / volume (3D).

    2D areas are *signed* (positive for CCW node order), so the mesh builder
    can detect and fix inverted cells — the analog of the reference's
    orientation handling (``MeshUnstructured.hpp:509-554``).
    """
    if shape_type == SEG:
        return np.linalg.norm(coords[..., 1, :] - coords[..., 0, :], axis=-1)
    if shape_type == TRIANGLE:
        return _tri_area(coords)
    if shape_type == QUADRANGLE:
        return sum(_tri_area(coords[..., list(p), :]) for p in _TRI_PIECES[QUADRANGLE])
    if shape_type == TETRAHEDRON:
        return _tet_volume(coords)
    if shape_type in _TET_PIECES:
        return sum(_tet_volume(coords[..., list(p), :]) for p in _TET_PIECES[shape_type])
    if shape_type in (TRIANGLE_STRIP, POLYGON):
        k = coords.shape[-2]
        shape_type = normalize_shape(shape_type, k)
        if shape_type != TRIANGLE_STRIP and shape_type != POLYGON:
            return volume(shape_type, coords)
        pieces = strip_pieces(k) if shape_type == TRIANGLE_STRIP else polygon_pieces(k)
        return sum(_tri_area(coords[..., list(p), :]) for p in pieces)
    raise ValueError(f"unknown shape type {shape_type}")


def barycenter(shape_type: int, coords):
    """Volume-weighted barycenter (reference ``Shape.hpp:158-181``)."""
    if shape_type in (SEG, TRIANGLE, TETRAHEDRON):
        return coords.mean(axis=-2)
    if shape_type == QUADRANGLE:
        pieces = _TRI_PIECES[QUADRANGLE]
        meas = _tri_area
    elif shape_type in _TET_PIECES:
        pieces = _TET_PIECES[shape_type]
        meas = _tet_volume
    elif shape_type in (TRIANGLE_STRIP, POLYGON):
        k = coords.shape[-2]
        norm_type = normalize_shape(shape_type, k)
        if norm_type not in (TRIANGLE_STRIP, POLYGON):
            return barycenter(norm_type, coords)
        pieces = strip_pieces(k) if norm_type == TRIANGLE_STRIP else polygon_pieces(k)
        meas = _tri_area
    else:
        raise ValueError(f"unknown shape type {shape_type}")
    vols = [meas(coords[..., list(p), :]) for p in pieces]
    cents = [coords[..., list(p), :].mean(axis=-2) for p in pieces]
    total = sum(vols)
    weighted = sum(v[..., None] * c for v, c in zip(vols, cents))
    return weighted / total[..., None]


def face_normal_2d(coords):
    """Unit normal of 2D faces (segments), (..., 2, 2) → (..., 2).

    Convention: for a segment (a → b), n = perp(b − a) = (dy, −dx)/‖·‖, i.e.
    rotated −90°; with CCW cell orientation this points *out* of the cell
    whose traversal is a → b (the inner cell).
    """
    d = coords[..., 1, :] - coords[..., 0, :]
    n = np.stack([d[..., 1], -d[..., 0]], axis=-1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def face_geometry_3d(coords):
    """(areas, unit normals, centroids) of 3D polygonal faces
    ``(..., k, 3)`` via the triangle fan from node 0 (reference
    ``Shape.hpp:141-199`` piecewise accumulation, vectorized).

    Robust to repeated nodes (degenerate fan pieces contribute zero), which
    is how mixed-arity faces (tri faces of pyramids/prisms padded to the
    quad width) are represented.
    """
    k = coords.shape[-2]
    vec_area = 0.0
    w_cent = 0.0
    w_sum = 0.0
    for i in range(1, k - 1):
        a = coords[..., i, :] - coords[..., 0, :]
        b = coords[..., i + 1, :] - coords[..., 0, :]
        ai = 0.5 * np.cross(a, b)  # vector area of piece i
        mi = np.linalg.norm(ai, axis=-1)
        ci = (coords[..., 0, :] + coords[..., i, :] + coords[..., i + 1, :]) / 3.0
        vec_area = vec_area + ai
        w_cent = w_cent + mi[..., None] * ci
        w_sum = w_sum + mi
    area = np.linalg.norm(vec_area, axis=-1)
    normal = vec_area / np.maximum(area, 1e-300)[..., None]
    center = w_cent / np.maximum(w_sum, 1e-300)[..., None]
    return area, normal, center


def face_normal_3d(coords):
    """Area-weighted unit normal of 3D polygon faces (..., k, 3) → (..., 3).

    Newell accumulation over the polygon fan — matches the reference's
    piecewise normal accumulation (``Shape.hpp:183-199``).
    """
    k = coords.shape[-2]
    acc = 0.0
    for i in range(1, k - 1):
        a = coords[..., i, :] - coords[..., 0, :]
        b = coords[..., i + 1, :] - coords[..., 0, :]
        acc = acc + 0.5 * np.cross(a, b)
    return acc / np.linalg.norm(acc, axis=-1, keepdims=True)


def num_nodes(shape_type: int) -> int:
    return _NUM_NODES[shape_type]
