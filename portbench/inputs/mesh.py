"""The jittered Delaunay mesh of the unit square (a frozen copy of
``chip_smoke.py:delaunay_mesh``; the benchmark's yardstick, so it is not
imported from there)."""

from __future__ import annotations

import numpy as np


def delaunay_mesh(side: int, jitter: float, seed: int):
    """Delaunay triangles (CCW) of a ``side``×``side`` grid of the unit square
    whose interior points are moved uniformly by up to ``jitter`` spacings.
    Returns (points (P, 2) float64, triangles (T, 3) int64)."""
    from scipy.spatial import Delaunay

    g = np.linspace(0.0, 1.0, side)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    interior = ((pts > 0.0) & (pts < 1.0)).all(axis=1)
    rng = np.random.default_rng(seed)
    pts[interior] += (rng.random((int(interior.sum()), 2)) - 0.5) * (2 * jitter / (side - 1))
    tris = Delaunay(pts).simplices.astype(np.int64)
    a, b, c = (pts[tris[:, i]] for i in range(3))
    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    tris[area2 < 0] = tris[area2 < 0][:, ::-1]
    return pts, tris


def interior_edges(tris: np.ndarray) -> int:
    """Edges shared by two triangles: the off-diagonal entries of one
    triangle of the two-point-flux operator."""
    e = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    return int((counts == 2).sum())
