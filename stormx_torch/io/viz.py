"""Mesh visualization (counterpart of ``stormx/io/viz.py``): quick
matplotlib renders of meshes, cell fields and convergence histories — the
replacement of the reference's OpenGL visualizer
(``Vulture/Visualizer.hpp:52-365``), beside :func:`write_vtk` for ParaView.

matplotlib is imported when a function is called.  Where it is not
installed the functions raise :class:`StormError` naming it.  Fields and
histories may be tensors on any device.
"""

from __future__ import annotations

import numpy as np

from stormx_torch.core.exceptions import StormError
from stormx_torch.sparse.formats import host

__all__ = ["visualize_mesh", "plot_cell_field", "plot_convergence"]


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise StormError("stormx_torch.io.viz needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt



def _tri_split(mesh, with_cell_ids: bool = False):
    """Triangulate cells (each cell a fan of (its node count − 2)
    triangles; hybrid meshes pad ``cell_nodes`` with −1).  With
    ``with_cell_ids`` also returns the source cell of each triangle."""
    cells = np.asarray(mesh.cell_nodes)
    npc = (cells >= 0).sum(axis=1)
    tris, ids = [], []
    for k in range(3, cells.shape[1] + 1):
        sel = npc >= k
        tris.append(cells[sel][:, [0, k - 2, k - 1]])
        ids.append(np.nonzero(sel)[0])
    tris = np.concatenate(tris, axis=0)
    ids = np.concatenate(ids)
    return (tris, ids) if with_cell_ids else tris


def _save(plt, fig, path):
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def _boundary_face_polys(mesh):
    """Boundary faces as vertex-coordinate polygons, their labels and their
    inner cells (−1 padding stripped per face)."""
    pos = np.asarray(mesh.node_positions)
    bidx = mesh.boundary_faces()
    fn = np.asarray(mesh.face_nodes)[bidx]
    polys = [pos[row[row >= 0]] for row in fn]
    labels = np.asarray(mesh.face_labels)[bidx]
    inner = np.asarray(mesh.face_cells)[bidx, 0]
    return polys, labels, inner


def _axes_3d(plt, mesh):
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    pos = np.asarray(mesh.node_positions)
    ax.set_xlim(pos[:, 0].min(), pos[:, 0].max())
    ax.set_ylim(pos[:, 1].min(), pos[:, 1].max())
    ax.set_zlim(pos[:, 2].min(), pos[:, 2].max())
    ax.set_box_aspect(pos.max(axis=0) - pos.min(axis=0))
    return fig, ax


def visualize_mesh(mesh, path: str | None = None, *, show_edges: bool = True):
    """Render a mesh to ``path`` (PNG): in 2-D the wireframe with boundary
    faces colored by label, in 3-D the boundary surface colored by label.
    Returns the matplotlib figure."""
    _, plt = _pyplot()
    if mesh.dim == 3:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        polys, labels, _ = _boundary_face_polys(mesh)
        fig, ax = _axes_3d(plt, mesh)
        cmap = plt.get_cmap("tab10")
        for lab in np.unique(labels):
            sel = [p for p, l in zip(polys, labels) if l == lab]
            ax.add_collection3d(Poly3DCollection(
                sel, facecolor=cmap(int(lab) % 10),
                edgecolor="0.3" if show_edges else None, linewidths=0.2, alpha=0.95))
        ax.set_title(f"{mesh.num_cells} cells / {mesh.num_faces} faces")
        return _save(plt, fig, path)
    pos = np.asarray(mesh.node_positions)
    fig, ax = plt.subplots(figsize=(7, 7))
    if show_edges:
        ax.triplot(pos[:, 0], pos[:, 1], _tri_split(mesh), lw=0.3, color="0.6")
    for label in range(1, mesh.num_labels):
        faces = mesh.boundary_faces(label)
        if not len(faces):
            continue
        for seg in pos[np.asarray(mesh.face_nodes)[faces]]:
            ax.plot(seg[:, 0], seg[:, 1], lw=1.2)
    ax.set_aspect("equal")
    ax.set_title(f"{mesh.num_cells} cells / {mesh.num_faces} faces")
    return _save(plt, fig, path)


def plot_cell_field(mesh, values, path: str | None = None, *, cmap="viridis", title=""):
    """Flat-shaded cell-field plot; 3-D meshes show each boundary face's
    inner-cell value on the boundary surface."""
    matplotlib, plt = _pyplot()
    values = host(values).reshape(mesh.num_cells, -1)[:, 0]
    if mesh.dim == 3:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        polys, _, inner = _boundary_face_polys(mesh)
        vals = values[inner]
        fig, ax = _axes_3d(plt, mesh)
        cm = plt.get_cmap(cmap)
        lo, hi = float(vals.min()), float(vals.max())
        span = (hi - lo) or 1.0
        ax.add_collection3d(Poly3DCollection(polys, facecolors=cm((vals - lo) / span),
                                             edgecolor=None))
        sm = plt.cm.ScalarMappable(cmap=cm, norm=matplotlib.colors.Normalize(lo, hi))
        fig.colorbar(sm, ax=ax, shrink=0.7)
    else:
        pos = np.asarray(mesh.node_positions)
        tris, tri_ids = _tri_split(mesh, with_cell_ids=True)
        fig, ax = plt.subplots(figsize=(7, 7))
        tpc = ax.tripcolor(pos[:, 0], pos[:, 1], tris, facecolors=values[tri_ids], cmap=cmap)
        fig.colorbar(tpc, ax=ax, shrink=0.8)
        ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    return _save(plt, fig, path)


def plot_convergence(histories: dict, path: str | None = None):
    """Residual-history comparison plot: ``histories`` maps a name to a 1-D
    history of absolute errors (``SolveResult.history``; NaN and zero
    padding is trimmed)."""
    _, plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    for name, h in histories.items():
        h = host(h)
        ax.semilogy(h[np.isfinite(h) & (h > 0)], label=name)
    ax.set_xlabel("iteration")
    ax.set_ylabel("absolute residual")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    return _save(plt, fig, path)
