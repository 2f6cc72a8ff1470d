"""Unstructured mesh: host-side vectorized builder → device tensors
(counterpart of ``stormx/mesh/unstructured.py``).

The host mesh is NumPy structure-of-arrays, built by the same vectorized
pass as the JAX package (sort-unique face derivation, label-sorted faces,
per-shape-group geometry), so both packages give identical fields:

  * ``face_cells[f] = (inner, outer)`` with ``outer = -1`` on the boundary;
  * label ranges: interior label 0 first, then boundary labels ascending;
  * geometry arrays (volumes, centers, areas, normals) frozen once.

``device_arrays()`` freezes it into a :class:`DeviceMesh` of tensors,
including the cell←face incidence table in ELL form that turns the FVM
scatter-accumulate into a gather, and, on CUDA in float32, the four
:class:`~stormx_torch.ops.banded_gather.BandedGatherPlan` index maps.
The n-to-m connectivity tables (``connectivity_csr`` and the ``*_csr``
methods) are derived lazily on the host by the same NumPy passes, so they
are identical too.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from stormx_torch.core.config import default_real_dtype, resolve_device
from stormx_torch.core.exceptions import StormError
from stormx_torch.mesh import shapes

__all__ = ["UnstructuredMesh", "DeviceMesh", "build_mesh", "build_hybrid_mesh"]

INTERIOR = 0  # label 0 = interior entities (Mallard/Mesh.hpp:443-480)


@dataclass
class UnstructuredMesh:
    """Host-side mesh: NumPy connectivity + geometry.

    2D: cells are triangles/quads, faces are edges.
    3D: cells are tets (extendable per shape group), faces are triangles.
    """

    dim: int
    node_positions: np.ndarray  # (num_nodes, dim)
    cell_nodes: np.ndarray  # (num_cells, max_nodes_per_cell); -1 pads hybrid
    cell_shape: int  # shapes.* type id; -1 for hybrid (see cell_shapes)
    cell_shapes: np.ndarray = field(default=None)

    face_nodes: np.ndarray = field(default=None)  # (num_faces, npf)
    face_cells: np.ndarray = field(default=None)  # (num_faces, 2) inner, outer
    face_labels: np.ndarray = field(default=None)  # (num_faces,)
    node_labels: np.ndarray = field(default=None)

    cell_volumes: np.ndarray = field(default=None)
    cell_centers: np.ndarray = field(default=None)
    face_areas: np.ndarray = field(default=None)
    face_normals: np.ndarray = field(default=None)  # inner → outer
    face_centers: np.ndarray = field(default=None)

    # Faces with label L are face_label_ranges[L] : face_label_ranges[L+1].
    face_label_ranges: np.ndarray = field(default=None)

    @property
    def num_nodes(self) -> int:
        return len(self.node_positions)

    @property
    def num_cells(self) -> int:
        return len(self.cell_nodes)

    @property
    def num_faces(self) -> int:
        return len(self.face_nodes)

    def num_faces_with_label(self, label: int) -> int:
        r = self.face_label_ranges
        return int(r[label + 1] - r[label])

    @property
    def num_labels(self) -> int:
        return len(self.face_label_ranges) - 1

    def interior_faces(self) -> np.ndarray:
        """Indices of interior faces (label 0)."""
        return np.arange(self.face_label_ranges[0], self.face_label_ranges[1])

    def boundary_faces(self, label: int | None = None) -> np.ndarray:
        r = self.face_label_ranges
        if label is None:
            return np.arange(r[1], r[-1])
        return np.arange(r[label], r[label + 1])

    # ------------------------------------------------------------------
    # Entity lookup and relabeling (reference ``MeshUnstructured.hpp``:
    # ``find`` by node set via adjacency intersection (:239-265) and the
    # ``assign_labels`` stable relabel-resort (:464-500)): a host-side
    # lookup table and a FUNCTIONAL relabel that returns a new mesh.
    # ------------------------------------------------------------------
    def find_face(self, nodes) -> int | None:
        """Face index whose node SET equals ``nodes`` (any order), else None."""
        key = tuple(sorted(int(x) for x in nodes))
        lut = getattr(self, "_face_lut", None)
        if lut is None:
            lut = {
                tuple(sorted(int(x) for x in row if x >= 0)): i
                for i, row in enumerate(self.face_nodes)
            }
            self._face_lut = lut
        return lut.get(key)

    def find_cell(self, nodes) -> int | None:
        """Cell index whose node SET equals ``nodes`` (any order), else None."""
        key = tuple(sorted(int(x) for x in nodes))
        lut = getattr(self, "_cell_lut", None)
        if lut is None:
            lut = {
                tuple(sorted(int(x) for x in row if x >= 0)): i
                for i, row in enumerate(self.cell_nodes)
            }
            self._cell_lut = lut
        return lut.get(key)

    def assign_face_labels(self, new_labels) -> "UnstructuredMesh":
        """Return a NEW mesh with faces relabeled and stably re-sorted by
        label (interior 0 first, boundary labels ascending).

        ``new_labels``: (num_faces,) array in the CURRENT face order.
        Interior faces (two cells) must keep label 0; boundary faces must
        get labels ≥ 1.  The lookup tables of :meth:`find_face` and
        :meth:`find_cell` are attributes outside the dataclass fields, so
        ``replace`` leaves them behind with the old face order.
        """
        new_labels = np.asarray(new_labels, dtype=np.int64)
        if new_labels.shape != (self.num_faces,):
            raise StormError("assign_face_labels needs one label per face")
        is_interior = self.face_cells[:, 1] >= 0
        if (new_labels[is_interior] != INTERIOR).any():
            raise StormError("interior faces must keep label 0")
        if (new_labels[~is_interior] < 1).any():
            raise StormError("boundary faces need labels >= 1")
        perm = np.argsort(new_labels, kind="stable")
        labels = new_labels[perm]
        max_label = int(labels.max(initial=0))
        ranges = np.searchsorted(labels, np.arange(max_label + 2))
        return replace(
            self,
            face_nodes=self.face_nodes[perm],
            face_cells=self.face_cells[perm],
            face_labels=labels,
            face_areas=self.face_areas[perm],
            face_normals=self.face_normals[perm],
            face_centers=self.face_centers[perm],
            face_label_ranges=ranges,
        )

    # ------------------------------------------------------------------
    # Full n-to-m connectivity (reference: the (TopoDim+1)² table matrix of
    # UnstructuredMesh, ``Mallard/MeshUnstructured.hpp:81-129``).  Derived
    # lazily as CSR (row_ptr, cols) pairs — the reference precomputes all of
    # them eagerly; here only faces/cells are eager (the FVM hot path) and
    # the rest are one vectorized pass on demand.
    # ------------------------------------------------------------------
    def edge_nodes(self) -> np.ndarray:
        """Unique edges as sorted (n0, n1) pairs.

        In 2D edges ARE the faces; in 3D they are derived from the cell
        shape catalog (``shapes.SHAPE_EDGES_3D``).
        """
        if self.dim == 2:
            return np.sort(self.face_nodes, axis=1)
        pairs = []
        for shape in np.unique(self.cell_shapes):
            sel = self.cell_shapes == shape
            cells = self.cell_nodes[sel]
            for e in shapes.SHAPE_EDGES_3D[int(shape)]:
                pairs.append(cells[:, list(e)])
        pairs = np.sort(np.concatenate(pairs, axis=0), axis=1)
        return np.unique(pairs, axis=0)

    @property
    def num_edges(self) -> int:
        return len(self.edge_nodes())

    def _csr_from_pairs(self, rows, cols, nrows):
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        keep = np.ones(len(rows), dtype=bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        rows, cols = rows[keep], cols[keep]
        ptr = np.zeros(nrows + 1, dtype=np.int64)
        np.add.at(ptr, rows + 1, 1)
        return np.cumsum(ptr), cols

    def node_cells_csr(self):
        """node → incident cells as (row_ptr, cols)."""
        valid = self.cell_nodes >= 0
        rows = self.cell_nodes[valid]
        cols = np.broadcast_to(
            np.arange(self.num_cells)[:, None], self.cell_nodes.shape
        )[valid]
        return self._csr_from_pairs(rows, cols, self.num_nodes)

    def node_nodes_csr(self):
        """node → edge-connected neighbor nodes as (row_ptr, cols)."""
        e = self.edge_nodes()
        rows = np.concatenate([e[:, 0], e[:, 1]])
        cols = np.concatenate([e[:, 1], e[:, 0]])
        return self._csr_from_pairs(rows, cols, self.num_nodes)

    def cell_cells_csr(self):
        """cell → face-adjacent cells as (row_ptr, cols)."""
        interior = self.interior_faces()
        inner = self.face_cells[interior, 0]
        outer = self.face_cells[interior, 1]
        rows = np.concatenate([inner, outer])
        cols = np.concatenate([outer, inner])
        return self._csr_from_pairs(rows, cols, self.num_cells)

    def cell_faces_csr(self):
        """cell → incident faces as (row_ptr, cols)."""
        has_outer = self.face_cells[:, 1] >= 0
        rows = np.concatenate(
            [self.face_cells[:, 0], self.face_cells[has_outer, 1]]
        )
        cols = np.concatenate(
            [np.arange(self.num_faces), np.nonzero(has_outer)[0]]
        )
        return self._csr_from_pairs(rows, cols, self.num_cells)

    # -- remaining rows of the (TopoDim+1)² connectivity matrix ----------
    def _edge_keys(self):
        """Sorted scalar keys of the edge table (edge id = position)."""
        e = self.edge_nodes().astype(np.int64)
        return e[:, 0] * self.num_nodes + e[:, 1]

    def _edge_ids_of_pairs(self, pairs):
        """Edge ids for (m, 2) node pairs (any order within a pair)."""
        p = np.sort(np.asarray(pairs, dtype=np.int64), axis=1)
        keys = p[:, 0] * self.num_nodes + p[:, 1]
        table = self._edge_keys()
        idx = np.searchsorted(table, keys)
        if (idx >= len(table)).any() or (table[idx] != keys).any():
            raise StormError("node pair is not a mesh edge")
        return idx

    def _cell_edge_pairs(self):
        """(cell id, edge id) incidence pairs (3D; in 2D edges ARE faces)."""
        shapes_arr = (
            self.cell_shapes
            if self.cell_shapes is not None
            else np.full(self.num_cells, self.cell_shape)
        )
        rows, pairs = [], []
        for shape in np.unique(shapes_arr):
            sel = np.nonzero(shapes_arr == shape)[0]
            cells = self.cell_nodes[sel]
            for a, b in shapes.SHAPE_EDGES_3D[int(shape)]:
                rows.append(sel)
                pairs.append(cells[:, [a, b]])
        rows = np.concatenate(rows)
        edges = self._edge_ids_of_pairs(np.concatenate(pairs, axis=0))
        return rows, edges

    def _face_edge_pairs(self):
        """(face id, edge id) incidence pairs (3D faces are polygons)."""
        fn = self.face_nodes
        counts = (fn >= 0).sum(axis=1)
        rows, pairs = [], []
        for v in np.unique(counts):
            sel = np.nonzero(counts == v)[0]
            f = fn[sel]
            for i in range(int(v)):
                rows.append(sel)
                pairs.append(f[:, [i, (i + 1) % int(v)]])
        rows = np.concatenate(rows)
        edges = self._edge_ids_of_pairs(np.concatenate(pairs, axis=0))
        return rows, edges

    def cell_edges_csr(self):
        """cell → incident edges as (row_ptr, cols)."""
        if self.dim == 2:
            return self.cell_faces_csr()  # 2D: edges are the faces
        rows, edges = self._cell_edge_pairs()
        return self._csr_from_pairs(rows, edges, self.num_cells)

    def face_edges_csr(self):
        """face → incident edges as (row_ptr, cols).  2D: identity."""
        if self.dim == 2:
            ptr = np.arange(self.num_faces + 1, dtype=np.int64)
            return ptr, np.arange(self.num_faces, dtype=np.int64)
        rows, edges = self._face_edge_pairs()
        return self._csr_from_pairs(rows, edges, self.num_faces)

    def node_edges_csr(self):
        """node → incident edges as (row_ptr, cols)."""
        e = self.edge_nodes()
        rows = np.concatenate([e[:, 0], e[:, 1]])
        cols = np.tile(np.arange(len(e)), 2)
        return self._csr_from_pairs(rows, cols, self.num_nodes)

    def node_faces_csr(self):
        """node → incident faces as (row_ptr, cols)."""
        valid = self.face_nodes >= 0
        rows = self.face_nodes[valid]
        cols = np.broadcast_to(
            np.arange(self.num_faces)[:, None], self.face_nodes.shape
        )[valid]
        return self._csr_from_pairs(rows, cols, self.num_nodes)

    def edge_cells_csr(self):
        """edge → incident cells as (row_ptr, cols)."""
        if self.dim == 2:
            fc = self.face_cells
            valid = fc >= 0
            rows = np.broadcast_to(np.arange(self.num_faces)[:, None], fc.shape)[valid]
            return self._csr_from_pairs(rows, fc[valid], len(self.edge_nodes()))
        rows, edges = self._cell_edge_pairs()
        return self._csr_from_pairs(edges, rows, len(self.edge_nodes()))

    def edge_faces_csr(self):
        """edge → incident faces as (row_ptr, cols).  2D: identity."""
        if self.dim == 2:
            ptr = np.arange(self.num_faces + 1, dtype=np.int64)
            return ptr, np.arange(self.num_faces, dtype=np.int64)
        rows, edges = self._face_edge_pairs()
        return self._csr_from_pairs(edges, rows, len(self.edge_nodes()))

    def edge_edges_csr(self):
        """edge → edges sharing a node (diagonal adjacency)."""
        ptr, cols = self.node_edges_csr()
        return self._adjacency_via(ptr, cols, len(self.edge_nodes()))

    def face_faces_csr(self):
        """face → faces sharing a sub-entity (2D: a node, 3D: an edge)."""
        if self.dim == 2:
            ptr, cols = self.node_faces_csr()
        else:
            ptr, cols = self.edge_faces_csr()
        return self._adjacency_via(ptr, cols, self.num_faces)

    def _adjacency_via(self, via_ptr, via_cols, n_ent):
        """All (a, b), a≠b, sharing a row of the given incidence CSR."""
        counts = np.diff(via_ptr)
        rows_a, rows_b = [], []
        for c in np.unique(counts):
            if c < 2:
                continue
            sel = np.nonzero(counts == c)[0]
            idx = via_ptr[sel][:, None] + np.arange(c)[None, :]
            members = via_cols[idx]  # (m, c)
            for i in range(int(c)):
                for j in range(int(c)):
                    if i != j:
                        rows_a.append(members[:, i])
                        rows_b.append(members[:, j])
        if not rows_a:
            return np.zeros(n_ent + 1, dtype=np.int64), np.zeros(0, np.int64)
        return self._csr_from_pairs(
            np.concatenate(rows_a), np.concatenate(rows_b), n_ent
        )

    def connectivity_csr(self, src: str, dst: str):
        """Any row of the reference's (TopoDim+1)² connectivity matrix
        (``Mallard/MeshUnstructured.hpp:81-129``) as a ``(row_ptr, cols)``
        CSR pair.  Ranks by name: ``"node" | "edge" | "face" | "cell"``
        (2D: edge ≡ face).  Diagonal tables are adjacency through a shared
        sub-entity (node→node via edges, edge→edge via nodes, face→face via
        nodes/edges, cell→cell via faces).
        """
        def ident(n):
            return np.arange(n + 1, dtype=np.int64), np.arange(n, dtype=np.int64)

        table = {
            ("node", "node"): self.node_nodes_csr,
            ("node", "edge"): self.node_edges_csr,
            ("node", "face"): self.node_faces_csr,
            ("node", "cell"): self.node_cells_csr,
            ("edge", "node"): lambda: self._rows_to_csr(
                self.edge_nodes(), len(self.edge_nodes())
            ),
            ("edge", "edge"): self.edge_edges_csr,
            ("edge", "face"): self.edge_faces_csr,
            ("edge", "cell"): self.edge_cells_csr,
            ("face", "node"): lambda: self._rows_to_csr(
                self.face_nodes, self.num_faces
            ),
            ("face", "edge"): self.face_edges_csr,
            ("face", "face"): self.face_faces_csr,
            ("face", "cell"): lambda: self._rows_to_csr(
                self.face_cells, self.num_faces
            ),
            ("cell", "node"): lambda: self._rows_to_csr(
                self.cell_nodes, self.num_cells
            ),
            ("cell", "edge"): self.cell_edges_csr,
            ("cell", "face"): self.cell_faces_csr,
            ("cell", "cell"): self.cell_cells_csr,
        }
        key = (src, dst)
        if key not in table:
            raise StormError(f"unknown connectivity {src}->{dst}")
        return table[key]()

    @staticmethod
    def _rows_to_csr(rows_arr, nrows):
        """Fixed-width (padded with −1) incidence rows → CSR."""
        valid = rows_arr >= 0
        counts = valid.sum(axis=1)
        ptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        return ptr, rows_arr[valid].astype(np.int64)


    def permute(self, rank: str, perm) -> "UnstructuredMesh":
        """Return a NEW mesh with entities of ``rank`` reordered by ``perm``
        (``perm[new] = old``) and every cross-reference remapped (reference
        ``MeshUnstructured.hpp:443-463``).  Face permutations must be
        label-stable."""
        perm = np.asarray(perm, dtype=np.int64)
        sizes = {"node": self.num_nodes, "face": self.num_faces, "cell": self.num_cells}
        if rank == "edge":
            if self.dim == 2:
                rank = "face"
            else:
                raise StormError(
                    "3D edges are derived lazily; there is no stored edge state to permute"
                )
        if rank not in sizes:
            raise StormError(f"unknown entity rank {rank!r}")
        n = sizes[rank]
        if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
            raise StormError(f"perm must be a permutation of range({n})")
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)

        def remap(idx_arr):
            out = np.where(idx_arr >= 0, inv[np.maximum(idx_arr, 0)], -1)
            return out.astype(idx_arr.dtype)

        if rank == "node":
            return replace(
                self,
                node_positions=self.node_positions[perm],
                node_labels=None if self.node_labels is None else self.node_labels[perm],
                cell_nodes=remap(self.cell_nodes),
                face_nodes=remap(self.face_nodes),
            )
        if rank == "cell":
            return replace(
                self,
                cell_nodes=self.cell_nodes[perm],
                cell_shapes=None if self.cell_shapes is None else self.cell_shapes[perm],
                cell_volumes=self.cell_volumes[perm],
                cell_centers=self.cell_centers[perm],
                face_cells=remap(self.face_cells),
            )
        if not np.array_equal(self.face_labels[perm], self.face_labels):
            raise StormError("face permute must be label-stable")
        return replace(
            self,
            face_nodes=self.face_nodes[perm],
            face_cells=self.face_cells[perm],
            face_labels=self.face_labels[perm],
            face_areas=self.face_areas[perm],
            face_normals=self.face_normals[perm],
            face_centers=self.face_centers[perm],
        )

    def optimize_ordering(self) -> "UnstructuredMesh":
        """Reorder for the banded-gather kernel: cells by the minimum-bandwidth
        ordering, faces by inner cell within each label (label-stable).  Pure
        relabeling; fields must be built AFTER this.

        Counterpart of ``UnstructuredMesh.optimize_for_tpu``
        (``stormx/mesh/unstructured.py:494-516``), with identical
        permutations.
        """
        from stormx_torch.parallel.partition import bandwidth_order

        interior = self.interior_faces()
        inner = self.face_cells[interior, 0]
        outer = self.face_cells[interior, 1]
        rows = np.concatenate([inner, outer])
        cols = np.concatenate([outer, inner])
        cperm = bandwidth_order(self.num_cells, rows, cols, self.cell_centers)
        m = self.permute("cell", cperm)
        fperm = np.arange(m.num_faces)
        r = m.face_label_ranges
        for L in range(len(r) - 1):
            blk = slice(int(r[L]), int(r[L + 1]))
            fperm[blk] = fperm[blk][np.argsort(m.face_cells[blk, 0], kind="stable")]
        return m.permute("face", fperm)

    def device_arrays(self, dtype=None, *, device="cuda",
                      banded_gather: bool | None = None) -> "DeviceMesh":
        """Freeze to tensors on ``device`` (raises when it is CUDA and there
        is none).  ``banded_gather=None`` builds the K3 gather plans exactly
        when the device is CUDA and the dtype float32; ``True`` builds them on
        any device (the CPU tests apply them through the plain version).
        Plans are bit-exact for any ordering; :meth:`optimize_ordering` first
        narrows the windows they read.
        """
        dev = resolve_device(device)
        dtype = dtype or default_real_dtype()
        idt = np.int32
        if banded_gather is None:
            banded_gather = dev.type == "cuda" and dtype == torch.float32

        interior = self.interior_faces()
        boundary = self.boundary_faces()

        # Cell ← face incidence (ELL): for each cell ALL its incident faces
        # and ±1 signs (+ when the cell is the face's inner cell).
        inner = self.face_cells[interior, 0]
        outer = self.face_cells[interior, 1]
        has_outer = self.face_cells[:, 1] >= 0
        pairs_cell = np.concatenate([self.face_cells[:, 0], self.face_cells[has_outer, 1]])
        pairs_face = np.concatenate([np.arange(self.num_faces), np.nonzero(has_outer)[0]])
        pairs_adj_cell = np.concatenate(
            [
                np.where(has_outer, self.face_cells[:, 1], self.face_cells[:, 0]),
                self.face_cells[has_outer, 0],
            ]
        )
        pairs_sign = np.concatenate(
            [np.ones(self.num_faces), -np.ones(int(has_outer.sum()))]
        )
        order = np.argsort(pairs_cell, kind="stable")
        pairs_cell = pairs_cell[order]
        pairs_face = pairs_face[order]
        pairs_sign = pairs_sign[order]
        pairs_adj_cell = pairs_adj_cell[order]
        counts = np.bincount(pairs_cell, minlength=self.num_cells)
        K = int(counts.max()) if len(counts) else 0
        starts = np.zeros(self.num_cells + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        within = np.arange(len(pairs_cell)) - starts[pairs_cell]
        cf_face = np.zeros((self.num_cells, K), dtype=idt)
        cf_sign = np.zeros((self.num_cells, K), dtype=np.float64)
        cf_face[pairs_cell, within] = pairs_face
        cf_sign[pairs_cell, within] = pairs_sign

        # Cell → adjacent-cell ELL, padded with self.
        cell_adj = np.tile(np.arange(self.num_cells, dtype=idt)[:, None], (1, K))
        cell_adj[pairs_cell, within] = pairs_adj_cell
        # Interior-face distance between adjacent cell centers.
        d = self.cell_centers[outer] - self.cell_centers[inner]
        face_dist = np.zeros(self.num_faces)
        face_dist[interior] = np.linalg.norm(d, axis=1)

        plans = {}
        if banded_gather:
            from stormx_torch.ops.banded_gather import BandedGatherPlan

            fo = np.where(self.face_cells[:, 1] >= 0, self.face_cells[:, 1],
                          self.face_cells[:, 0])
            plans = {
                "bg_face_inner": BandedGatherPlan(
                    self.face_cells[:, 0], self.num_cells, device=dev
                ),
                "bg_face_outer": BandedGatherPlan(fo, self.num_cells, device=dev),
                "bg_cell_face": BandedGatherPlan(
                    cf_face.reshape(-1), self.num_faces, device=dev
                ),
                "bg_cell_adj": BandedGatherPlan(
                    cell_adj.reshape(-1).astype(np.int64), self.num_cells, device=dev
                ),
            }

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a.astype(idt)), device=dev)

        def reals(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        return DeviceMesh(
            dim=self.dim,
            num_cells=self.num_cells,
            num_faces=self.num_faces,
            **plans,
            face_inner=ints(self.face_cells[:, 0]),
            face_outer=ints(self.face_cells[:, 1]),
            interior_faces=ints(interior),
            boundary_faces=ints(boundary),
            face_label_ranges=tuple(int(x) for x in self.face_label_ranges),
            cell_volumes=reals(self.cell_volumes),
            cell_centers=reals(self.cell_centers),
            face_areas=reals(self.face_areas),
            face_normals=reals(self.face_normals),
            face_centers=reals(self.face_centers),
            cell_face_ell=ints(cf_face),
            cell_face_sign=reals(cf_sign),
            cell_adj_ell=ints(cell_adj),
            face_dist=reals(face_dist),
        )


@dataclass(frozen=True)
class DeviceMesh:
    """Frozen device-side mesh tensors."""

    dim: int
    num_cells: int
    num_faces: int
    face_inner: torch.Tensor  # (num_faces,) int32
    face_outer: torch.Tensor  # (num_faces,) int32; −1 on boundary
    interior_faces: torch.Tensor  # (n_int,) int32
    boundary_faces: torch.Tensor
    face_label_ranges: tuple
    cell_volumes: torch.Tensor  # (num_cells,)
    cell_centers: torch.Tensor  # (num_cells, dim)
    face_areas: torch.Tensor  # (num_faces,)
    face_normals: torch.Tensor  # (num_faces, dim), inner → outer
    face_centers: torch.Tensor  # (num_faces, dim)
    cell_face_ell: torch.Tensor  # (num_cells, K) int32: ALL incident faces (pad→0)
    cell_face_sign: torch.Tensor  # (num_cells, K) +1 inner / −1 outer / 0 padding
    cell_adj_ell: torch.Tensor  # (num_cells, K) int32 adjacent cells (pad = self)
    face_dist: torch.Tensor  # (num_faces,) |center_outer − center_inner| (0 on bdry)
    # K3 banded-gather plans; FVM ops use them in place of tensor indexing
    # when present (bit-exact).
    bg_face_inner: object = None  # cells → faces (inner side)
    bg_face_outer: object = None  # cells → faces (outer, boundary→inner)
    bg_cell_face: object = None  # faces → (cells·K) flattened
    bg_cell_adj: object = None  # cells → (cells·K) flattened adjacency

    @property
    def device(self) -> torch.device:
        return self.cell_volumes.device


def build_mesh(node_positions, cell_nodes, *, boundary_face_labels: dict | None = None,
               cell_shape: int | None = None, node_labels=None) -> UnstructuredMesh:
    """Derive faces, connectivity, labels and geometry from cells.

    ``boundary_face_labels`` maps a sorted node tuple → label (from TetGen
    marker files); unlabeled boundary faces get label 1.
    """
    node_positions = np.asarray(node_positions, dtype=np.float64)
    cell_nodes = np.asarray(cell_nodes)
    dim = node_positions.shape[1]
    npc = cell_nodes.shape[1]
    if cell_shape is None:
        if dim == 2:
            cell_shape = {3: shapes.TRIANGLE, 4: shapes.QUADRANGLE}[npc]
        else:
            cell_shape = {4: shapes.TETRAHEDRON, 8: shapes.HEXAHEDRON}[npc]
    return build_hybrid_mesh(
        node_positions,
        [(cell_nodes, cell_shape)],
        boundary_face_labels=boundary_face_labels,
        node_labels=node_labels,
    )


def build_hybrid_mesh(node_positions, groups: list, *,
                      boundary_face_labels: dict | None = None,
                      node_labels=None) -> UnstructuredMesh:
    """Build a (possibly hybrid) mesh from ``(cell_nodes, shape_id)`` groups:
    geometry is vectorized per group, faces are deduplicated across all
    groups, and per-cell arrays are concatenated in group order."""
    node_positions = np.asarray(node_positions, dtype=np.float64)
    dim = node_positions.shape[1]
    groups = [
        (np.asarray(cells), shapes.normalize_shape(int(shape), np.asarray(cells).shape[1]))
        for cells, shape in groups
    ]

    # Fix inverted cells (2D): enforce CCW (positive signed area).
    fixed = []
    for cells, shape in groups:
        coords = node_positions[cells]
        if dim == 2:
            signed = shapes.volume(shape, coords)
            flipped = signed < 0
            if flipped.any():
                cells = cells.copy()
                cells[flipped] = cells[flipped][:, ::-1]
        fixed.append((cells, shape))
    groups = fixed

    ncells = sum(len(cells) for cells, _ in groups)
    cell_offsets = np.cumsum([0] + [len(cells) for cells, _ in groups])

    # Raw faces from every group.
    raw_list, raw_cell_list = [], []
    npf_set = set()
    for gi, (cells, shape) in enumerate(groups):
        local_faces = (
            shapes.shape_faces_2d(shape, cells.shape[1])
            if dim == 2
            else shapes.SHAPE_FACES_3D[shape]
        )
        npf_set.update(len(lf) for lf in local_faces)
        base = cell_offsets[gi]
        for lf in local_faces:
            raw_list.append(cells[:, list(lf)])
            raw_cell_list.append(base + np.arange(len(cells)))
    # Dedup key: sorted unpadded nodes left-padded with −1; geometry padding
    # repeats the last node.
    npf = max(npf_set)
    key_list = [
        np.concatenate(
            [np.full((len(r), npf - r.shape[1]), -1, dtype=r.dtype), np.sort(r, axis=1)],
            axis=1,
        )
        for r in raw_list
    ]
    raw_list = [
        np.concatenate([r] + [r[:, -1:]] * (npf - r.shape[1]), axis=1)
        if r.shape[1] != npf
        else r
        for r in raw_list
    ]
    raw = np.concatenate(raw_list, axis=0)
    raw_cell = np.concatenate(raw_cell_list, axis=0)

    key = np.concatenate(key_list, axis=0)
    uniq, first_idx, inverse, counts = np.unique(
        key, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    nfaces = len(uniq)
    if counts.max(initial=0) > 2:
        raise StormError("non-manifold mesh: a face is shared by > 2 cells")

    # Inner cell = owner of the first occurrence; face node order taken from
    # it, so the derived normal points out of the inner cell.
    face_nodes = raw[first_idx]
    face_cells = np.full((nfaces, 2), -1, dtype=np.int64)
    face_cells[:, 0] = raw_cell[first_idx]
    order = np.argsort(inverse, kind="stable")
    sorted_inv = inverse[order]
    sorted_cell = raw_cell[order]
    starts = np.searchsorted(sorted_inv, np.arange(nfaces))
    has_second = counts == 2
    second_cells = sorted_cell[np.minimum(starts + 1, len(order) - 1)]
    both = np.stack([sorted_cell[starts], second_cells], axis=1)
    outer = np.where(both[:, 0] == face_cells[:, 0], both[:, 1], both[:, 0])
    face_cells[:, 1] = np.where(has_second, outer, -1)

    # Labels.
    face_labels = np.zeros(nfaces, dtype=np.int64)
    is_boundary = ~has_second
    face_labels[is_boundary] = 1
    if boundary_face_labels:
        keys = [tuple(int(x) for x in t if x >= 0) for t in uniq]
        for i, ktup in enumerate(keys):
            lbl = boundary_face_labels.get(ktup)
            if lbl is not None and is_boundary[i]:
                face_labels[i] = max(int(lbl), 1)

    # Sort faces by label (stable), interior first.
    perm = np.argsort(face_labels, kind="stable")
    face_nodes = face_nodes[perm]
    face_cells = face_cells[perm]
    face_labels = face_labels[perm]
    max_label = int(face_labels.max(initial=0))
    ranges = np.searchsorted(face_labels, np.arange(max_label + 2))

    # Per-cell geometry (vectorized per shape group).
    cell_volumes = np.empty(ncells)
    cell_centers = np.empty((ncells, dim))
    cell_shapes_arr = np.empty(ncells, dtype=np.int64)
    max_npc = max(cells.shape[1] for cells, _ in groups)
    cell_nodes_all = np.full((ncells, max_npc), -1, dtype=np.int64)
    for gi, (cells, shape) in enumerate(groups):
        lo, hi = cell_offsets[gi], cell_offsets[gi + 1]
        coords = node_positions[cells]
        cell_volumes[lo:hi] = np.abs(shapes.volume(shape, coords))
        cell_centers[lo:hi] = shapes.barycenter(shape, coords)
        cell_shapes_arr[lo:hi] = shape
        cell_nodes_all[lo:hi, : cells.shape[1]] = cells

    # Face geometry.
    fcoords = node_positions[face_nodes]
    if dim == 2:
        face_areas = shapes.volume(shapes.SEG, fcoords)
        face_normals = shapes.face_normal_2d(fcoords)
        face_centers = fcoords.mean(axis=1)
    else:
        face_areas, face_normals, face_centers = shapes.face_geometry_3d(fcoords)

    # Normals point inner → outer (outward on the boundary).
    to_out = np.where(
        (face_cells[:, 1] >= 0)[:, None],
        cell_centers[face_cells[:, 1]] - cell_centers[face_cells[:, 0]],
        face_centers - cell_centers[face_cells[:, 0]],
    )
    flip = np.einsum("fd,fd->f", face_normals, to_out) < 0
    face_normals[flip] *= -1.0

    hybrid = len({shape for _, shape in groups}) > 1
    return UnstructuredMesh(
        dim=dim,
        node_positions=node_positions,
        cell_nodes=cell_nodes_all if hybrid else groups[0][0],
        cell_shape=-1 if hybrid else groups[0][1],
        cell_shapes=cell_shapes_arr,
        face_nodes=face_nodes,
        face_cells=face_cells,
        face_labels=face_labels,
        node_labels=None if node_labels is None else np.asarray(node_labels),
        cell_volumes=cell_volumes,
        cell_centers=cell_centers,
        face_areas=face_areas,
        face_normals=face_normals,
        face_centers=face_centers,
        face_label_ranges=ranges,
    )
