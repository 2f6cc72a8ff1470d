"""Distributed FVM: halo-based cell partitioning for 1st- and 2nd-order
schemes with O(boundary) communication (counterpart of
``stormx/parallel/fvm.py``).

* Cells are block-partitioned; each rank owns ``n_loc`` cells plus a
  TWO-DEEP halo (graph distance ≤ 2 through interior faces), what the
  2nd-order scheme needs: the LSQ gradients and limiters of the 1-halo
  cells (which feed the face reconstruction at owned-incident faces) read
  the 2-halo state.
* ONE ``all_gather`` per step moves only the shared boundary pool: each
  owner exports the cells any other rank needs.
* The rank's local face and cell tables are in global-id order, so every
  owned cell's flux accumulation runs in the serial marcher's order.
* Gradients and limiters are the SERIAL modules, run on a local mesh built
  from the rank's tables; only the boundary ghosts are applied by label
  mask.
* Every gather of a step goes through kernel K3 on the card: the rank
  builds one ``BandedGatherPlan`` per local table (face ← cell, cell ←
  face, cell ← adjacent cell, and the halo's send and receive maps), once
  per partition and device, and the serial modules take them as they take
  a ``DeviceMesh``'s.  K3 is bit-exact, so the trajectory does not change.

The JAX package runs the whole march as one ``lax.fori_loop`` inside one
``shard_map`` region; here each rank runs the same Python loop on its
slab and reads nothing back from the device until the final all-gather.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from stormx_torch.core.exceptions import StormError
from stormx_torch.fvm.flux import lax_friedrichs_flux
from stormx_torch.fvm.gradient import lsq_gradient_matrices, lsq_gradients
from stormx_torch.fvm.limiter import compute_limiters, cubic_limiter, cubic_second_limiter
from stormx_torch.ops.banded_gather import BandedGatherPlan
from stormx_torch.sparse.formats import host

__all__ = ["partition_fv", "sharded_fv_march", "PartitionedFv"]

# The rank's K3 plans, by local table: (attribute of the local mesh, table,
# source rows of the gathered field).
_PLANS = (
    ("bg_face_inner", "l_inner", "c_max"),
    ("bg_face_outer", "l_outer", "c_max"),
    ("bg_cell_face", "cf_ell", "f_max"),
    ("bg_cell_adj", "adj", "c_max"),
    ("bg_send", "send_slots", "n_loc"),
    ("bg_halo", "halo_src", "pool"),
)


class PartitionedFv:
    """Host-frozen per-rank tables: owned block + 2-deep halo + local faces.

    Local cell ids: [0, n_loc) owned, [n_loc, n_loc + h_max) halo slots
    (global-id-sorted, padded), c_max−1 = dump slot.  Local faces are all
    faces incident to owned ∪ 1-halo cells, global-id-sorted and padded
    with zero-area faces targeting the dump slot.

    ``dmesh`` is a :class:`~stormx_torch.mesh.DeviceMesh` (its tensors are
    read back to the host) or any object with the same fields.
    """

    def __init__(self, dmesh, num_parts: int, *, halo_depth: int = 2):
        n = dmesh.num_cells
        self.num_parts = num_parts
        self.n_loc = n_loc = -(-n // num_parts)
        self.n_global = n
        self.halo_depth = halo_depth

        fc = np.stack([host(dmesh.face_inner), host(dmesh.face_outer)], axis=1)
        ranges = np.asarray(dmesh.face_label_ranges)
        labels = np.searchsorted(ranges[1:], np.arange(len(fc)), side="right").astype(np.int64)
        normals = host(dmesh.face_normals)
        areas = host(dmesh.face_areas)
        fcenters = host(dmesh.face_centers)
        vols = host(dmesh.cell_volumes)
        ccenters = host(dmesh.cell_centers)
        dim = normals.shape[1]
        self.unique_labels = sorted(int(lb) for lb in np.unique(labels) if lb > 0)

        # Symmetric interior-face adjacency (edge list) for halo growth.
        interior = fc[:, 1] >= 0
        e0, e1 = fc[interior, 0], fc[interior, 1]
        rows_exp = np.concatenate([e0, e1])
        adj_flat = np.concatenate([e1, e0])

        owner = np.minimum(np.arange(n) // n_loc, num_parts - 1)

        halos, ring1_masks = [], []
        for p in range(num_parts):
            owned_mask = np.zeros(n, dtype=bool)
            owned_mask[p * n_loc : min((p + 1) * n_loc, n)] = True
            seen = owned_mask.copy()
            frontier = owned_mask
            halo_masks = []
            for _ in range(halo_depth):
                ring = np.zeros(n, dtype=bool)
                ring[adj_flat[frontier[rows_exp]]] = True
                ring &= ~seen
                seen |= ring
                halo_masks.append(ring)
                frontier = ring
            ring1_masks.append(owned_mask | halo_masks[0])
            halos.append(np.nonzero(seen & ~owned_mask)[0])
        h_max = max(max((len(h) for h in halos), default=0), 1)
        self.h_max = h_max
        c_max = n_loc + h_max + 1
        self.c_max = c_max
        dump = c_max - 1

        # Shared export pool: for each owner, the sorted union of its cells
        # any other rank's halo needs.
        exports = []
        for q in range(num_parts):
            need = np.concatenate([h[owner[h] == q] for h in halos])
            exports.append(np.unique(need).astype(np.int64))
        s_max = max(max((len(e) for e in exports), default=0), 1)
        self.s_max = s_max
        send = np.zeros((num_parts, s_max), dtype=np.int32)
        pool_pos = np.full(n, -1, dtype=np.int64)
        for q, e in enumerate(exports):
            send[q, : len(e)] = (e - q * n_loc).astype(np.int32)
            pool_pos[e] = q * s_max + np.arange(len(e))
        self.send_slots = send

        halo_src = np.zeros((num_parts, h_max), dtype=np.int32)
        for p, h in enumerate(halos):
            halo_src[p, : len(h)] = pool_pos[h]
        self.halo_src = halo_src

        # Local faces per rank: incident to owned ∪ 1-halo.
        sel = []
        for p in range(num_parts):
            r1 = ring1_masks[p]
            m = r1[fc[:, 0]] | ((fc[:, 1] >= 0) & r1[np.maximum(fc[:, 1], 0)])
            sel.append(np.nonzero(m)[0])
        f_max = max(max((len(s) for s in sel), default=0), 1)
        self.f_max = f_max

        # Global → local cell id per rank.
        loc_of = np.full((num_parts, n), dump, dtype=np.int64)
        for p in range(num_parts):
            owned = np.arange(p * n_loc, min((p + 1) * n_loc, n))
            loc_of[p, owned] = owned - p * n_loc
            loc_of[p, halos[p]] = n_loc + np.arange(len(halos[p]))

        def pad_faces(build, tail, dtype, fill=0):
            out = np.full((num_parts, f_max) + tail, fill, dtype=dtype)
            for p, s in enumerate(sel):
                out[p, : len(s)] = build(p, s)
            return out

        self.f_normals = pad_faces(lambda p, s: normals[s], (dim,), normals.dtype)
        dummy = np.all(self.f_normals == 0.0, axis=-1)
        self.f_normals[dummy, 0] = 1.0  # keep the flux decomposition finite
        self.f_areas = pad_faces(lambda p, s: areas[s], (), areas.dtype)
        self.f_centers = pad_faces(lambda p, s: fcenters[s], (dim,), fcenters.dtype)
        self.f_labels = pad_faces(lambda p, s: labels[s], (), np.int32)
        self.l_inner = pad_faces(lambda p, s: loc_of[p, fc[s, 0]], (), np.int32, dump)
        # Boundary faces: outer ← inner (the serial path's pre-ghost base).
        self.l_outer = pad_faces(
            lambda p, s: np.where(
                fc[s, 1] >= 0, loc_of[p, np.maximum(fc[s, 1], 0)], loc_of[p, fc[s, 0]]
            ),
            (), np.int32, dump,
        )

        # Per-rank cell tables (owned + halo slots + dump), geometry padded
        # to stay finite.
        self.c_vols = np.ones((num_parts, c_max), dtype=vols.dtype)
        self.c_centers = np.zeros((num_parts, c_max, dim), dtype=ccenters.dtype)
        g_adj = host(dmesh.cell_adj_ell)
        g_cf_all = host(dmesh.cell_face_ell)
        g_sign_all = host(dmesh.cell_face_sign)
        Ka, Kf = g_adj.shape[1], g_cf_all.shape[1]
        self.adj = np.tile(np.arange(c_max, dtype=np.int32)[None, :, None], (num_parts, 1, Ka))
        self.cf_ell = np.zeros((num_parts, c_max, Kf), dtype=np.int32)
        self.cf_sign = np.zeros((num_parts, c_max, Kf), dtype=vols.dtype)

        for p in range(num_parts):
            locs = np.nonzero(loc_of[p] != dump)[0]  # global ids present
            lids = loc_of[p, locs]
            self.c_vols[p, lids] = vols[locs]
            self.c_centers[p, lids] = ccenters[locs]
            # Adjacency for owned + 1-halo cells only (2-halo keeps self ⇒
            # zero gradient there; never read at owned-incident faces).
            # With halo_depth < 2 only owned cells get full adjacency
            # (enough for order-1 marching, which never reads it).
            core_mask = ring1_masks[p] if halo_depth >= 2 else (loc_of[p] < n_loc)
            core = np.nonzero(core_mask)[0].astype(np.int64)
            core_l = loc_of[p, core]
            a = loc_of[p, g_adj[core]]  # (|core|, Ka); missing → dump
            # Self-padded slots in the global table map to the cell itself.
            self_mask = g_adj[core] == core[:, None]
            a = np.where(self_mask, core_l[:, None], a)
            # Any adjacency outside the local set would be a halo-depth bug.
            if (a == dump).any():
                raise AssertionError("halo too shallow for adjacency")
            self.adj[p, core_l] = a
            # Face incidence for owned + 1-halo (faces all present locally).
            gsel = sel[p]
            gpos = np.full(len(fc), -1, dtype=np.int64)
            gpos[gsel] = np.arange(len(gsel))
            g_cf = g_cf_all[core]
            g_sign = g_sign_all[core]
            lf = gpos[g_cf]
            if (lf[g_sign != 0] < 0).any():
                raise AssertionError("incident face missing from local set")
            self.cf_ell[p, core_l] = np.where(g_sign != 0, lf, 0).astype(np.int32)
            self.cf_sign[p, core_l] = g_sign
        self._local = {}

    def tables(self):
        """The 13 per-rank tables, stacked over the ranks, as CPU tensors
        (the JAX package's operands of the march)."""
        return tuple(
            torch.as_tensor(a)
            for a in (
                self.f_normals, self.f_areas, self.f_centers, self.f_labels,
                self.l_inner, self.l_outer, self.c_vols, self.c_centers,
                self.adj, self.cf_ell, self.cf_sign, self.send_slots,
                self.halo_src,
            )
        )

    def local_mesh(self, rank: int, device, dtype):
        """Rank ``rank``'s tables on ``device`` (real ones in ``dtype``) as a
        local mesh the serial FVM modules read: ``num_cells`` = c_max,
        ``cell_*``, ``face_*``, the index tables, and one K3 plan per table
        (``bg_*``; a CPU device applies them through K3's plain version).
        Built once per (rank, device, dtype) and kept."""
        device = torch.device(device)
        key = (rank, str(device), dtype)
        if key in self._local:
            return self._local[key]

        def reals(a):
            return torch.as_tensor(np.ascontiguousarray(a[rank]), device=device).to(dtype)

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a[rank]).astype(np.int64),
                                   device=device)

        lm = SimpleNamespace(
            num_cells=self.c_max, n_loc=self.n_loc,
            cell_centers=reals(self.c_centers), cell_volumes=reals(self.c_vols),
            cell_adj_ell=ints(self.adj), cell_face_ell=ints(self.cf_ell),
            cell_face_sign=reals(self.cf_sign),
            face_normals=reals(self.f_normals), face_areas=reals(self.f_areas),
            face_centers=reals(self.f_centers), face_labels=ints(self.f_labels),
            l_inner=ints(self.l_inner), l_outer=ints(self.l_outer),
            send_slots=ints(self.send_slots), halo_src=ints(self.halo_src),
        )
        sources = {"c_max": self.c_max, "f_max": self.f_max, "n_loc": self.n_loc,
                   "pool": self.num_parts * self.s_max}
        for attr, table, src in _PLANS:
            idx = getattr(self, table)[rank].reshape(-1)
            setattr(lm, attr, BandedGatherPlan(idx, sources[src], device=device))
        self._local[key] = lm
        return lm

    def __getstate__(self):
        # Ranks get the host tables; each builds its own local mesh.
        state = dict(self.__dict__)
        state["_local"] = {}
        return state


def partition_fv(dmesh, num_parts: int, *, halo_depth: int = 2) -> PartitionedFv:
    """Block-partition the cells of a device mesh for distributed marching."""
    return PartitionedFv(dmesh, num_parts, halo_depth=halo_depth)


def halo_exchange(lm, mesh, u: torch.Tensor) -> torch.Tensor:
    """The rank's owned rows ``u`` (n_loc, ...) extended to its local cells
    (c_max, ...): one all-gather of the export pool, its halo rows taken
    from it, and the dump slot a copy of row 0."""
    pool = mesh.all_gather(lm.bg_send(u))  # (P, s_max, ...)
    u_halo = lm.bg_halo(pool.reshape((-1,) + tuple(u.shape[1:])))
    return torch.cat([u, u_halo, u[:1]])


def sharded_fv_march(
    pfv: PartitionedFv,
    u0,
    dt: float,
    num_steps: int,
    *,
    bcs,
    flux_scheme=lax_friedrichs_flux,
    mesh=None,
    order: int = 1,
    slope_limiter=cubic_limiter,
    second_limiter=cubic_second_limiter,
):
    """March ``num_steps`` forward-Euler steps of 1st- or 2nd-order upwind
    convection with the state partitioned over the ranks of ``mesh``
    (default: :func:`make_device_mesh` on the default group).

    ``u0``: the global (num_cells, nv) conserved state, the same on every
    rank; returns the global marched state on every rank.  Matches the
    serial ``FvSolver(order=order).march`` step for step.  Per step the
    ranks exchange ONE all-gather of the shared boundary pool.  On the card
    every gather is one of the rank's K3 plans
    (:meth:`PartitionedFv.local_mesh`).
    """
    from stormx_torch.parallel.sharded import _mesh_for

    if order == 2 and pfv.halo_depth < 2:
        raise ValueError("order-2 march needs partition_fv(..., halo_depth=2)")
    mesh = _mesh_for(pfv.num_parts, mesh)
    r, dev = mesh.rank, mesh.device
    missing = [label for label in pfv.unique_labels if label not in bcs]
    if missing:
        raise StormError(
            f"boundary labels {missing} have faces but no boundary condition;"
            " pass a BC for every label (reference SkunkFvSolver.hpp:73-74)"
        )
    u0 = (u0 if isinstance(u0, torch.Tensor) else torch.as_tensor(np.asarray(u0))).to(dev)
    n, nv = u0.shape
    n_loc = pfv.n_loc
    # Padding cells hold a valid state (never referenced by real faces).
    u = u0[r * n_loc : min((r + 1) * n_loc, n)]
    if u.shape[0] < n_loc:
        u = torch.cat([u, u0[:1].expand(n_loc - u.shape[0], nv)])
    lm = pfv.local_mesh(r, dev, u0.dtype)
    bc_items = tuple((lm.face_labels == label, bcs[label]) for label in pfv.unique_labels)
    f_n, f_c = lm.face_normals, lm.face_centers

    def ghosts(u_in, u_out):
        for mask, bc in bc_items:
            u_out = torch.where(mask[:, None], bc(f_n, f_c, u_in), u_out)
        return u_out

    if order == 2:
        g_mats = lsq_gradient_matrices(lm)
        # Face reconstruction offsets: geometry, the same every step.
        dr_in = f_c - lm.bg_face_inner(lm.cell_centers)
        dr_out = f_c - lm.bg_face_outer(lm.cell_centers)

    def divergence(u_full):
        if order == 1:
            u_in = lm.bg_face_inner(u_full)
            u_out = ghosts(u_in, lm.bg_face_outer(u_full))
        else:
            grad = lsq_gradients(lm, u_full, g_mats)  # (c_max, nv, d)
            lim = compute_limiters(lm, u_full, grad, slope_limiter=slope_limiter,
                                   second_limiter=second_limiter)
            grad = grad * lim[..., None]
            grad_flat = grad.reshape(lm.num_cells, -1)
            grad_i = lm.bg_face_inner(grad_flat).reshape((-1,) + tuple(grad.shape[1:]))
            grad_o = lm.bg_face_outer(grad_flat).reshape((-1,) + tuple(grad.shape[1:]))
            u_in = lm.bg_face_inner(u_full) + (grad_i * dr_in[:, None, :]).sum(-1)
            u_rec_out = lm.bg_face_outer(u_full) + (grad_o * dr_out[:, None, :]).sum(-1)
            # Boundary ghosts act on the RECONSTRUCTED inner state; interior
            # faces keep the reconstructed outer value (labels are 0 there).
            u_out = ghosts(u_in, u_rec_out)
        flux = flux_scheme(f_n, u_out, u_in)
        af = flux * lm.face_areas[:, None]
        g = lm.bg_cell_face(af).reshape(lm.num_cells, lm.cell_face_ell.shape[1], nv)
        acc = torch.sum(lm.cell_face_sign[..., None] * g, dim=1)
        return acc / lm.cell_volumes[:, None]

    for _ in range(num_steps):
        div = divergence(halo_exchange(lm, mesh, u))
        u = u - dt * div[:n_loc]
    return mesh.all_gather(u).reshape(-1, nv)[:n]
