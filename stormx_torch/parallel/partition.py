"""Orderings and the partitioned CSR operator (counterpart of
``stormx/parallel/partition.py``).

Two layouts, as in the JAX package:

* ``method="rcm-blocks"``: cells reordered by reverse Cuthill–McKee and
  split into equal contiguous blocks, one per rank;
* ``method="bfs"``: balanced BFS graph growing, each part laid out in RCM
  order.

RCM and the BFS growing run in the port's native host runtime
(``stormx_torch._native``) with pure-NumPy fallbacks; the host code is a
copy of the JAX package's, so permutations, slots and halo tables are its
arrays bit for bit.

Halo model: the union S of all cells referenced across a partition boundary
is laid out in a fixed per-partition-padded order.  At each product every
rank contributes its owned shared cells and one ``all_gather`` over the
ranks materializes S everywhere; local ELL columns point either at owned
slots [0, n_pad) or at S slots [n_pad, n_pad + P·s_max).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.sparse.formats import host

__all__ = [
    "rcm_order",
    "bandwidth_order",
    "bfs_partition",
    "PartitionedOperator",
    "partition_csr",
    "partition_vector",
    "unpartition_vector",
]


def _csr_adjacency(n: int, rows: np.ndarray, cols: np.ndarray):
    """Symmetrized, deduplicated, self-loop-free CSR adjacency (vectorized)."""
    rows = np.concatenate([rows, cols])
    cols_sym = np.concatenate([cols, rows[: len(cols)]])
    mask = rows != cols_sym
    r, c = rows[mask], cols_sym[mask]
    order_rc = np.lexsort((c, r))
    r, c = r[order_rc], c[order_rc]
    keep = np.ones(len(r), dtype=bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c = r[keep], c[keep]
    deg = np.bincount(r, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    return ptr, c.astype(np.int64), deg


def _rcm_python(n: int, ptr: np.ndarray, c: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Pure-NumPy RCM BFS (fallback when the native library is unavailable)."""
    visited = np.zeros(n, dtype=bool)
    result = np.empty(n, dtype=np.int64)
    pos = 0
    order_by_degree = np.argsort(deg, kind="stable")
    for seed in order_by_degree:
        if visited[seed]:
            continue
        visited[seed] = True
        result[pos] = seed
        pos += 1
        head = pos - 1
        while head < pos:
            u = result[head]
            head += 1
            nbrs = c[ptr[u] : ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                result[pos : pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    return result[::-1].copy()


def rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee ordering from an edge list (symmetrized).

    Returns ``order`` with ``order[new] = old``.
    """
    ptr, c, deg = _csr_adjacency(n, np.asarray(rows), np.asarray(cols))
    from stormx_torch._native import native_rcm_order

    out = native_rcm_order(ptr, c)
    if out is not None:
        return out
    return _rcm_python(n, ptr, c, deg)


def bandwidth_order(
    n: int, rows: np.ndarray, cols: np.ndarray, coords: np.ndarray | None = None
) -> np.ndarray:
    """Minimum-bandwidth ordering: best of RCM and (when cell ``coords`` are
    given) lexicographic coordinate sorts along each axis.  Returns
    ``order[new] = old``.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)

    def bw(perm):
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        d = inv[cols] - inv[rows]
        return int(-d.min(initial=0)) + int(d.max(initial=0))

    candidates = [rcm_order(n, rows, cols)]
    if coords is not None:
        coords = np.asarray(coords)
        span = coords.max(axis=0) - coords.min(axis=0)
        eps = 1e-9 * (span.max() + 1.0)
        for ax in range(coords.shape[1]):
            others = [a for a in range(coords.shape[1]) if a != ax]
            key = coords[:, ax].copy()
            for o in others:
                key = key + eps * coords[:, o]
            candidates.append(np.argsort(key, kind="stable").astype(np.int64))
    widths = [bw(p) for p in candidates]
    return candidates[int(np.argmin(widths))]


def _bfs_partition_python(
    n: int, ptr: np.ndarray, c: np.ndarray, deg: np.ndarray, k: int
) -> np.ndarray:
    """Pure-Python balanced BFS growing (mirrors the native algorithm)."""
    target = -(-n // k)
    by_degree = np.argsort(deg, kind="stable")
    assigned = np.zeros(n, dtype=bool)
    part = np.empty(n, dtype=np.int64)
    seed_cursor = 0
    spill: list[int] = []
    for p in range(k):
        count = 0
        queue = spill
        spill = []
        head = 0
        while count < target:
            if head >= len(queue):
                while seed_cursor < n and assigned[by_degree[seed_cursor]]:
                    seed_cursor += 1
                if seed_cursor >= n:
                    break
                queue.append(int(by_degree[seed_cursor]))
            u = queue[head]
            head += 1
            if assigned[u]:
                continue
            assigned[u] = True
            part[u] = p
            count += 1
            for v in c[ptr[u] : ptr[u + 1]]:
                if not assigned[v]:
                    queue.append(int(v))
        spill = [u for u in queue[head:] if not assigned[u]]
    part[~assigned] = k - 1
    return part


def bfs_partition(n: int, rows: np.ndarray, cols: np.ndarray, k: int) -> np.ndarray:
    """Balanced BFS k-way partition labels from an edge list.

    Each part holds at most ceil(n/k) nodes; boundaries follow BFS
    frontiers (METIS-style graph growing, deterministic).
    """
    ptr, c, deg = _csr_adjacency(n, np.asarray(rows), np.asarray(cols))
    from stormx_torch._native import native_bfs_partition

    out = native_bfs_partition(ptr, c, k)
    if out is not None:
        return out
    return _bfs_partition_python(n, ptr, c, deg, k)


def _ell_rows(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[i] = Σ_k data[i, k]·x[cols[i, k]], summed k = 0..K−1 in order, so a
    row's bits do not depend on how many rows are reduced together (the
    overlapped product recomputes boundary rows apart from the rest)."""
    prod = data * x[cols]
    y = prod[:, 0]
    for k in range(1, prod.shape[1]):
        y = y + prod[:, k]
    return y


@dataclass(frozen=True)
class PartitionedOperator:
    """A sparse operator split into P rank-local ELL blocks.

    The arrays keep the JAX package's stacked leading axis (one entry per
    rank); rank r reads entry r.  Index arrays are int32, as the JAX
    package's.
    """

    num_parts: int
    n_global: int  # true (unpadded) size
    n_pad: int  # owned-row slots per partition (padded)
    s_max: int  # shared-cells slots per partition (padded)
    data: torch.Tensor  # (P, n_pad, K)
    cols: torch.Tensor  # (P, n_pad, K) local column ids
    send_slots: torch.Tensor  # (P, s_max) local owned slots exported to S
    perm: np.ndarray  # layout order: perm[i] = old id of i-th laid-out row
    fill_slots: np.ndarray  # padded slot of the i-th laid-out row
    # Boundary rows (those whose ELL entries reference foreign columns),
    # duplicated so they can be recomputed after the all_gather lands while
    # the interior rows proceed without it.
    bnd_idx: torch.Tensor  # (P, B) local slots of boundary rows (pad → n_pad)
    bnd_data: torch.Tensor  # (P, B, K)
    bnd_cols: torch.Tensor  # (P, B, K)

    def local_matvec(self, axis_name, *, overlap: bool = True):
        """Rank-local product ``x_loc (n_pad,) → y (n_pad,)`` for the rank of
        ``axis_name`` (its :class:`~stormx_torch.parallel.comm.RankMesh`), with
        that rank's arrays bound on its device: one ``all_gather`` (halo) +
        gathers + row sums.

        ``overlap=True`` (default): the all-gather is started first, the
        bulk row pass reads foreign slots as zeros while it is in flight,
        and the boundary rows are recomputed from the landed halo and
        written over their partial results.  Interior rows never reference
        foreign slots and every row keeps its k-order sum, so the result is
        bit-identical to the unoverlapped path.
        """
        mesh = axis_name
        r, dev = mesh.rank, mesh.device
        n_pad, s_max, p = self.n_pad, self.s_max, mesh.size
        data = self.data[r].to(dev)
        cols = self.cols[r].to(dev).long()
        send = self.send_slots[r].to(dev).long()
        bidx = self.bnd_idx[r].to(dev).long()
        bdata = self.bnd_data[r].to(dev)
        bcols = self.bnd_cols[r].to(dev).long()

        def matvec(x_loc):
            contrib = x_loc[send]  # (s_max,)
            if not overlap:
                shared = mesh.all_gather(contrib)  # (P, s_max)
                return _ell_rows(data, cols, torch.cat([x_loc, shared.reshape(-1)]))
            pending = mesh.all_gather(contrib, async_op=True)
            y = _ell_rows(data, cols, torch.cat([x_loc, x_loc.new_zeros(p * s_max)]))
            x_ext = torch.cat([x_loc, pending.wait().reshape(-1)])
            y_pad = torch.cat([y, y.new_zeros(1)])
            y_pad[bidx] = _ell_rows(bdata, bcols, x_ext)
            return y_pad[:n_pad]

        return matvec


def partition_csr(
    csr, num_parts: int, *, method: str = "rcm-blocks", reorder: bool = True,
    device="cuda",
) -> PartitionedOperator:
    """Partition a CSR operator into P local ELL blocks (host-side).

    ``method="rcm-blocks"``: RCM order split into contiguous blocks.
    ``method="bfs"``: balanced BFS graph growing, RCM layout within parts.
    ``reorder=False``: natural order, contiguous blocks (debug).  The
    arrays go to ``device``, the card unless the caller asks for the CPU.
    """
    dev = resolve_device(device)
    n = csr.shape[0]
    row_ptr = host(csr.row_ptr)
    indices = host(csr.indices)
    data = host(csr.data)
    counts = np.diff(row_ptr)
    rows = np.repeat(np.arange(n), counts)

    P = num_parts
    n_pad = -(-n // P)

    # --- Layout: perm (ordered old ids), fill_slots (padded slot of each). --
    if not reorder:
        perm = np.arange(n, dtype=np.int64)
        fill_slots = np.arange(n, dtype=np.int64)
    elif method == "rcm-blocks":
        perm = rcm_order(n, rows, indices.astype(np.int64))
        fill_slots = np.arange(n, dtype=np.int64)
    elif method == "bfs":
        part_of_old = bfs_partition(n, rows, indices.astype(np.int64), P)
        rcm = rcm_order(n, rows, indices.astype(np.int64))
        rcm_pos = np.empty(n, dtype=np.int64)
        rcm_pos[rcm] = np.arange(n)
        # Order: by part, then RCM position within the part.
        perm = np.lexsort((rcm_pos, part_of_old))
        part_sorted = part_of_old[perm]
        sizes = np.bincount(part_sorted, minlength=P)
        if sizes.max() > n_pad:
            raise ValueError("bfs_partition produced an oversized part")
        starts = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        within = np.arange(n) - starts[part_sorted]
        fill_slots = part_sorted * n_pad + within
    else:
        raise ValueError(f"unknown partition method {method!r}")

    # Slot id of every old row/col id.
    slot_of_old = np.empty(n, dtype=np.int64)
    slot_of_old[perm] = fill_slots

    srow = slot_of_old[rows]
    scol = slot_of_old[indices]

    def part_of(s):
        return s // n_pad

    def within_of(s):
        return s % n_pad

    # Shared set S: column slots referenced across a partition boundary.
    cross = part_of(srow) != part_of(scol)
    S = np.unique(scol[cross])
    s_part = part_of(S)
    s_counts = np.bincount(s_part, minlength=P)
    s_max = int(s_counts.max()) if len(S) else 1
    s_starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(s_counts, out=s_starts[1:])
    s_pos_within = np.arange(len(S)) - s_starts[s_part]
    shared_slot = s_part * s_max + s_pos_within  # position in flat S buffer
    shared_lookup = np.full(P * n_pad, -1, dtype=np.int64)
    shared_lookup[S] = shared_slot

    send_slots = np.zeros((P, s_max), dtype=np.int32)
    send_slots[s_part, s_pos_within] = within_of(S).astype(np.int32)

    # Local ELL: row width K = global max row count.
    K = int(counts.max()) if n else 0
    data_l = np.zeros((P, n_pad, K), dtype=data.dtype)
    cols_l = np.zeros((P, n_pad, K), dtype=np.int32)
    p_r = part_of(srow)
    within_r = within_of(srow)
    # Column mapping: owned → within-slot; foreign → n_pad + shared position.
    same = part_of(scol) == p_r
    local_col = np.where(
        same, within_of(scol), n_pad + shared_lookup[scol]
    ).astype(np.int32)
    # Row-local nonzero position: order nonzeros by (slot row, original order).
    within_orig = np.arange(len(rows)) - row_ptr[:-1].astype(np.int64)[rows]
    order_nz = np.lexsort((within_orig, srow))
    sr = srow[order_nz]
    starts_r = np.searchsorted(sr, np.arange(P * n_pad))
    pos_in_row = np.arange(len(sr)) - starts_r[sr]
    data_l[p_r[order_nz], within_r[order_nz], pos_in_row] = data[order_nz]
    cols_l[p_r[order_nz], within_r[order_nz], pos_in_row] = local_col[order_nz]

    # Boundary rows (any foreign column) per partition, duplicated for the
    # overlapped matvec; padding rows point at the n_pad dump slot with
    # all-zero data.
    has_foreign = (cols_l >= n_pad).any(axis=2)  # (P, n_pad)
    b_counts = has_foreign.sum(axis=1)
    B = max(int(b_counts.max()) if P else 0, 1)
    bnd_idx = np.full((P, B), n_pad, dtype=np.int32)
    bnd_data = np.zeros((P, B, K), dtype=data.dtype)
    bnd_cols = np.zeros((P, B, K), dtype=np.int32)
    for p in range(P):
        slots = np.nonzero(has_foreign[p])[0]
        bnd_idx[p, : len(slots)] = slots
        bnd_data[p, : len(slots)] = data_l[p, slots]
        bnd_cols[p, : len(slots)] = cols_l[p, slots]

    def t(a):
        return torch.as_tensor(a, device=dev)

    return PartitionedOperator(
        num_parts=P,
        n_global=n,
        n_pad=n_pad,
        s_max=s_max,
        data=t(data_l),
        cols=t(cols_l),
        send_slots=t(send_slots),
        perm=perm,
        fill_slots=fill_slots,
        bnd_idx=t(bnd_idx),
        bnd_data=t(bnd_data),
        bnd_cols=t(bnd_cols),
    )


def _as_tensor(x, device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def partition_vector(pop: PartitionedOperator, x) -> torch.Tensor:
    """Global (n,) vector → (P, n_pad) partitioned layout, on ``x``'s device
    (the operator's for a NumPy array)."""
    x = _as_tensor(x, pop.data.device)
    out = torch.zeros(pop.num_parts * pop.n_pad, dtype=x.dtype, device=x.device)
    fill = torch.as_tensor(pop.fill_slots, device=x.device)
    out[fill] = x[torch.as_tensor(pop.perm, device=x.device)]
    return out.reshape(pop.num_parts, pop.n_pad)


def unpartition_vector(pop: PartitionedOperator, xp) -> torch.Tensor:
    """(P, n_pad) partitioned layout → global (n,) vector."""
    flat = _as_tensor(xp, pop.data.device).reshape(-1)
    inv = np.empty(pop.n_global, dtype=np.int64)
    inv[pop.perm] = np.arange(pop.n_global)
    # out[perm[i]] = flat[fill_slots[i]]  ⇔  out = flat[fill_slots][inv].
    return flat[torch.as_tensor(pop.fill_slots[inv], device=flat.device)]
