"""Distributed BSR operators, BASELINE config #3's partitioned path
(counterpart of ``stormx/parallel/bsr.py``).

The block rows drop into the layout machinery of the scalar partitioner
(:mod:`stormx_torch.parallel.partition`) with BLOCK columns: each rank owns
a contiguous (RCM-ordered) range of block rows.  Two layouts:

* :class:`PartitionedBSR` — the shared set S is the union of block columns
  referenced across rank boundaries, and one ``all_gather`` of each rank's
  export pool is the halo;
* :class:`PartitionedBandedBSR` — after RCM the block bandwidth is small,
  so a slab needs only h-deep block strips of its two neighbours: one
  ``RankMesh.exchange`` whose bytes per link do not grow with P.

The block products are broadcast multiply-sums, as ``BSR.matvec``'s: on
small blocks ``torch.einsum`` runs as batched matrix products far below the
card's memory rate.  The solvers see each rank's (nb_pad, b) block layout
as one flat vector of nb_pad·b entries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.parallel.partition import bfs_partition, rcm_order
from stormx_torch.sparse.formats import host

__all__ = [
    "PartitionedBSR",
    "PartitionedBandedBSR",
    "partition_bsr",
    "partition_bsr_banded",
    "partition_bsr_vector",
    "unpartition_bsr_vector",
    "sharded_bsr_solve",
]


def _contract(blocks: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Σ_k blocks[r, k] @ g[r, k]: (rows, K, b, b) × (rows, K, b) → (rows, b),
    as ``BSR.matvec`` sums it."""
    return (blocks * g[:, :, None, :]).sum(dim=(1, 3))


def _diag_inv(pb, rows: np.ndarray, rank: int | None) -> torch.Tensor:
    """Inverted diagonal blocks of ``pb`` on its blocks' device: (P, nb_pad,
    b, b), or rank ``rank``'s (nb_pad, b, b) alone.  The block of row w sits
    where ``cols[p, w] == rows[w]``; an empty row gets the identity."""
    parts = range(pb.num_parts) if rank is None else [rank]
    diag = []
    for p in parts:
        blocks, mask = host(pb.blocks[p]), host(pb.cols[p]) == rows[:, None]
        d = (blocks * mask[..., None, None]).sum(axis=1)
        d[np.abs(d).max(axis=(1, 2)) == 0] = np.eye(pb.block_size)
        diag.append(d)
    inv = torch.as_tensor(np.linalg.inv(np.stack(diag)), device=pb.blocks.device)
    return inv if rank is None else inv[0]


@dataclass(frozen=True)
class PartitionedBSR:
    """A BSR operator split into P rank-local block-ELL blocks."""

    num_parts: int
    nb_global: int  # true block-row count
    nb_pad: int  # owned block-row slots per partition
    s_max: int  # shared block slots per partition
    block_size: int
    blocks: torch.Tensor  # (P, nb_pad, K, b, b)
    cols: torch.Tensor  # (P, nb_pad, K) local block-column ids
    send_slots: torch.Tensor  # (P, s_max)
    perm: np.ndarray  # perm[new] = old block-row id
    fill_slots: np.ndarray

    def op_arrays(self) -> tuple:
        return (self.blocks, self.cols, self.send_slots)

    def extract_diag_inv(self, rank: int | None = None) -> torch.Tensor:
        """(P, nb_pad, b, b) inverted diagonal blocks (block-Jacobi), on the
        blocks' device; with ``rank``, that rank's (nb_pad, b, b) alone."""
        return _diag_inv(self, np.arange(self.nb_pad), rank)

    def local_matvec(self, axis_name):
        """(nb_pad, b) → (nb_pad, b) block product of the rank of
        ``axis_name`` (its mesh handle): one all-gather halo, one block
        gather, one block contraction."""
        mesh = axis_name
        r, dev, b = mesh.rank, mesh.device, self.block_size
        blocks = self.blocks[r].to(dev)
        cols = self.cols[r].to(dev).long()
        send = self.send_slots[r].to(dev).long()

        def matvec(x_loc):
            shared = mesh.all_gather(x_loc[send])  # (P, s_max, b)
            x_ext = torch.cat([x_loc, shared.reshape(-1, b)])
            return _contract(blocks, x_ext[cols])

        return matvec


@dataclass(frozen=True)
class PartitionedBandedBSR:
    """A BSR operator split into P contiguous RCM-ordered block-row slabs
    with neighbour-only halos.

    Local block columns index the extended layout ``[left h_lo | owned
    nb_pad | right h_hi]``; the outer edges are zero-filled, which is right
    because live blocks never reference columns out of range.  Dead
    (padding) blocks keep column 0.
    """

    num_parts: int
    nb_global: int
    nb_pad: int  # owned block rows per partition
    h_lo: int  # lower block bandwidth (left-halo depth)
    h_hi: int  # upper block bandwidth (right-halo depth)
    block_size: int
    blocks: torch.Tensor  # (P, nb_pad, K, b, b)
    cols: torch.Tensor  # (P, nb_pad, K) extended-local block cols
    perm: np.ndarray  # perm[new] = old block-row id
    fill_slots: np.ndarray

    def op_arrays(self) -> tuple:
        return (self.blocks, self.cols)

    def extract_diag_inv(self, rank: int | None = None) -> torch.Tensor:
        """As :meth:`PartitionedBSR.extract_diag_inv`; the diagonal block of
        owned row w sits at extended column h_lo + w."""
        return _diag_inv(self, np.arange(self.nb_pad) + self.h_lo, rank)

    def local_matvec(self, axis_name, *, overlap: bool = True):
        """(nb_pad, b) → (nb_pad, b) with neighbour halo shifts.  With
        ``overlap`` the interior block rows (whose band stays inside the
        owned slab) are computed while the shifts are in flight; every row
        sums its blocks in the same order either way, so the result is
        bit-identical to the unoverlapped path."""
        mesh = axis_name
        r, dev = mesh.rank, mesh.device
        h_lo, h_hi, nb_pad = self.h_lo, self.h_hi, self.nb_pad
        blocks = self.blocks[r].to(dev)
        cols = self.cols[r].to(dev).long()

        def shifts(x_loc, async_op=False):
            # My tail → next rank's left halo; my head → previous rank's
            # right halo (a halo of width 0 moves nothing).
            return mesh.exchange(x_loc[nb_pad - h_lo :] if h_lo else None,
                                 x_loc[:h_hi] if h_hi else None, async_op=async_op)

        def extended(x_loc, halos):
            return torch.cat([t for t in (halos[0], x_loc, halos[1]) if t is not None])

        lo_b, hi_b = h_lo, nb_pad - h_hi  # interior owned rows [lo_b, hi_b)
        if not overlap or hi_b <= lo_b:
            def matvec(x_loc):
                return _contract(blocks, extended(x_loc, shifts(x_loc))[cols])

            return matvec

        # Interior rows reference extended columns in [h_lo, h_lo + nb_pad):
        # x_loc alone.
        blocks_mid, cols_mid = blocks[lo_b:hi_b], cols[lo_b:hi_b] - h_lo
        blocks_head, cols_head = blocks[:lo_b], cols[:lo_b]
        blocks_tail, cols_tail = blocks[hi_b:], cols[hi_b:]

        def matvec(x_loc):
            pending = shifts(x_loc, async_op=True)  # started before the interior
            y_mid = _contract(blocks_mid, x_loc[cols_mid])
            x_ext = extended(x_loc, pending.wait())
            return torch.cat([_contract(blocks_head, x_ext[cols_head]), y_mid,
                              _contract(blocks_tail, x_ext[cols_tail])])

        return matvec


def _block_graph(bsr):
    """(blocks, cols, live, rows_e, cols_e) of a BSR on the host: the live
    (not all-zero) blocks as an edge list of the block graph."""
    blocks = host(bsr.blocks)  # (nb, K, b, b)
    cols = host(bsr.cols).astype(np.int64)
    nb, K = cols.shape
    live = np.abs(blocks).max(axis=(2, 3)) != 0  # (nb, K)
    rows_e = np.repeat(np.arange(nb), K)[live.reshape(-1)]
    cols_e = cols.reshape(-1)[live.reshape(-1)]
    return blocks, cols, live, rows_e, cols_e


def partition_bsr_banded(bsr, num_parts: int, *, device="cuda") -> PartitionedBandedBSR:
    """RCM-order the block rows and split them into P contiguous slabs with
    the neighbour-halo (banded) layout.  The block bandwidth after RCM must
    fit one neighbour each way (h ≤ nb_pad).  The arrays go to ``device``,
    the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    blocks, cols, live, rows_e, cols_e = _block_graph(bsr)
    nb, K, b, _ = blocks.shape

    Pn = num_parts
    nb_pad = -(-nb // Pn)
    perm = rcm_order(nb, rows_e, cols_e)
    inv = np.empty(nb, dtype=np.int64)
    inv[perm] = np.arange(nb)
    d = inv[cols_e] - inv[rows_e]
    h_lo = int(max(-(d.min(initial=0)), 0))
    h_hi = int(max(d.max(initial=0), 0))
    if max(h_lo, h_hi) > nb_pad:
        raise ValueError(
            f"block band ({h_lo}/{h_hi}) exceeds slab rows {nb_pad}; "
            "use fewer parts or the pooled layout (partition_bsr)"
        )

    # Row old → slab (p, w); its columns in the extended local layout.
    p, w = np.divmod(inv, nb_pad)
    blocks_l = np.zeros((Pn, nb_pad, K, b, b), dtype=blocks.dtype)
    cols_l = np.zeros((Pn, nb_pad, K), dtype=np.int32)
    blocks_l[p, w] = blocks
    lc = inv[cols] - p[:, None] * nb_pad + h_lo
    cols_l[p, w] = np.where(live, lc, 0).astype(np.int32)
    assert (cols_l >= 0).all() and (cols_l < h_lo + nb_pad + h_hi).all()

    return PartitionedBandedBSR(
        num_parts=Pn,
        nb_global=nb,
        nb_pad=nb_pad,
        h_lo=h_lo,
        h_hi=h_hi,
        block_size=b,
        blocks=torch.as_tensor(blocks_l, device=dev),
        cols=torch.as_tensor(cols_l, device=dev),
        perm=perm,
        fill_slots=np.arange(nb, dtype=np.int64),
    )


def partition_bsr(
    bsr, num_parts: int, *, method: str = "rcm-blocks", reorder: bool = True,
    device="cuda",
) -> PartitionedBSR:
    """Partition a :class:`~stormx_torch.sparse.BSR` into P rank-local
    block-ELL blocks (host-side).  The arrays go to ``device``, the card
    unless the caller asks for the CPU."""
    dev = resolve_device(device)
    blocks, cols, live, rows_e, cols_e = _block_graph(bsr)
    nb, K, b, _ = blocks.shape

    Pn = num_parts
    nb_pad = -(-nb // Pn)
    if not reorder:
        perm = np.arange(nb, dtype=np.int64)
        fill_slots = np.arange(nb, dtype=np.int64)
    elif method == "rcm-blocks":
        perm = rcm_order(nb, rows_e, cols_e)
        fill_slots = np.arange(nb, dtype=np.int64)
    elif method == "bfs":
        part_of_old = bfs_partition(nb, rows_e, cols_e, Pn)
        rcm = rcm_order(nb, rows_e, cols_e)
        rcm_pos = np.empty(nb, dtype=np.int64)
        rcm_pos[rcm] = np.arange(nb)
        perm = np.lexsort((rcm_pos, part_of_old))
        part_sorted = part_of_old[perm]
        sizes = np.bincount(part_sorted, minlength=Pn)
        if sizes.max() > nb_pad:
            raise ValueError("bfs_partition produced an oversized part")
        starts = np.zeros(Pn + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        fill_slots = part_sorted * nb_pad + (np.arange(nb) - starts[part_sorted])
    else:
        raise ValueError(f"unknown partition method {method!r}")

    srow_of = np.empty(nb, dtype=np.int64)  # slot of each old block row
    srow_of[perm] = fill_slots

    # Shared block set: columns referenced across a partition boundary.
    srow = srow_of[rows_e]
    scol = srow_of[cols_e]
    cross = (srow // nb_pad) != (scol // nb_pad)
    S = np.unique(scol[cross])
    s_part = S // nb_pad
    s_counts = np.bincount(s_part, minlength=Pn)
    s_max = int(s_counts.max()) if len(S) else 1
    s_starts = np.zeros(Pn + 1, dtype=np.int64)
    np.cumsum(s_counts, out=s_starts[1:])
    s_pos = np.arange(len(S)) - s_starts[s_part]
    shared_lookup = np.full(Pn * nb_pad, -1, dtype=np.int64)
    shared_lookup[S] = s_part * s_max + s_pos
    send_slots = np.zeros((Pn, s_max), dtype=np.int32)
    send_slots[s_part, s_pos] = (S % nb_pad).astype(np.int32)

    # Row old → slot (p, w); owned columns by slot, foreign ones into the
    # pool after the owned slots.  Dead (all-zero) blocks keep column 0.
    p, w = np.divmod(srow_of, nb_pad)
    blocks_l = np.zeros((Pn, nb_pad, K, b, b), dtype=blocks.dtype)
    cols_l = np.zeros((Pn, nb_pad, K), dtype=np.int32)
    blocks_l[p, w] = blocks
    sc = srow_of[cols]
    same = (sc // nb_pad) == p[:, None]
    lc = np.where(same, sc % nb_pad, nb_pad + shared_lookup[sc])
    cols_l[p, w] = np.where(live, lc, 0).astype(np.int32)

    return PartitionedBSR(
        num_parts=Pn,
        nb_global=nb,
        nb_pad=nb_pad,
        s_max=s_max,
        block_size=b,
        blocks=torch.as_tensor(blocks_l, device=dev),
        cols=torch.as_tensor(cols_l, device=dev),
        send_slots=torch.as_tensor(send_slots, device=dev),
        perm=perm,
        fill_slots=fill_slots,
    )


def partition_bsr_vector(pb, x) -> torch.Tensor:
    """Global (n,) → (P, nb_pad, b) block layout, on ``x``'s device (the
    operator's for a NumPy array)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x),
                                                              device=pb.blocks.device)
    b = pb.block_size
    xb = x.reshape(pb.nb_global, b)
    out = torch.zeros((pb.num_parts * pb.nb_pad, b), dtype=x.dtype, device=x.device)
    out[torch.as_tensor(pb.fill_slots, device=x.device)] = xb[
        torch.as_tensor(pb.perm, device=x.device)]
    return out.reshape(pb.num_parts, pb.nb_pad, b)


def unpartition_bsr_vector(pb, xp) -> torch.Tensor:
    """(P, nb_pad, b) block layout (or any array of its entries) → global
    (n,)."""
    xp = xp if isinstance(xp, torch.Tensor) else torch.as_tensor(np.asarray(xp))
    flat = xp.reshape(-1, pb.block_size)
    inv = np.empty(pb.nb_global, dtype=np.int64)
    inv[pb.perm] = np.arange(pb.nb_global)
    return flat[torch.as_tensor(pb.fill_slots[inv], device=flat.device)].reshape(-1)


def sharded_bsr_solve(
    pb,
    b_vec,
    x0=None,
    *,
    mesh=None,
    method: str = "gmres",
    options=None,
    block_jacobi: bool = False,
    **solver_kw,
):
    """Krylov solve with the BSR operator partitioned over the ranks of
    ``mesh`` (default: :func:`make_device_mesh` on the default group),
    BASELINE config #3.  ``pb`` is either layout: :class:`PartitionedBSR`
    (all-gather pool) or :class:`PartitionedBandedBSR` (neighbour halo
    shifts, constant bytes per link).  ``block_jacobi=True`` preconditions
    with the inverted diagonal blocks (rank-local, partition-invariant).
    Every rank passes the same global ``b_vec``/``x0`` and gets the same
    global result."""
    from stormx_torch.parallel.sharded import _global, _mesh_for, _run_local_solve
    from stormx_torch.solvers import make_operator
    from stormx_torch.solvers.preconditioner import FunctionPreconditioner

    mesh = _mesh_for(pb.num_parts, mesh)
    r, dev = mesh.rank, mesh.device
    nb_pad, bs = pb.nb_pad, pb.block_size
    b = _global(b_vec, pb.blocks, dev)
    x0 = torch.zeros_like(b) if x0 is None else _global(x0, b, dev)

    def to_local(v):
        return partition_bsr_vector(pb, _global(v, b, dev))[r].reshape(-1).contiguous()

    local = pb.local_matvec(mesh)
    op = make_operator(lambda v: local(v.reshape(nb_pad, bs)).reshape(-1))
    pre = None
    if block_jacobi:
        dinv = pb.extract_diag_inv(r).to(dev, b.dtype)
        pre = FunctionPreconditioner(
            lambda v: (dinv * v.reshape(nb_pad, 1, bs)).sum(-1).reshape(-1))
    res = _run_local_solve(method, op, to_local(b), to_local(x0), mesh=mesh, options=options,
                           pre=pre, solver_kw=dict(solver_kw), n_global=pb.nb_global * bs,
                           to_local=to_local)
    return res._replace(x=unpartition_bsr_vector(pb, mesh.all_gather(res.x)))
