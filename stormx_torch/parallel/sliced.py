"""Distributed SlicedELL: the multi-rank unstructured SpMV, with kernel K1 on
every slab (counterpart of ``stormx/parallel/sliced.py``).

After RCM the global operator is banded, so a contiguous row-block
partition needs only band-deep strips of its two NEIGHBOUR slabs — one
``RankMesh.exchange`` (two neighbour shifts), as in the banded DIA path —
while each rank applies its rows with the windowed SlicedELL product.  The
row blocks whose windows stay inside the owned slab do not wait for the
halo.

Modes keep the JAX package's names:

* ``"pallas"`` — kernel K1 (``stormx_torch/csrc/sell_spmv.cu``), float32,
  ``block_rows % 128 == 0``, default R = 512.  A slab is a rectangular K1
  operator over the extended slab ``[left halo | x_loc | right halo]`` with
  ``pad_lo = 0``; the overlapped interior pass is K1 on the contiguous block
  range of the interior rows, reading ``x_loc`` alone.  On CPU tensors the
  wrapper takes K1's plain version.
* ``"dense"`` — the einsum over precomputed (nbl, R, C) windows.
* ``"auto"`` — ``"pallas"`` for float32 on the card, ``"dense"`` elsewhere.

The port's SlicedELL stores ``(nb, K, R)``; the JAX package's
``ell_data``/``ell_cols`` are ``(P, nbl, R, K)``, and the port's
``(P, nbl, K, R)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.sparse.windowed import SlicedELL

__all__ = ["PartitionedSliced", "partition_sliced", "sharded_sliced_solve"]


@dataclass(frozen=True)
class PartitionedSliced:
    """A SlicedELL operator split into P contiguous row slabs.

    Per rank: ``nbl`` row blocks of ``R`` rows; block ``bl`` reads
    ``x_ext[R·bl : R·bl + C]`` where ``x_ext = [left halo h_lo | owned
    n_loc | right halo h_hi]`` with ``h_lo = pad_lo`` and
    ``h_hi = C − R − pad_lo``.  The outer edges are zero-filled.
    """

    num_parts: int
    n_global: int
    n_loc: int  # owned rows per rank (multiple of R)
    pad_lo: int
    window: int  # C
    block_rows: int  # R
    mode: str  # "dense" | "pallas"
    dense_blocks: torch.Tensor | None  # (P, nbl, R, C), mode="dense"
    ell_data: torch.Tensor | None  # (P, nbl, K, R), mode="pallas"
    ell_cols: torch.Tensor | None  # (P, nbl, K, R) int32, mode="pallas"
    perm: np.ndarray  # perm[new] = old row id (global RCM order)

    def op_arrays(self) -> tuple:
        """The operator's stacked arrays (leading axis = ranks)."""
        if self.mode == "dense":
            return (self.dense_blocks,)
        return (self.ell_data, self.ell_cols)

    @property
    def h_lo(self) -> int:
        return self.pad_lo

    @property
    def h_hi(self) -> int:
        return self.window - self.block_rows - self.pad_lo

    def local_matvec(self, axis_name, *, overlap: bool = True):
        """Rank-local product ``x_loc (n_loc,) → (n_loc,)`` for the rank of
        ``axis_name`` (its mesh handle), with the rank's arrays bound on its
        device.  In mode ``"pallas"`` each product launches K1 once per
        block range: three times with ``overlap`` (interior, head, tail),
        once without."""
        mesh = axis_name
        R, C = self.block_rows, self.window
        n_loc, h_lo, h_hi = self.n_loc, self.h_lo, self.h_hi
        nbl = n_loc // R
        shifts = C // R
        r, dev = mesh.rank, mesh.device

        if self.mode == "dense":
            blocks = self.dense_blocks[r].to(dev)

            def contract(lo, hi, x):
                """Blocks [lo, hi) on the windows of x at stride R."""
                xt = x.reshape(-1, R)
                win = torch.cat([xt[j : j + hi - lo] for j in range(shifts)], dim=1)
                return torch.einsum("brc,bc->br", blocks[lo:hi], win).reshape(-1)
        else:
            from stormx_torch.ops.sell_spmv import sell_spmv

            data, cols = self.ell_data[r].to(dev), self.ell_cols[r].to(dev)

            def contract(lo, hi, x):
                """Blocks [lo, hi) as a rectangular K1 operator over x."""
                sub = SlicedELL(data=data[lo:hi], local_cols=cols[lo:hi],
                                shape=((hi - lo) * R, x.shape[0]), window=C, pad_lo=0,
                                mode="cuda", dense_blocks=None)
                return sell_spmv(sub, x)

        def exchange(x_loc, async_op=False):
            # My tail → next rank's left halo; my head → previous rank's
            # right halo (a halo of width 0 moves nothing).
            return mesh.exchange(x_loc[n_loc - h_lo :] if h_lo else None,
                                 x_loc[:h_hi] if h_hi else None, async_op=async_op)

        def ext(left, x, right):
            return torch.cat([t for t in (left, x, right) if t is not None])

        # Interior blocks: window [R·bl − h_lo, R·bl − h_lo + C) inside the
        # owned slab ⇒ bl ∈ [bl_lo, bl_hi).
        bl_lo = -(-h_lo // R)
        bl_hi = (n_loc - C + h_lo) // R + 1
        if not overlap or bl_hi <= bl_lo:  # slab too thin to split: plain path
            def matvec(x_loc):
                left, right = exchange(x_loc)
                return contract(0, nbl, ext(left, x_loc, right))

            return matvec

        def matvec(x_loc):
            pending = exchange(x_loc, async_op=True)  # started before the interior
            off = bl_lo * R - h_lo
            ys = [contract(bl_lo, bl_hi, x_loc[off : off + (bl_hi - bl_lo - 1) * R + C])]
            left, right = pending.wait()
            # Boundary blocks read the landed halos: the head's windows are
            # x_ext[: (bl_lo−1)·R + C], the tail's x_ext[bl_hi·R :].
            if bl_lo > 0:
                ys.insert(0, contract(0, bl_lo, ext(left, x_loc[: (bl_lo - 1) * R + C - h_lo],
                                                    None)))
            if bl_hi < nbl:
                ys.append(contract(bl_hi, nbl, ext(None, x_loc[bl_hi * R - h_lo :], right)))
            return torch.cat(ys)

        return matvec


def partition_sliced(
    csr, num_parts: int, *, block_rows: int | None = None, mode: str = "auto",
    device="cuda",
) -> PartitionedSliced:
    """RCM-reorder a CSR operator and split the windowed form into P
    contiguous row slabs (host-side); the arrays go to ``device``, the card
    unless the caller asks for the CPU.

    ``mode="pallas"`` shards the O(nnz) ELL arrays and applies each slab
    with kernel K1; ``mode="dense"`` shards precomputed (nbl, R, C) dense
    windows; ``"auto"``: ``"pallas"`` for float32 on the card, ``"dense"``
    elsewhere.
    """
    from stormx_torch.sparse.formats import host
    from stormx_torch.sparse.windowed import sell_from_csr

    dev = resolve_device(device)
    f32 = host(csr.data).dtype == np.float32
    if mode == "auto":
        mode = "pallas" if (dev.type == "cuda" and f32) else "dense"
    if mode not in ("pallas", "dense"):
        raise ValueError(f"unknown mode {mode!r}; choose 'pallas', 'dense' or 'auto'")
    if block_rows is None:
        block_rows = 512 if mode == "pallas" else 128
    if mode == "pallas":
        if block_rows % 128:
            raise ValueError(
                f"mode='pallas' needs block_rows % 128 == 0 (got {block_rows});"
                " pass block_rows=None for the default, or use mode='dense'"
            )
        if not f32:
            raise ValueError(
                f"mode='pallas' needs float32 operator data (got {host(csr.data).dtype});"
                " cast the CSR to f32 or use mode='dense'"
            )
    sell, perm = sell_from_csr(csr, block_rows=block_rows,
                               mode="dense" if mode == "dense" else "onehot", device="cpu")
    R, C = block_rows, sell.window
    nb = sell.data.shape[0]
    nbl = -(-nb // num_parts)
    n_loc = nbl * R
    pad_b = nbl * num_parts - nb
    h_hi = C - R - sell.pad_lo
    if sell.pad_lo > n_loc or h_hi > n_loc:
        raise ValueError(
            f"band reach ({sell.pad_lo}/{h_hi}) exceeds slab rows {n_loc}; "
            "use fewer parts"
        )

    def shard(arr):
        arr = host(arr)
        if pad_b:
            arr = np.concatenate([arr, np.zeros((pad_b,) + arr.shape[1:], arr.dtype)])
        return torch.as_tensor(arr.reshape((num_parts, nbl) + arr.shape[1:]), device=dev)

    return PartitionedSliced(
        num_parts=num_parts,
        n_global=csr.shape[0],
        n_loc=n_loc,
        pad_lo=sell.pad_lo,
        window=C,
        block_rows=R,
        mode=mode,
        dense_blocks=shard(sell.dense_blocks) if mode == "dense" else None,
        ell_data=shard(sell.data) if mode == "pallas" else None,
        ell_cols=shard(sell.local_cols) if mode == "pallas" else None,
        perm=perm,
    )


def _partition_vec(ps: PartitionedSliced, x: torch.Tensor) -> torch.Tensor:
    """Global (n,) in ORIGINAL order → (P, n_loc) in RCM slab layout."""
    x = x[torch.as_tensor(ps.perm, device=x.device)]
    pad = ps.num_parts * ps.n_loc - ps.n_global
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(ps.num_parts, ps.n_loc)


def _unpartition_vec(ps: PartitionedSliced, xp: torch.Tensor) -> torch.Tensor:
    inv = np.empty(ps.n_global, dtype=np.int64)
    inv[ps.perm] = np.arange(ps.n_global)
    return xp.reshape(-1)[: ps.n_global][torch.as_tensor(inv, device=xp.device)]


def sharded_sliced_solve(
    ps: PartitionedSliced,
    b,
    x0=None,
    *,
    mesh=None,
    method: str = "cg",
    options=None,
    precond_diag=None,
    overlap: bool = True,
    **solver_kw,
):
    """Krylov solve with the windowed unstructured operator split over the
    ranks of ``mesh`` (default: :func:`make_device_mesh` on the default
    group): neighbour band halos (overlapped) + all-reduced dots.
    ``b``/``x0``/result are global vectors in the ORIGINAL (pre-RCM)
    order."""
    from stormx_torch.parallel.sharded import _global, _mesh_for, _run_local_solve
    from stormx_torch.solvers import make_operator

    mesh = _mesh_for(ps.num_parts, mesh)
    r, dev = mesh.rank, mesh.device
    b = _global(b, ps.op_arrays()[0], dev)
    x0 = torch.zeros_like(b) if x0 is None else _global(x0, b, dev)

    def to_local(v):
        return _partition_vec(ps, _global(v, b, dev))[r].contiguous()

    pre = None
    if precond_diag is not None:
        from stormx_torch.precond import JacobiPreconditioner

        pre = JacobiPreconditioner(diag=to_local(precond_diag))
    op = make_operator(ps.local_matvec(mesh, overlap=overlap))
    res = _run_local_solve(method, op, to_local(b), to_local(x0), mesh=mesh, options=options,
                           pre=pre, solver_kw=dict(solver_kw), n_global=ps.n_global,
                           to_local=to_local)
    return res._replace(x=_unpartition_vec(ps, mesh.all_gather(res.x)))
