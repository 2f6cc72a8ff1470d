"""Sparse matrix containers: CSR / COO / ELL / DIA (counterpart of
``stormx/sparse/formats.py``).

The containers are frozen dataclasses holding tensors.  The converters are
host-side NumPy, run once at setup; they accept tensors or NumPy arrays and
return tensors on the device of their input (``ell_from_csr(device=False)``
keeps NumPy arrays, for build intermediates read straight back on the host).
``ELL.matvec``'s ``x[cols]`` stays plain torch, as the JAX package leaves it
to XLA.  ``DIA.matvec`` launches kernel K2a (:mod:`stormx_torch.ops.dia`)
for tensors on the card; a ``DIA`` lives where its ``data`` lives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "CSR",
    "COO",
    "ELL",
    "DIA",
    "csr_from_dense",
    "ell_from_csr",
    "dia_from_csr",
    "ell_spgemm",
    "ell_add",
    "host",
    "device_of",
]


def host(a) -> np.ndarray:
    """NumPy view of a tensor (copied to the host) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def device_of(a) -> torch.device:
    """The device of a tensor; the CPU for a NumPy array."""
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids.long(), vals)


@dataclass(frozen=True)
class CSR:
    """Compressed sparse row (reference ``CsrTable``, ``Utils/Table.hpp:125-190``)."""

    data: torch.Tensor  # (nnz,)
    indices: torch.Tensor  # (nnz,) int32 column ids
    row_ptr: torch.Tensor  # (n_rows + 1,) int32 offsets
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def row_ids(self) -> torch.Tensor:
        """Row id of every nonzero: #{i : row_ptr[i+1] ≤ j}."""
        j = torch.arange(self.nnz, dtype=self.row_ptr.dtype, device=self.row_ptr.device)
        return torch.searchsorted(self.row_ptr[1:].contiguous(), j, right=True)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Segment-sum SpMV: the correctness oracle for the ELL path."""
        vals = self.data * x[self.indices.long()]
        return segment_sum(vals, self.row_ids(), self.shape[0])

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        """Main diagonal (missing entries → 0), for Jacobi."""
        rid = self.row_ids()
        is_diag = rid == self.indices.long()
        return segment_sum(
            torch.where(is_diag, self.data, torch.zeros_like(self.data)),
            rid,
            self.shape[0],
        )

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=self.data.device)
        out.index_put_((self.row_ids(), self.indices.long()), self.data, accumulate=True)
        return out


@dataclass(frozen=True)
class COO:
    """Coordinate format — the assembly staging format."""

    data: torch.Tensor  # (nnz,)
    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    shape: tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return segment_sum(self.data * x[self.cols.long()], self.rows, self.shape[0])

    def __matmul__(self, x):
        return self.matvec(x)

    def to_csr(self) -> CSR:
        rows, cols, data = host(self.rows), host(self.cols), host(self.data)
        order = np.lexsort((cols, rows))
        rows, cols, data = rows[order], cols[order], data[order]
        key = rows.astype(np.int64) * self.shape[1] + cols
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(len(uniq), dtype=data.dtype)
        np.add.at(summed, inv, data)
        u_rows = (uniq // self.shape[1]).astype(np.int32)
        u_cols = (uniq % self.shape[1]).astype(np.int32)
        row_ptr = np.zeros(self.shape[0] + 1, dtype=np.int32)
        np.add.at(row_ptr, u_rows + 1, 1)
        row_ptr = np.cumsum(row_ptr, dtype=np.int32)
        dev = device_of(self.data)
        return CSR(
            data=_tensor(summed, dev),
            indices=_tensor(u_cols, dev),
            row_ptr=_tensor(row_ptr, dev),
            shape=self.shape,
        )


@dataclass(frozen=True)
class ELL:
    """ELLPACK: fixed row width K; padding points at column 0 with weight 0."""

    data: torch.Tensor  # (n_rows, K)
    cols: torch.Tensor  # (n_rows, K) int32
    shape: tuple[int, int]

    @property
    def row_width(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.data * x[self.cols.long()], dim=1)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        n = self.shape[0]
        rows = torch.arange(n, dtype=self.cols.dtype, device=self.cols.device)[:, None]
        return torch.sum(
            torch.where(self.cols == rows, self.data, torch.zeros_like(self.data)), dim=1
        )

    def to_csr(self) -> CSR:
        """Host-side conversion (drops padding; keeps diagonal slots even when
        numerically zero so factorizations find an explicit diagonal)."""
        data, cols = host(self.data), host(self.cols)
        n = self.shape[0]
        rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)
        keep = (data != 0) | (cols == rows)
        dev = device_of(self.data)
        coo = COO(
            data=_tensor(data[keep], dev),
            rows=_tensor(rows[keep].astype(np.int32), dev),
            cols=_tensor(cols[keep].astype(np.int32), dev),
            shape=self.shape,
        )
        return coo.to_csr()


@dataclass(frozen=True)
class DIA:
    """Diagonal (banded) storage: y[i] = Σ_d data[d, i] · x[i + offsets[d]]."""

    data: torch.Tensor  # (num_diags, n_rows)
    offsets: tuple[int, ...]
    shape: tuple[int, int]

    @property
    def num_diags(self) -> int:
        return self.data.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel K2a on the card, its plain version on the CPU."""
        from stormx_torch.ops.dia import dia_spmv

        return dia_spmv(self, x)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.data.dtype, device=self.data.device)


# ---------------------------------------------------------------------------
# Host-side converters (NumPy; run once at setup).
# ---------------------------------------------------------------------------


def csr_from_dense(mat) -> CSR:
    dev = device_of(mat)
    mat = host(mat)
    n_rows, n_cols = mat.shape
    rows, cols = np.nonzero(mat)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.add.at(row_ptr, rows.astype(np.int32) + 1, 1)
    row_ptr = np.cumsum(row_ptr, dtype=np.int32)
    return CSR(
        data=_tensor(mat[rows, cols], dev),
        indices=_tensor(cols.astype(np.int32), dev),
        row_ptr=_tensor(row_ptr, dev),
        shape=(n_rows, n_cols),
    )


def ell_from_csr(csr: CSR, row_width: int | None = None, *, device: bool = True) -> ELL:
    """Pad CSR rows to a fixed width (maxdeg+1 for FVM adjacency operators).

    ``device=False`` keeps the ELL fields as host NumPy arrays, for build
    intermediates that are immediately read back on the host."""
    row_ptr, indices, data = host(csr.row_ptr), host(csr.indices), host(csr.data)
    n = csr.shape[0]
    counts = np.diff(row_ptr)
    K = int(row_width if row_width is not None else counts.max() if n else 0)
    if counts.max(initial=0) > K:
        raise ValueError(f"row_width {K} < max row nnz {counts.max()}")
    cols = np.zeros((n, K), dtype=np.int32)
    vals = np.zeros((n, K), dtype=data.dtype)
    within = np.arange(len(indices)) - np.repeat(row_ptr[:-1], counts)
    row_of = np.repeat(np.arange(n), counts)
    cols[row_of, within] = indices
    vals[row_of, within] = data
    if not device:
        return ELL(data=vals, cols=cols, shape=csr.shape)
    dev = device_of(csr.data)
    return ELL(data=_tensor(vals, dev), cols=_tensor(cols, dev), shape=csr.shape)


def dia_from_csr(csr: CSR, max_diags: int | None = None) -> DIA:
    """CSR → diagonal storage; raises if more than ``max_diags`` diagonals."""
    row_ptr, indices, data = host(csr.row_ptr), host(csr.indices), host(csr.data)
    n = csr.shape[0]
    counts = np.diff(row_ptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    offs = indices.astype(np.int64) - rows
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        raise ValueError(
            f"{len(uniq)} populated diagonals > max_diags={max_diags}; "
            "apply rcm_order first or use ELL"
        )
    slot = np.searchsorted(uniq, offs)
    diag = np.zeros((len(uniq), n), dtype=data.dtype)
    np.add.at(diag, (slot, rows), data)
    return DIA(
        data=_tensor(diag, device_of(csr.data)),
        offsets=tuple(int(o) for o in uniq),
        shape=csr.shape,
    )


def ell_spgemm(a: ELL, b: ELL) -> CSR:
    """Host-side sparse·sparse product C = A·B for ELL operands (used to
    assemble the Cahn–Hilliard D² once per mesh).  Chunked over rows so the
    (rows, Ka, Kb) temporaries stay bounded; duplicates merged by
    ``COO.to_csr``."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    ad, ac = host(a.data), host(a.cols)
    bd, bc = host(b.data), host(b.cols)
    n, Ka = ad.shape
    Kb = bd.shape[1]
    CHUNK = 1 << 19
    out_d, out_r, out_c = [], [], []
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        acs = ac[lo:hi]
        rows = np.broadcast_to(np.arange(lo, hi)[:, None, None], (hi - lo, Ka, Kb))
        cols = bc[acs]
        vals = ad[lo:hi, :, None] * bd[acs]
        keep = vals != 0
        keep |= cols == rows  # explicit diagonal slots stay
        out_d.append(vals[keep])
        out_r.append(rows[keep].astype(np.int32))
        out_c.append(cols[keep].astype(np.int32))
    dev = device_of(a.data)
    coo = COO(
        data=_tensor(np.concatenate(out_d), dev),
        rows=_tensor(np.concatenate(out_r), dev),
        cols=_tensor(np.concatenate(out_c), dev),
        shape=(a.shape[0], b.shape[1]),
    )
    return coo.to_csr()


def ell_add(terms, shape) -> CSR:
    """Host-side linear combination Σ cᵢ·Aᵢ of ELL/CSR operands → CSR.

    ``terms``: iterable of (coeff, operator|None); ``None`` is the identity.
    The result lives on the first operand's device.
    """
    datas, rows_l, cols_l = [], [], []
    n = shape[0]
    dev = None
    for coeff, op in terms:
        if op is None:
            datas.append(np.full(n, float(coeff)))
            rows_l.append(np.arange(n))
            cols_l.append(np.arange(n))
            continue
        if dev is None:
            dev = device_of(op.data)
        if isinstance(op, CSR):
            d = host(op.data) * coeff
            r = np.repeat(np.arange(n), np.diff(host(op.row_ptr)))
            c = host(op.indices)
        else:  # ELL
            dd, cc = host(op.data), host(op.cols)
            rr = np.broadcast_to(np.arange(n)[:, None], cc.shape)
            keep = (dd != 0) | (cc == rr)
            d, r, c = dd[keep] * coeff, rr[keep], cc[keep]
        datas.append(d), rows_l.append(r), cols_l.append(c)
    dev = dev or torch.device("cpu")
    coo = COO(
        data=_tensor(np.concatenate(datas), dev),
        rows=_tensor(np.concatenate(rows_l).astype(np.int32), dev),
        cols=_tensor(np.concatenate(cols_l).astype(np.int32), dev),
        shape=shape,
    )
    return coo.to_csr()
