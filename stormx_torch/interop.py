"""Carry state from the JAX package into the port.

Each function takes one of the JAX package's objects as a dict of its
fields — arrays as NumPy arrays, everything else as it is — and returns the
port's object, so that both packages can be given the same mesh or
operator.  The caller does the ``np.asarray`` on the JAX side; this module
imports nothing of that package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stormx_torch.mesh.unstructured import UnstructuredMesh
from stormx_torch.ops.sell_packed import PackedSELL, rows_used_of
from stormx_torch.sparse.formats import CSR, DIA, ELL
from stormx_torch.sparse.windowed import SlicedELL

__all__ = [
    "mesh_from_fields",
    "csr_from_fields",
    "ell_from_fields",
    "dia_from_fields",
    "sell_from_fields",
    "packed_from_fields",
]


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=torch.device(device))


def mesh_from_fields(fields: dict) -> UnstructuredMesh:
    """A host mesh from the fields of ``stormx.mesh.UnstructuredMesh``."""
    names = {f.name for f in dataclasses.fields(UnstructuredMesh)}
    return UnstructuredMesh(**{k: v for k, v in fields.items() if k in names})


def csr_from_fields(fields: dict, device="cpu") -> CSR:
    return CSR(
        data=_t(fields["data"], device),
        indices=_t(fields["indices"], device),
        row_ptr=_t(fields["row_ptr"], device),
        shape=tuple(fields["shape"]),
    )


def ell_from_fields(fields: dict, device="cpu") -> ELL:
    return ELL(
        data=_t(fields["data"], device),
        cols=_t(fields["cols"], device),
        shape=tuple(fields["shape"]),
    )


def dia_from_fields(fields: dict, device="cpu") -> DIA:
    return DIA(
        data=_t(fields["data"], device),
        offsets=tuple(int(o) for o in fields["offsets"]),
        shape=tuple(fields["shape"]),
    )


def sell_from_fields(fields: dict, device="cpu") -> SlicedELL:
    """The JAX ``SlicedELL`` (``(nb, R, K)`` layout, mode ``"pallas"`` for the
    TPU kernel) as the port's (``(nb, K, R)`` layout, mode ``"cuda"``)."""
    mode = {"pallas": "cuda"}.get(fields["mode"], fields["mode"])
    dense = fields.get("dense_blocks")
    return SlicedELL(
        data=_t(np.asarray(fields["data"]).transpose(0, 2, 1), device),
        local_cols=_t(np.asarray(fields["local_cols"]).transpose(0, 2, 1), device),
        shape=tuple(fields["shape"]),
        window=int(fields["window"]),
        pad_lo=int(fields["pad_lo"]),
        mode=mode,
        dense_blocks=None if dense is None else _t(dense, device),
    )


def packed_from_fields(fields: dict, device="cpu") -> PackedSELL:
    """The JAX ``PackedSELL`` (``stormx/ops/pallas_sell2.py``) as the port's:
    the same (nb, M, 128) index words, values and source map, and the same
    metadata, so one packing feeds both packages.  ``rows_used``, which the
    JAX package does not keep, is computed from the values on ``device``."""
    vals = _t(fields["vals"], device)
    return PackedSELL(
        idx=_t(fields["idx"], device),
        vals=vals,
        src=_t(fields["src"], device),
        rows_used=rows_used_of(vals),
        shape=tuple(int(s) for s in fields["shape"]),
        window=int(fields["window"]),
        pad_lo=int(fields["pad_lo"]),
        block_rows=int(fields["block_rows"]),
        ell_k=int(fields["ell_k"]),
        variant=str(fields["variant"]),
    )
