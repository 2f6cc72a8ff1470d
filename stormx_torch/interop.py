"""Carry state from the JAX package into the port.

Each function takes one of the JAX package's objects as a dict of its
fields — arrays as NumPy arrays, everything else as it is — and returns the
port's object, so that both packages can be given the same mesh or
operator.  The caller does the ``np.asarray`` on the JAX side; this module
imports nothing of that package.  Like the port's other entry points, each
function that makes tensors puts them on the card unless it is given
``device``, and raises ``StormError`` where there is no card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stormx_torch.mesh.unstructured import UnstructuredMesh
from stormx_torch.core.config import resolve_device
from stormx_torch.parallel.banded import PartitionedDIA
from stormx_torch.parallel.partition import PartitionedOperator
from stormx_torch.parallel.sliced import PartitionedSliced
from stormx_torch.ops.sell_packed import (PackedSELL, live4_of, rows_used_of, xchunk_of,
                                          xlane_of)
from stormx_torch.sparse.formats import CSR, DIA, ELL
from stormx_torch.sparse.windowed import SlicedELL

__all__ = [
    "mesh_from_fields",
    "csr_from_fields",
    "ell_from_fields",
    "dia_from_fields",
    "sell_from_fields",
    "packed_from_fields",
    "partitioned_operator_from_fields",
    "partitioned_dia_from_fields",
    "partitioned_sliced_from_fields",
]


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=resolve_device(device))


def mesh_from_fields(fields: dict) -> UnstructuredMesh:
    """A host mesh from the fields of ``stormx.mesh.UnstructuredMesh``."""
    names = {f.name for f in dataclasses.fields(UnstructuredMesh)}
    return UnstructuredMesh(**{k: v for k, v in fields.items() if k in names})


def csr_from_fields(fields: dict, device="cuda") -> CSR:
    return CSR(
        data=_t(fields["data"], device),
        indices=_t(fields["indices"], device),
        row_ptr=_t(fields["row_ptr"], device),
        shape=tuple(fields["shape"]),
    )


def ell_from_fields(fields: dict, device="cuda") -> ELL:
    return ELL(
        data=_t(fields["data"], device),
        cols=_t(fields["cols"], device),
        shape=tuple(fields["shape"]),
    )


def dia_from_fields(fields: dict, device="cuda") -> DIA:
    return DIA(
        data=_t(fields["data"], device),
        offsets=tuple(int(o) for o in fields["offsets"]),
        shape=tuple(fields["shape"]),
    )


def sell_from_fields(fields: dict, device="cuda") -> SlicedELL:
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


def packed_from_fields(fields: dict, device="cuda") -> PackedSELL:
    """The JAX ``PackedSELL`` (``stormx/ops/pallas_sell2.py``) as the port's:
    the same (nb, M, 128) index words, values and source map, and the same
    metadata, so one packing feeds both packages.  ``rows_used``,
    ``live4``, ``xlane`` and ``xchunk``, which the JAX package does not
    keep, are computed from the values and words on ``device``."""
    idx, vals = _t(fields["idx"], device), _t(fields["vals"], device)
    return PackedSELL(
        idx=idx,
        vals=vals,
        src=_t(fields["src"], device),
        rows_used=rows_used_of(vals),
        live4=live4_of(vals),
        xlane=xlane_of(idx),
        xchunk=xchunk_of(idx),
        shape=tuple(int(s) for s in fields["shape"]),
        window=int(fields["window"]),
        pad_lo=int(fields["pad_lo"]),
        block_rows=int(fields["block_rows"]),
        ell_k=int(fields["ell_k"]),
        variant=str(fields["variant"]),
    )


def partitioned_operator_from_fields(fields: dict, device="cuda") -> PartitionedOperator:
    """The JAX ``PartitionedOperator`` (``stormx/parallel/partition.py``) as
    the port's: the same stacked arrays, ``perm`` and ``fill_slots``."""
    arrays = ("data", "cols", "send_slots", "bnd_idx", "bnd_data", "bnd_cols")
    return PartitionedOperator(
        num_parts=int(fields["num_parts"]),
        n_global=int(fields["n_global"]),
        n_pad=int(fields["n_pad"]),
        s_max=int(fields["s_max"]),
        perm=np.array(fields["perm"], copy=True),
        fill_slots=np.array(fields["fill_slots"], copy=True),
        **{k: _t(fields[k], device) for k in arrays},
    )


def partitioned_dia_from_fields(fields: dict, device="cuda") -> PartitionedDIA:
    """The JAX ``PartitionedDIA`` (``stormx/parallel/banded.py``) as the
    port's."""
    return PartitionedDIA(
        num_parts=int(fields["num_parts"]),
        n_global=int(fields["n_global"]),
        n_loc=int(fields["n_loc"]),
        h=int(fields["h"]),
        offsets=tuple(int(o) for o in fields["offsets"]),
        data=_t(fields["data"], device),
    )


def partitioned_sliced_from_fields(fields: dict, device="cuda") -> PartitionedSliced:
    """The JAX ``PartitionedSliced`` (``stormx/parallel/sliced.py``) as the
    port's: ``ell_data``/``ell_cols`` go from the JAX package's
    ``(P, nbl, R, K)`` to the port's ``(P, nbl, K, R)``."""

    def opt(name, transpose=False):
        a = fields.get(name)
        if a is None:
            return None
        a = np.asarray(a)
        return _t(np.ascontiguousarray(a.transpose(0, 1, 3, 2)) if transpose else a, device)

    return PartitionedSliced(
        num_parts=int(fields["num_parts"]),
        n_global=int(fields["n_global"]),
        n_loc=int(fields["n_loc"]),
        pad_lo=int(fields["pad_lo"]),
        window=int(fields["window"]),
        block_rows=int(fields["block_rows"]),
        mode=str(fields["mode"]),
        dense_blocks=opt("dense_blocks"),
        ell_data=opt("ell_data", transpose=True),
        ell_cols=opt("ell_cols", transpose=True),
        perm=np.array(fields["perm"], copy=True),
    )
