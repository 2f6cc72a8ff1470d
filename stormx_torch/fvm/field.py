"""Mesh-attached fields (counterpart of ``stormx/fvm/field.py``; reference
``Feathers/Field.hpp:60-154``).

A field is a tensor of shape ``(num_entities,)`` or ``(num_entities,
num_vars)``; only the constructors live here.  They allocate on ``device``,
the card unless the caller asks for the CPU (raises without a card).
"""

from __future__ import annotations

import torch

from stormx_torch.core.config import default_real_dtype, resolve_device

__all__ = ["cell_field", "face_field", "node_field"]


def _full(n, num_vars, fill, dtype, device):
    shape = (n,) if num_vars is None else (n, num_vars)
    return torch.full(shape, fill, dtype=dtype or default_real_dtype(),
                      device=resolve_device(device))


def cell_field(mesh, num_vars: int | None = None, fill=0.0, dtype=None, *, device="cuda"):
    return _full(mesh.num_cells, num_vars, fill, dtype, device)


def face_field(mesh, num_vars: int | None = None, fill=0.0, dtype=None, *, device="cuda"):
    return _full(mesh.num_faces, num_vars, fill, dtype, device)


def node_field(mesh, num_vars: int | None = None, fill=0.0, dtype=None, *, device="cuda"):
    return _full(getattr(mesh, "num_nodes", None), num_vars, fill, dtype, device)
