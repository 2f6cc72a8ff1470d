"""Compressible-Euler demo (counterpart of ``stormx/apps/euler.py``;
reference ``euler_solve``, ``source_apps/playground/Playground.cpp:214-246``).

Initialize the primitive state q = (2, 1, 1, 0, 0), convert it to conserved
variables, and march forward Euler with the 2nd-order limited upwind scheme
and the Lax–Friedrichs flux (``SkunkFvSolver.hpp:62-74``).  On a mesh that
carries K3's plans every gather of a step is that kernel.
"""

from __future__ import annotations

import torch

from stormx_torch.core.config import default_real_dtype, resolve_device
from stormx_torch.fvm.hydro import state_from_prim
from stormx_torch.fvm.solver import FvSolver

__all__ = ["initial_state", "run"]


def initial_state(num_cells: int, prim=(2.0, 1.0, 1.0, 0.0, 0.0), dtype=None, *,
                  device="cuda"):
    """Uniform conserved state from primitive q (Playground.cpp:219-224), on
    ``device`` (raises without a card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    dtype = dtype or default_real_dtype()
    prim_arr = torch.tensor(prim, dtype=dtype, device=dev).repeat(num_cells, 1)
    n = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev).repeat(num_cells, 1)
    return state_from_prim(n, prim_arr).make_cons()


def run(dmesh, num_steps: int, dt: float = 1e-4, u0=None, **solver_kw):
    """March ``num_steps`` forward-Euler steps (Playground.cpp:231-243) on
    the mesh's device; ``u0`` defaults to :func:`initial_state` in the
    mesh's dtype."""
    solver = FvSolver(dmesh, **solver_kw)
    if u0 is None:
        u0 = initial_state(dmesh.num_cells, dtype=dmesh.cell_volumes.dtype,
                           device=dmesh.device)
    return solver.march(u0, dt, num_steps)
