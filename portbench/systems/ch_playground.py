"""The Cahn–Hilliard playground of ``stormx_torch`` (``apps/cahn_hilliard.py``)
on a triangle mesh: the system under test of the ``ch_playground``
configurations.

Set-up, as the app runs it: ``build_mesh`` on the raw points and triangles,
``optimize_ordering``, then ``make_assembled_step`` (the host assembly of
A = I − τσ·D + τΓ·D², ``auto_operator``, whose float32 operator on the card
is kernel K1's "staged" branch at K = 10, and ``device_arrays`` with K3's
plans).  Each cycle starts from a fresh c₀ = mean + scale·N(0, 1) per cell;
each timed unit is one call of the app's step, warm-started from the last
state, with the cell's solver options passed to that call, inside the
benchmark's ``solve`` span and ending in a synchronise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import synchronize
from portbench.inputs.draws import draw
from portbench.inputs.mesh import delaunay_mesh
from portbench.systems.common import ProgramSystem
from portbench.systems.fv_diffusion import _cell_order


def make_fixed(config: dict) -> dict:
    """The mesh: the same for every seed."""
    points, tris = delaunay_mesh(config["grid_side"], config["jitter"], config["mesh_seed"])
    return {"points": points, "triangles": tris}


def make_inputs(fixed: dict, config: dict, traffic: dict, seed: int, cycle: int,
                device) -> dict:
    """Cycle ``cycle``'s c₀, one value per cell in the input's numbering."""
    n = len(fixed["triangles"])
    return {"c0": config["c0_mean"]
            + config["c0_scale"] * draw(traffic["draw"], seed, cycle, n, device)}


def two_ring_entries(tris: np.ndarray) -> int:
    """Stored entries of I + D + D² on the mesh: the pairs of cells at most
    two shared edges apart (each cell with itself included)."""
    import scipy.sparse as sp

    t = np.asarray(tris, dtype=np.int64)
    e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), axis=1)
    owner = np.tile(np.arange(len(t)), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e, owner = e[order], owner[order]
    twin = np.nonzero((e[1:] == e[:-1]).all(axis=1))[0]
    i, j = owner[twin], owner[twin + 1]
    n = len(t)
    ones = np.ones(2 * len(i) + n)
    adj = sp.csr_matrix((ones, (np.concatenate([i, j, np.arange(n)]),
                                np.concatenate([j, i, np.arange(n)]))), shape=(n, n))
    return int((adj @ adj).nnz)


class System(ProgramSystem):
    def __init__(self, fixed: dict, config: dict, traffic: dict, device):
        from stormx_torch.apps.cahn_hilliard import make_assembled_step
        from stormx_torch.mesh import build_mesh

        super().__init__(config, traffic, device)
        self.dtype = getattr(torch, config["dtype"])
        t0 = time.perf_counter()
        mesh = build_mesh(fixed["points"], fixed["triangles"]).optimize_ordering()
        self.setup_times["mesh_s"] = time.perf_counter() - t0
        self.step = make_assembled_step(mesh, tau=config["tau"], gamma=config["gamma"],
                                        sigma=config["sigma"], dtype=self.dtype,
                                        device=self.device)
        self.order = torch.as_tensor(_cell_order(mesh, fixed["triangles"]), device=device)
        self.cycle_len = traffic["steps_per_cycle"]
        # The byte count of K1 reads the operator's true entries, about 10 a
        # row, whatever layout holds them.
        self.info["k1"] = {"rows": mesh.num_cells,
                           "entries": two_ring_entries(fixed["triangles"])}

    def begin_cycle(self, cycle: int) -> None:
        self.cycle, self.slot = cycle, 0
        self.c = self.inputs(cycle)["c0"][self.order].to(self.dtype)

    def solve_next(self):
        from stormx_torch.solvers import SolverOptions

        opts = SolverOptions(num_iterations=self.max_iterations,
                             absolute_tolerance=self.config["atol"],
                             relative_tolerance=self.config["rtol"], record_history=False)
        with self.span("solve"):
            c_next, res = self.step(self.c, options=opts)
            synchronize(self.device)
        key, answer = (self.cycle, self.slot), (self.c, c_next)
        self.c = c_next
        self.slot += 1
        return key, answer, res.num_iterations, res.converged

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x, dtype=torch.float64)
        out[self.order] = x.to(torch.float64)
        return out

    def free(self) -> None:
        super().free()
        self.step = self.c = None
