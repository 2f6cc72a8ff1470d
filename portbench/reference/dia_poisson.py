"""Plain reference of the five-point Poisson problem on an nx × nx grid.

(A·x)[i, j] = 4·x[i, j] − x[i±1, j] − x[i, j±1], a missing neighbour
outside the grid counting as 0 (PETSc's ``ex2.c``), with the unknown
(i, j) at index i·nx + j.  Built from ``nx`` alone, in plain PyTorch;
imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference.cg import cg


class Operator:
    """The five-point operator of an nx × nx grid, applied in ``dtype``."""

    def __init__(self, nx: int, device, dtype=torch.float64):
        self.nx, self.n, self.dtype = nx, nx * nx, dtype
        self.inv_diag = torch.full((self.n,), 0.25, dtype=dtype, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        g = x.view(self.nx, self.nx)
        y = 4.0 * g
        y[1:, :] -= g[:-1, :]
        y[:-1, :] -= g[1:, :]
        y[:, 1:] -= g[:, :-1]
        y[:, :-1] -= g[:, 1:]
        return y.reshape(-1)


def check(fixed: dict, inputs, samples: list, config: dict, traffic: dict,
          device) -> dict:
    """The compared numbers of a run: ``resid``, the largest float64
    ‖b − A·x‖ / ‖b‖ over the sampled answers x, the quantity that
    ``ex2.c``'s tolerance bounds.  ``inputs(cycle)`` gives a cycle's b."""
    op = Operator(config["nx"], device)
    worst = 0.0
    for (cycle, _), (x,) in samples:
        b = inputs(cycle)["b"]
        r = b - op(x.to(torch.float64))
        worst = max(worst, float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)))
    return {"resid": worst}


class Control:
    """The reference in the program's place: each solve by :func:`cg` from
    x = 0 to the cell's tolerance in ``dtype``."""

    def __init__(self, fixed: dict, config: dict, traffic: dict, device, dtype):
        self.op = Operator(config["nx"], device, dtype)
        self.rtol, self.max_iterations = config["rtol"], config["max_iterations"]
        self.cycle_len = traffic["solves_per_cycle"]
        self.dtype = dtype
        self.info, self.setup_times = {}, {}

    def load(self, inputs) -> None:
        self.inputs = inputs

    def begin_cycle(self, cycle: int) -> None:
        self.cycle, self.slot = cycle, 0
        self.b = self.inputs(cycle)["b"].to(self.dtype)

    def solve_next(self):
        key = (self.cycle, self.slot)
        s = cg(self.op, self.b, torch.zeros_like(self.b), self.op.inv_diag, rtol=self.rtol,
               max_iterations=self.max_iterations)
        self.slot += 1
        return key, (s.x,), s.iterations, s.converged

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64)

    def counters(self) -> dict:
        return {}

    def free(self) -> None:
        self.op = self.b = self.inputs = None
