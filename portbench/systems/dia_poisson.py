"""The five-point Poisson solve of ``stormx_torch`` on a DIA operator: the
system under test of the ``dia_poisson`` configurations.

Set-up: the grid's diagonals (``poisson5_diags``) as a ``DIA`` on the
card, whose matvec is kernel K2a.  Each cycle draws a fresh u; its timed
unit is one ``solve`` of A·x = A·u from x = 0, ending in a synchronise.
"""

from __future__ import annotations

import torch

from portbench.inputs.draws import draw
from portbench.inputs.grid import poisson5_diags, poisson5_nonzeros
from portbench.reference.dia_poisson import Operator
from portbench.systems.common import ProgramSystem


def make_fixed(config: dict) -> dict:
    return {}


def make_inputs(fixed: dict, config: dict, traffic: dict, seed: int, cycle: int,
                device) -> dict:
    """Cycle ``cycle``'s right-hand side: b = A·u in float64 for u drawn from
    the seed and the cycle's number (``ex2.c``'s u = 1 times a drawn c)."""
    nx = config["nx"]
    u = draw(traffic["draw"], seed, cycle, nx * nx, device)
    return {"b": Operator(nx, device)(u)}


class System(ProgramSystem):
    def __init__(self, fixed: dict, config: dict, traffic: dict, device):
        from stormx_torch.sparse.formats import DIA

        super().__init__(config, traffic, device)
        nx = config["nx"]
        n = nx * nx
        self.dtype = getattr(torch, config["dtype"])
        offsets, data = poisson5_diags(nx)
        self.op = DIA(data=torch.as_tensor(data, device=self.device).to(self.dtype),
                      offsets=offsets, shape=(n, n))
        self.cycle_len = traffic["solves_per_cycle"]
        self.info["k2a"] = {"rows": n, "entries": poisson5_nonzeros(nx),
                            "itemsize": self.dtype.itemsize}

    def begin_cycle(self, cycle: int) -> None:
        self.cycle, self.slot = cycle, 0
        self.b = self.inputs(cycle)["b"].to(self.dtype)

    def solve_next(self):
        key = (self.cycle, self.slot)
        res = self.solve(self.b, None, self.config["atol"])
        self.slot += 1
        return key, (res.x,), res.num_iterations, res.converged

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64)

    def free(self) -> None:
        super().free()
        self.b = None
