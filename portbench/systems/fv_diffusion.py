"""The implicit diffusion step of ``stormx_torch`` on a triangle mesh: the
system under test of the ``fv_diffusion`` configurations.

Set-up, as a user of the port runs it: ``build_mesh`` on the raw points
and triangles, ``optimize_ordering``, the two-point-flux Laplacian of
``assemble_laplacian`` scaled by τ plus the cell volumes on the diagonal,
``auto_operator`` (kernel K1 for a float32 operator on the card) and
``IcPreconditioner`` on the same ordering (its exact default runs kernel
T1).  Each cycle starts from a fresh u₀; each timed unit is one
backward-Euler step: b = V·u and OpenFOAM's normalisation factor of the
step (:func:`norm_factor`), then ``solve`` warm-started from u to the
configuration's tolerance times that factor, ending in a synchronise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import synchronize
from portbench.inputs.draws import draw
from portbench.inputs.mesh import delaunay_mesh, interior_edges
from portbench.systems.common import ProgramSystem


def make_fixed(config: dict) -> dict:
    """The mesh: the same for every seed."""
    points, tris = delaunay_mesh(config["grid_side"], config["jitter"], config["mesh_seed"])
    return {"points": points, "triangles": tris}


def make_inputs(fixed: dict, config: dict, traffic: dict, seed: int, cycle: int,
                device) -> dict:
    """Cycle ``cycle``'s u₀, one value per cell in the input's numbering."""
    return {"u0": draw(traffic["draw"], seed, cycle, len(fixed["triangles"]), device)}


def norm_factor(a_u: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                volume: torch.Tensor) -> torch.Tensor:
    """OpenFOAM's normalisation factor of a solve of A·x = b from u
    (``lduMatrix::solver::normFactor``) in 2-norms:
    ‖A·u − A·ū‖ + ‖b − A·ū‖, ū the mean of u, where A·ū is the row sums
    of A times ū, and the row sums of V + τ·L are V."""
    pa = u.mean() * volume
    return torch.linalg.vector_norm(a_u - pa) + torch.linalg.vector_norm(b - pa)


def _cell_order(mesh, tris: np.ndarray) -> np.ndarray:
    """index[k] = the input triangle that is the mesh's cell k (matched by
    node sets, whatever order ``build_mesh`` and the ordering left)."""
    a = np.sort(np.asarray(tris, dtype=np.int64), axis=1)
    b = np.sort(np.asarray(mesh.cell_nodes, dtype=np.int64)[:, :3], axis=1)
    ia = np.lexsort(a.T[::-1])
    ib = np.lexsort(b.T[::-1])
    if not np.array_equal(a[ia], b[ib]):
        raise RuntimeError("the program's mesh does not hold the input triangles")
    index = np.empty(len(b), dtype=np.int64)
    index[ib] = ia
    return index


class System(ProgramSystem):
    def __init__(self, fixed: dict, config: dict, traffic: dict, device):
        from stormx_torch.fvm.divgrad import assemble_laplacian
        from stormx_torch.mesh import build_mesh
        from stormx_torch.precond import IcPreconditioner
        from stormx_torch.sparse import CSR, auto_operator
        from stormx_torch.sparse.windowed import _permuted_csr

        super().__init__(config, traffic, device)
        dtype = getattr(torch, config["dtype"])
        t0 = time.perf_counter()
        mesh = build_mesh(fixed["points"], fixed["triangles"]).optimize_ordering()
        self.setup_times["mesh_s"] = time.perf_counter() - t0

        lap = assemble_laplacian(mesh, scale=config["tau"]).to_csr()
        row_ptr, cols = lap.row_ptr.numpy(), lap.indices.numpy()
        rows = np.repeat(np.arange(mesh.num_cells), np.diff(row_ptr))
        data = lap.data.numpy() + np.where(cols == rows, mesh.cell_volumes[rows], 0.0)
        a64 = CSR(data=data, indices=cols, row_ptr=row_ptr, shape=lap.shape)
        self.op, perm = auto_operator(
            CSR(data=data.astype(np.float32), indices=cols, row_ptr=row_ptr, shape=lap.shape),
            coords=mesh.cell_centers, device=device)
        t0 = time.perf_counter()
        self.precond = IcPreconditioner(_permuted_csr(a64, perm)[0], dtype=dtype,
                                        device=self.device)
        synchronize(device)
        self.setup_times["precond_s"] = time.perf_counter() - t0

        self.order = torch.as_tensor(_cell_order(mesh, fixed["triangles"])[perm], device=device)
        self.volume = torch.as_tensor(mesh.cell_volumes[perm], device=device).to(dtype)
        self.dtype = dtype
        self.cycle_len = traffic["steps_per_cycle"]
        n, edges = mesh.num_cells, interior_edges(fixed["triangles"])
        # Shapes for the byte counts: A has n + 2·edges entries; each
        # triangular factor of IC(0) keeps A's pattern, edges off the diagonal.
        self.info["k1"] = {"rows": n, "entries": n + 2 * edges}
        self.info["t1"] = {"rows": n, "entries": edges}
        levels = [f.num_levels for f in (self.precond._first, self.precond._second)]
        self.info["t1"]["levels"] = sum(levels) / len(levels)

    def begin_cycle(self, cycle: int) -> None:
        self.cycle, self.slot = cycle, 0
        self.u = self.inputs(cycle)["u0"][self.order].to(self.dtype)

    def solve_next(self):
        with self.span("rhs"):
            b = self.volume * self.u
            nf = norm_factor(self.op.matvec(self.u), b, self.u, self.volume)
            atol = self.config["tolerance"] * float(nf)
        res = self.solve(b, self.u, atol)
        key, answer = (self.cycle, self.slot), (self.u, res.x)
        self.u = res.x
        self.slot += 1
        return key, answer, res.num_iterations, res.converged

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x, dtype=torch.float64)
        out[self.order] = x.to(torch.float64)
        return out

    def free(self) -> None:
        super().free()
        self.u = self.volume = None
