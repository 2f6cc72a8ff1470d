"""Jobs for the process ranks of ``RankPool`` in the tests.  A rank process
unpickles these by module name, so this module imports neither JAX nor the
JAX package."""

import numpy as np


def sharded_cg(mesh, pop, b):
    """One rank's sharded CG: (iterations, history, x) as host arrays."""
    from stormx_torch.parallel import sharded_solve

    res = sharded_solve(pop, b, mesh=mesh, method="cg")
    return res.num_iterations, res.history.cpu().numpy(), res.x.cpu().numpy()


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 failed")
    return np.asarray(mesh.all_reduce_sum(__import__("torch").ones(1)))
