"""Float32 behaviour of the banded Krylov methods with ``BlockDiaAmg``, in
stormx_torch and in the JAX package.

On the 2048² Poisson ``DIA`` of ``chip_smoke.py``, CGS, BiCGStab,
BiCGStab(l) and IDR(s) with the V-cycle reach a best relative residual in
float32 and then grow.  This file is the second witness for that: the same
float32 problem through the JAX package on the CPU.  As a script it prints,
for each method and side, one JSON line with the iteration count, whether
the run converged, and the best relative residual with its iteration:

    JAX_PLATFORMS=cpu python3 tests/test_torch_f32_breakdown.py 1024 cgs,idrs
    JAX_PLATFORMS=cpu python3 tests/test_torch_f32_breakdown.py 2048 bicgstab --side jax
    python3 tests/test_torch_f32_breakdown.py 2048 bicgstab --side torch --device cuda

The right-hand side, the preconditioner's options, the tolerance and the cap
are the smoke's; IDR(s) takes a numpy-made shadow space on both sides.  At
2048² the JAX side needs ~1.3 GB and ~3 minutes per 2,000 iterations on a
CPU.

As tests, it holds the port's float32 hierarchy and V-cycle against the JAX
package's (the levels and the coarse inverse are cast from the same float64
host arrays, so they are bit-exact; one V-cycle agrees within 1e-5 of its
largest entry, the float32 rounding of a 4-level cycle), and runs the study
at 128², where every method converges in float32 on both sides.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

METHODS = ("cgs", "bicgstab", "bicgstab_l", "idrs")
IDRS_SHADOW = 3  # s − 1 vectors for the default s = 4


def _summary(history, iterations: int, converged: bool) -> dict:
    h = np.asarray(history, dtype=np.float64)[: iterations + 1]
    rel = h / h[0]
    rel = np.where(np.isfinite(rel), rel, np.inf)
    return dict(iterations=int(iterations), converged=bool(converged),
                best_relative_residual=float(rel.min()), best_iteration=int(rel.argmin()),
                last_relative_residual=float(rel[-1]))


def _problem(nx: int):
    offsets, data = chip_smoke.poisson5_diags(nx, np.float32)
    b = np.random.default_rng(0).standard_normal(nx * nx).astype(np.float32)
    return offsets, data, b


def run_torch(nx: int, method: str, device: str = "cpu",
              cap: int = chip_smoke.KRYLOV_MAX_ITERATIONS) -> dict:
    import torch

    from stormx_torch import solvers as ts
    from stormx_torch.precond import BlockDiaAmg
    from stormx_torch.sparse.formats import DIA

    offsets, data, b = _problem(nx)
    n = nx * nx
    op = DIA(data=torch.as_tensor(data, device=device), offsets=offsets, shape=(n, n))
    kw = {}
    if method == "idrs":
        kw["shadow"] = torch.as_tensor(_shadow(n), device=device)
    res = ts.solve(op, torch.as_tensor(b, device=device), method=method,
                   precond=BlockDiaAmg(op, **chip_smoke.AMG_OPTIONS),
                   options=ts.SolverOptions(num_iterations=cap, absolute_tolerance=0.0,
                                            relative_tolerance=chip_smoke.BANDED_RTOL), **kw)
    return _summary(res.history.cpu().numpy(), res.num_iterations, res.converged)


def run_jax(nx: int, method: str, cap: int = chip_smoke.KRYLOV_MAX_ITERATIONS) -> dict:
    import jax.numpy as jnp

    from stormx import solvers as js
    from stormx.precond import BlockDiaAmg
    from stormx.sparse import formats as jf

    offsets, data, b = _problem(nx)
    n = nx * nx
    op = jf.DIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n))
    kw = {}
    if method == "idrs":
        kw["shadow"] = jnp.asarray(_shadow(n))
    res = js.solve(op, jnp.asarray(b), method=method,
                   precond=BlockDiaAmg(op, **chip_smoke.AMG_OPTIONS),
                   options=js.SolverOptions(num_iterations=cap, absolute_tolerance=0.0,
                                            relative_tolerance=chip_smoke.BANDED_RTOL), **kw)
    return _summary(res.history, int(res.num_iterations), bool(res.converged))


def _shadow(n: int) -> np.ndarray:
    return np.random.default_rng(1).standard_normal((IDRS_SHADOW, n)).astype(np.float32)


def test_float32_vcycle_matches_jax():
    import jax.numpy as jnp
    import torch

    from stormx.precond import BlockDiaAmg as JAmg
    from stormx.sparse import formats as jf
    from stormx_torch.precond import BlockDiaAmg
    from stormx_torch.sparse.formats import DIA

    nx = 256
    offsets, data, b = _problem(nx)
    n = nx * nx
    t = BlockDiaAmg(DIA(data=torch.as_tensor(data), offsets=offsets, shape=(n, n)),
                    **chip_smoke.AMG_OPTIONS)
    j = JAmg(jf.DIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n)),
             **chip_smoke.AMG_OPTIONS)
    assert len(t._levels) == len(j._levels) == 4
    for lt, lj in zip(t._levels, j._levels):
        assert lt["op"].offsets == lj["op"].offsets
        np.testing.assert_array_equal(lt["op"].data.numpy(), np.asarray(lj["op"].data))
        np.testing.assert_array_equal(lt["inv_diag"].numpy(), np.asarray(lj["inv_diag"]))
    np.testing.assert_array_equal(t._coarse_inv.numpy(), np.asarray(j._coarse_inv))
    z_t, z_j = t(torch.as_tensor(b)).numpy(), np.asarray(j(jnp.asarray(b)))
    assert z_t.dtype == z_j.dtype == np.float32
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=1e-5 * np.abs(z_j).max())


@pytest.mark.parametrize("method", METHODS)
def test_float32_methods_converge_below_the_breakdown_size(method):
    t, j = run_torch(128, method), run_jax(128, method)
    assert t["converged"] and j["converged"]
    # The float32 histories part after a few iterations; the counts stay
    # close (measured: 36/35, 38/37, 42/40 and 64/65).
    assert abs(t["iterations"] - j["iterations"]) <= 0.1 * j["iterations"] + 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nx", type=int, help="grid side of the Poisson operator")
    ap.add_argument("methods", help="comma-separated, from " + ",".join(METHODS))
    ap.add_argument("--side", choices=("both", "torch", "jax"), default="both")
    ap.add_argument("--device", default="cpu", help="device of the torch side")
    ap.add_argument("--cap", type=int, default=chip_smoke.KRYLOV_MAX_ITERATIONS)
    args = ap.parse_args(argv)
    for method in args.methods.split(","):
        if args.side in ("both", "torch"):
            print(json.dumps(dict(nx=args.nx, method=method, side="stormx_torch",
                                  device=args.device,
                                  **run_torch(args.nx, method, args.device, args.cap))),
                  flush=True)
        if args.side in ("both", "jax"):
            print(json.dumps(dict(nx=args.nx, method=method, side="stormx (JAX, CPU)",
                                  **run_jax(args.nx, method, args.cap))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
