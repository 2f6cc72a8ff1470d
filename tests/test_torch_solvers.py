"""CG, Jacobi and the iteration driver of stormx_torch against the JAX
package and against a NumPy hand-run of the reference CG, in float64.

Histories agree to 1e-10 relative with equal iteration counts: torch and
XLA sum dot products in different orders, and the conditioning of the
operator amplifies that difference along the recurrence
(``tests/test_milestone_a.py:16-21``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.ops import safe_divide as j_safe_divide
from stormx.ops import vector as jv
from stormx.precond import JacobiPreconditioner as JJacobi
from stormx.solvers import SolverOptions as JOptions
from stormx.solvers import cg as j_cg
from stormx.solvers import make_operator as j_make_operator
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import safe_divide, safe_inverse
from stormx_torch.ops import vector as tv
from stormx_torch.precond import JacobiPreconditioner
from stormx_torch.solvers import SolverOptions, cg, make_operator, run_iterative
from stormx_torch.sparse.formats import csr_from_dense, ell_from_csr

N = 40


def _spd(n, rng, density=0.3):
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return a @ a.T + n * np.eye(n)


def _mesh_spd():
    """A mesh Laplacian shifted by 0.1·I: 240 unknowns, cond ~1e2, so CG
    converges well before n iterations (past n, rounding decides the count)."""
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import structured_tri_rect

    return assemble_laplacian(structured_tri_rect(12, 10)).to_csr().todense().numpy() \
        + 0.1 * np.eye(240)


def np_safe_divide(x, y):
    return 0.0 if y == 0 else x / y


def np_cg(a, b, iters, diag=None):
    """Hand-run of the reference CG (SolverCg.hpp pseudocode); a copy of
    ``tests/test_golden_histories.py:np_cg``."""
    pre = (lambda r: r / diag) if diag is not None else (lambda r: r)
    x = np.zeros(len(b))
    r = b - a @ x
    z = pre(r)
    p = z
    gamma = r @ z
    errs = [np.linalg.norm(r)]
    for _ in range(iters):
        z = a @ p
        alpha = np_safe_divide(gamma, p @ z)
        x = x + alpha * p
        r = r - alpha * z
        z = pre(r)
        gamma_new = r @ z
        beta = np_safe_divide(gamma_new, gamma)
        gamma = gamma_new
        p = z + beta * p
        errs.append(np.linalg.norm(r))
    return x, np.array(errs)


def _fixed(k):
    return dict(num_iterations=k, absolute_tolerance=0.0, relative_tolerance=0.0)


def _both(a, b, opts, jacobi):
    dt = torch.as_tensor(np.diag(a).copy())
    t = cg(make_operator(lambda x: torch.as_tensor(a) @ x), torch.as_tensor(b),
           torch.zeros(len(b), dtype=torch.float64),
           precond=JacobiPreconditioner(diag=dt) if jacobi else None,
           options=SolverOptions(**opts))
    j = j_cg(j_make_operator(lambda x: jnp.asarray(a) @ x), jnp.asarray(b),
             jnp.zeros(len(b)), precond=JJacobi(diag=jnp.asarray(np.diag(a))) if jacobi else None,
             options=JOptions(**opts))
    return t, j


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("matrix", ["spd", "mesh"])
def test_cg_matches_jax(rng, jacobi, matrix):
    a = _spd(N, rng) if matrix == "spd" else _mesh_spd()
    b = rng.standard_normal(len(a))
    opts = dict(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-8)
    t, j = _both(a, b, opts, jacobi)
    assert t.converged == bool(j.converged)
    assert t.num_iterations == int(j.num_iterations) > 0
    k = t.num_iterations
    ht, hj = t.history.numpy(), np.asarray(j.history)
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=1e-10)
    assert np.isnan(ht[k + 1:]).all() and np.isnan(hj[k + 1:]).all()
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(t.relative_error), float(j.relative_error), rtol=1e-10)


@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_matches_numpy_golden(rng, jacobi):
    a = _spd(N, rng)
    b = rng.standard_normal(N)
    t, _ = _both(a, b, _fixed(15), jacobi)
    x_ref, h_ref = np_cg(a, b, 15, np.diag(a) if jacobi else None)
    np.testing.assert_allclose(t.history.numpy(), h_ref, rtol=1e-10)
    np.testing.assert_allclose(t.x.numpy(), x_ref, rtol=1e-10, atol=1e-12)


def test_cg_on_sparse_operator(rng):
    a = _spd(N, rng, density=0.1)
    b = rng.standard_normal(N)
    ell = ell_from_csr(csr_from_dense(a))
    t = cg(ell, torch.as_tensor(b), torch.zeros(N, dtype=torch.float64),
           precond=JacobiPreconditioner(matrix=ell), options=SolverOptions(**_fixed(10)))
    _, h_ref = np_cg(a, b, 10, np.diag(a))
    np.testing.assert_allclose(t.history.numpy(), h_ref, rtol=1e-10)


class TestStoppingRule:
    """The edge cases of ``stormx/solvers/base.py:1-25``."""

    def test_preloop_absolute_exit(self, rng):
        a = _spd(N, rng)
        x = rng.standard_normal(N)
        b = a @ x
        opts = dict(num_iterations=50, absolute_tolerance=1e-3, relative_tolerance=1e-6)
        res = cg(make_operator(lambda v: torch.as_tensor(a) @ v), torch.as_tensor(b),
                 torch.as_tensor(x), options=SolverOptions(**opts))
        jres = j_cg(j_make_operator(lambda v: jnp.asarray(a) @ v), jnp.asarray(b),
                    jnp.asarray(x), options=JOptions(**opts))
        assert res.converged and res.num_iterations == 0 == int(jres.num_iterations)
        assert float(res.relative_error) == 1.0
        h = res.history.numpy()
        assert h[0] == float(res.absolute_error) and np.isnan(h[1:]).all()

    def test_relative_rule_only_after_an_iteration(self, rng):
        # atol = 0 disables the pre-loop exit even for an exact x0.
        a = _spd(N, rng)
        x = rng.standard_normal(N)
        res = cg(make_operator(lambda v: torch.as_tensor(a) @ v), torch.as_tensor(a @ x),
                 torch.as_tensor(x), options=SolverOptions(absolute_tolerance=0.0))
        assert res.num_iterations >= 1

    def test_zero_tolerances_run_every_iteration(self, rng):
        a = _spd(N, rng)
        b = rng.standard_normal(N)
        t, j = _both(a, b, _fixed(7), jacobi=False)
        assert t.num_iterations == 7 == int(j.num_iterations)
        assert not t.converged and not bool(j.converged)
        assert not np.isnan(t.history.numpy()).any()

    def test_no_history(self, rng):
        a = _spd(N, rng)
        res = cg(make_operator(lambda v: torch.as_tensor(a) @ v),
                 torch.as_tensor(rng.standard_normal(N)), torch.zeros(N, dtype=torch.float64),
                 options=SolverOptions(record_history=False))
        assert res.history is None and res.converged

    def test_finalize_skipped_after_zero_iterations(self):
        calls = []

        def init(x):
            return None, torch.tensor(0.0, dtype=torch.float64)

        def iterate(it, x, st):
            raise AssertionError("no iteration may run")

        def finalize(it, x, st):
            calls.append(it)
            return x

        opts = SolverOptions(absolute_tolerance=1e-6)
        res = run_iterative(init, iterate, finalize, torch.zeros(3), opts)
        assert res.num_iterations == 0 and res.converged and calls == []

    def test_finalize_runs_once_after_iterations(self):
        calls = []

        def init(x):
            return 0, torch.tensor(1.0, dtype=torch.float64)

        def iterate(it, x, st):
            return x + 1, st + 1, torch.tensor(0.5 ** (it + 1), dtype=torch.float64)

        def finalize(it, x, st):
            calls.append((it, st))
            return x * 10

        opts = SolverOptions(num_iterations=100, absolute_tolerance=0.0, relative_tolerance=0.1)
        res = run_iterative(init, iterate, finalize, torch.zeros(()), opts)
        # 0.5**4 = 0.0625 < 0.1 is the first relative error under the tolerance
        assert res.num_iterations == 4 and calls == [(4, 4)] and float(res.x) == 40.0
        np.testing.assert_allclose(res.history.numpy()[:5], [1, 0.5, 0.25, 0.125, 0.0625])


def test_safe_divide_and_vector_ops(rng):
    x = rng.standard_normal(17)
    y = rng.standard_normal(17)
    y[3] = 0.0
    np.testing.assert_array_equal(safe_divide(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                                  np.asarray(j_safe_divide(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(safe_inverse(torch.as_tensor(y)).numpy()[3], 0.0)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    pairs = [
        (tv.dot(tx, ty), jv.dot(jx, jy)),
        (tv.norm_2(tx), jv.norm_2(jx)),
        (tv.norm_1(tx), jv.norm_1(jx)),
        (tv.norm_inf(tx), jv.norm_inf(jx)),
        (tv.norm_p(tx, 3), jv.norm_p(jx, 3)),
        (tv.axpy(0.3, tx, ty), jv.axpy(0.3, jx, jy)),
        (tv.xpay(tx, 0.3, ty), jv.xpay(jx, 0.3, jy)),
        (tv.lincomb([0.5, -2.0], [tx, ty]), jv.lincomb([0.5, -2.0], [jx, jy])),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13, atol=1e-15)
    zc = torch.as_tensor(x + 1j * y)
    np.testing.assert_allclose(complex(tv.dot(zc, zc)), np.vdot(x + 1j * y, x + 1j * y))
    with pytest.raises(StormError, match="make_device_mesh"):
        tv.dot(tx, ty, axis_name="i")


# -- the blocked loop (solvers/base.py's graph path, run without capture) ----

# name -> (SolverOptions keywords, Jacobi, right-hand side, dtype).  "cap"
# stops at num_iterations unconverged; "breakdown" solves A·x = 0 from 0, so
# γ = 0 and every α and β is safe_divide's 0 (and rel = 0/0 never passes).
BLOCK_CASES = {
    "both": (dict(num_iterations=500, absolute_tolerance=1e-7, relative_tolerance=1e-8),
             False, "random", torch.float64),
    "atol": (dict(num_iterations=500, absolute_tolerance=1e-7, relative_tolerance=0.0),
             False, "random", torch.float64),
    "rtol": (dict(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-9),
             False, "random", torch.float64),
    "preloop": (dict(num_iterations=50, absolute_tolerance=1e-3, relative_tolerance=1e-6),
                False, "exact", torch.float64),
    "breakdown": (dict(num_iterations=7, absolute_tolerance=0.0, relative_tolerance=1e-6),
                  False, "zero", torch.float64),
    "jacobi": (dict(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-9),
               True, "random", torch.float64),
    "cap": (dict(num_iterations=10, absolute_tolerance=0.0, relative_tolerance=1e-30),
            True, "random", torch.float64),
    "none": (dict(num_iterations=5, absolute_tolerance=0.0, relative_tolerance=0.0),
             False, "random", torch.float64),
    "float32": (dict(num_iterations=500, absolute_tolerance=1e-5, relative_tolerance=1e-6),
                True, "random", torch.float32),
}


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
@pytest.mark.parametrize("k", [1, 3, 32])
def test_blocked_loop_matches_eager_bit_for_bit(rng, monkeypatch, k, case):
    """The device-resident block of ``run_iterative`` (frozen iterations,
    one read a block, the errors kept by block), taking over from the eager
    loop after k iterations and handing the rest back to it, gives the
    eager loop's result bit for bit: x, history, iterations, converged,
    both errors."""
    from stormx_torch.solvers import base

    opts, jacobi, rhs, dtype = BLOCK_CASES[case]
    a = _mesh_spd()
    x_true = rng.standard_normal(len(a))
    b = {"random": rng.standard_normal(len(a)), "exact": a @ x_true,
         "zero": np.zeros(len(a))}[rhs]
    x0 = torch.as_tensor(x_true if rhs == "exact" else np.zeros(len(a)), dtype=dtype)
    at = torch.as_tensor(a, dtype=dtype)

    def solve():
        return cg(make_operator(lambda x: at @ x), torch.as_tensor(b, dtype=dtype), x0,
                  precond=JacobiPreconditioner(diag=at.diagonal().clone()) if jacobi else None,
                  options=SolverOptions(**opts))

    eager = solve()
    blocks = []
    monkeypatch.setattr(base, "BLOCK_ITERATIONS", k)
    monkeypatch.setattr(base, "_engages", lambda x0: True)
    run_blocks = base._run_blocks
    monkeypatch.setattr(base, "_run_blocks", lambda *a, **kw: blocks.append(1)
                        or run_blocks(*a, **kw))
    blocked = solve()
    # The blocks take over after k eager iterations, if a whole block fits.
    n_max = opts["num_iterations"]
    assert len(blocks) == int(eager.num_iterations > k and n_max - k >= k)
    assert blocked.num_iterations == eager.num_iterations
    assert blocked.converged == eager.converged
    for name in ("x", "history", "absolute_error", "relative_error"):
        got, want = getattr(blocked, name), getattr(eager, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.equal(_bits(got), _bits(want)), name
    want_iterations = {"preloop": 0, "breakdown": 7, "cap": 10, "none": 5}
    if case in want_iterations:
        assert eager.num_iterations == want_iterations[case]
    else:
        assert eager.converged and 0 < eager.num_iterations < opts["num_iterations"]


def test_blocked_loop_takes_over_a_state_whose_dtype_changed(rng, monkeypatch):
    """From a float32 x0 and a float64 b, CG's x turns float64 in its first
    iteration, in the eager start: the blocks take over float64 tensors and
    give the eager loop's result.  A block whose iteration changed a
    tensor's dtype would refuse (its tensors are fixed)."""
    from stormx_torch.core.exceptions import CaptureRefusedError
    from stormx_torch.solvers import base

    a = torch.as_tensor(_spd(N, rng))
    b = torch.as_tensor(rng.standard_normal(N))
    opts = SolverOptions(num_iterations=50, absolute_tolerance=0.0, relative_tolerance=1e-8)

    def solve():
        return cg(make_operator(lambda x: a @ x.double()), b, torch.zeros(N, dtype=torch.float32),
                  options=opts)

    eager = solve()
    monkeypatch.setattr(base, "BLOCK_ITERATIONS", 2)
    monkeypatch.setattr(base, "_engages", lambda x0: True)
    before = base.graph_stats["fallbacks"]
    blocked = solve()
    assert base.graph_stats["fallbacks"] == before
    assert eager.x.dtype == blocked.x.dtype == torch.float64
    assert eager.converged and blocked.num_iterations == eager.num_iterations > 4
    assert torch.equal(_bits(blocked.x), _bits(eager.x))
    assert torch.equal(_bits(blocked.history), _bits(eager.history))
    with pytest.raises(CaptureRefusedError, match="dtype"):
        base._refuse_unlike(torch.zeros(3, dtype=torch.float64), torch.zeros(3))


@pytest.mark.parametrize("where", ["eager", "block"])
def test_refusing_preconditioner_falls_back_to_the_eager_loop(rng, monkeypatch, where):
    """A preconditioner that cannot be captured refuses through
    ``capture.refuse`` at its eager calls (as T1 does): the solve sees the
    count move over its eager start and takes no block.  One that refuses
    only inside a block (as T1 does inside a capture) sends the solve back
    to the eager loop from the same state.  Either way the result is the
    eager loop's, and each solve finds the refusal anew (nothing is
    remembered between solves)."""
    from stormx_torch.core.exceptions import CaptureRefusedError
    from stormx_torch.ops import capture
    from stormx_torch.solvers import base

    class Refuses(JacobiPreconditioner):
        in_block = False

        def __call__(self, r):
            if where == "eager":
                capture.refuse("refused")
            elif self.in_block:
                raise CaptureRefusedError("refused")
            return super().__call__(r)

    a = torch.as_tensor(_mesh_spd())
    b = torch.as_tensor(rng.standard_normal(len(a)))
    opts = SolverOptions(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-9)
    precond = Refuses(diag=a.diagonal().clone())

    def solve(p):
        return cg(make_operator(lambda x: a @ x), b, torch.zeros_like(b), precond=p,
                  options=opts)

    eager = solve(JacobiPreconditioner(diag=a.diagonal().clone()))
    blocks = []
    monkeypatch.setattr(base, "BLOCK_ITERATIONS", 4)
    monkeypatch.setattr(base, "_engages", lambda x0: True)
    run_blocks = base._run_blocks

    def spy(*args, **kwargs):
        blocks.append(1)
        precond.in_block = True
        try:
            return run_blocks(*args, **kwargs)
        finally:
            precond.in_block = False

    monkeypatch.setattr(base, "_run_blocks", spy)
    before = base.graph_stats["fallbacks"]
    for n in (1, 2):
        res = solve(precond)
        assert len(blocks) == (0 if where == "eager" else n)
        assert base.graph_stats["fallbacks"] == before + n
        assert res.num_iterations == eager.num_iterations > 8 and res.converged
        for name in ("x", "history", "absolute_error", "relative_error"):
            assert torch.equal(_bits(getattr(res, name)), _bits(getattr(eager, name))), name


@pytest.mark.parametrize("mode", ["nan_checks", "checked"])
def test_check_modes_keep_cg_eager(rng, monkeypatch, mode):
    """The check modes of ``core/debug.py`` read the device after each op,
    so they refuse a capture (``capture.refuse``): a CG under them takes no
    block and gives the eager loop's result; outside a capture each op only
    counts the refusal."""
    from stormx_torch.core import checked, enable_nan_checks
    from stormx_torch.core.exceptions import CaptureRefusedError
    from stormx_torch.ops import capture
    from stormx_torch.solvers import base

    a = torch.as_tensor(_mesh_spd())
    b = torch.as_tensor(rng.standard_normal(len(a)))
    opts = SolverOptions(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-9)

    def solve():
        return cg(make_operator(lambda x: a @ x), b, torch.zeros_like(b), options=opts)

    def under_mode(fn):
        if mode == "nan_checks":
            enable_nan_checks()
            try:
                return fn()
            finally:
                enable_nan_checks(False)
        err, out = checked(fn)()
        assert err.get() is None
        return out

    eager = solve()
    monkeypatch.setattr(base, "BLOCK_ITERATIONS", 4)
    monkeypatch.setattr(base, "_engages", lambda x0: True)
    run_blocks = base._run_blocks
    blocks = []
    monkeypatch.setattr(base, "_run_blocks", lambda *a, **kw: blocks.append(1)
                        or run_blocks(*a, **kw))
    before = (base.graph_stats["fallbacks"], capture.refusals)
    res = under_mode(solve)
    assert not blocks and base.graph_stats["fallbacks"] == before[0] + 1
    assert capture.refusals > before[1]
    assert res.num_iterations == eager.num_iterations > 8
    for name in ("x", "history", "absolute_error", "relative_error"):
        assert torch.equal(_bits(getattr(res, name)), _bits(getattr(eager, name))), name
    monkeypatch.setattr(capture, "capturing", lambda: True)
    with pytest.raises(CaptureRefusedError, match="check modes"):
        under_mode(lambda: a @ b)


def test_capture_takes_back_the_launch_counts_and_adds_them_per_replay():
    """ops/capture.py: ``take_back`` undoes what was counted since a
    snapshot (module counters, K3's per-plan counters and keys new since)
    and returns it; ``add`` counts it once more, as each graph replay does."""
    from stormx_torch.ops import capture, dia, sell_spmv
    from stormx_torch.ops.banded_gather import BandedGatherPlan

    plan = BandedGatherPlan(np.arange(8), 8, device="cpu")
    start = (sell_spmv.launches, dict(sell_spmv.branch_launches), dict(dia.launches))
    before = capture.snapshot()
    sell_spmv.launches += 3
    sell_spmv.branch_launches["staged"] += 3
    dia.launches["dia_spmv"] += 2
    plan.launches_by_shape[(1, torch.float32)] += 4
    change = capture.take_back(before)
    assert (sell_spmv.launches, dict(sell_spmv.branch_launches), dict(dia.launches)) == start
    assert plan.launches == 0 and len(change) == 4
    capture.add(change)
    capture.add(change)
    assert sell_spmv.launches == start[0] + 6
    assert sell_spmv.branch_launches["staged"] == start[1]["staged"] + 6
    assert dia.launches["dia_spmv"] == start[2]["dia_spmv"] + 4 and plan.launches == 8
    capture.add([(h, k, -2 * d) for h, k, d in change])
    assert (sell_spmv.launches, dict(sell_spmv.branch_launches), dict(dia.launches)) == start
