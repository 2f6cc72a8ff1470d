"""Complex dtypes in stormx_torch against the JAX package, on the same
numpy-made inputs (the cases of ``tests/test_complex.py``).

Conventions, as ``tests/test_complex.py:16-23`` states them: ``dot(a, c)``
conjugates its second argument; BiCG-family shadow products put the shadow
vector in the conjugated slot; CG's √γ, TFQMR's τ and GMRES's |β| stay
real, so every ``SolveResult.history`` is a real tensor.

Tolerances: histories agree to 1e-10 relative (each entry also allowed
1e-13 of the initial residual) with equal iteration counts, as
``tests/test_torch_krylov.py`` holds the real runs — torch and XLA sum the
dot products in other orders.  ``sym_ortho`` agrees to 1e-15 relative
(the two packages divide the same numbers, but ``hypot`` may round apart by
an ulp).  GMRES's |β| tracks the true residual to 1e-6 relative.  The mesh
operators' gathers are bit-exact (K3's plain version against the JAX plan
in Pallas interpret mode, on the real and imaginary parts: the interpreter
has no complex dtype), and the operators agree to 1e-14 of their
largest entry (the per-cell sums run in other orders).  ``idrs`` takes the
same shadow vectors on both sides (``shadow=``), because the two packages'
generators draw other numbers from one seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx import solvers as js
from stormx.fvm.divgrad import div_grad as j_div_grad
from stormx.mesh import structured_tri_rect as j_tri_rect
from stormx.ops import sym_ortho as j_sym_ortho
from stormx.ops.vector import dot as j_dot
from stormx_torch import solvers as ts
from stormx_torch.fvm.divgrad import div_grad
from stormx_torch.mesh import structured_tri_rect
from stormx_torch.ops import safe_divide, sym_ortho
from stormx_torch.ops.banded_gather import decode_word
from stormx_torch.ops.vector import dot, norm_2

GENERAL = ["bicgstab", "bicgstab_l", "cgs", "tfqmr", "tfqmr1", "idrs", "gmres", "fgmres",
           "lgmres"]
OPTS = dict(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-10)
N = 40


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _hermitian(n=N, seed=4):
    rng = np.random.default_rng(seed)
    b_mat = _crandn(rng, n, n)
    return b_mat @ b_mat.conj().T + n * np.eye(n), _crandn(rng, n)


def _general(n=N, seed=5):
    rng = np.random.default_rng(seed)
    return _crandn(rng, n, n) + 3 * n ** 0.5 * np.eye(n), _crandn(rng, n)


def _extra(method, n):
    if method == "idrs":
        return {"shadow": _crandn(np.random.default_rng(11), 3, n)}
    return {}


def _run_both(method, matvec_np, b, *, options=OPTS, **extra):
    """One solve in each package on the same operator (``matvec_np``: the
    matrix and, for LSQR/LSMR, its adjoint) and inputs; returns (port
    result, JAX result)."""
    a_t = [torch.as_tensor(m) for m in matvec_np]
    a_j = [jnp.asarray(m) for m in matvec_np]
    t_extra = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in extra.items()}
    j_extra = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()}
    t_op = ts.make_operator(lambda x: a_t[0] @ x,
                            (lambda x: a_t[1] @ x) if len(a_t) > 1 else None)
    j_op = js.make_operator(lambda x: a_j[0] @ x,
                            (lambda x: a_j[1] @ x) if len(a_j) > 1 else None)
    t = getattr(ts, method)(t_op, torch.as_tensor(b), torch.zeros(len(b), dtype=torch.complex128),
                            options=ts.SolverOptions(**options), **t_extra)
    j = getattr(js, method)(j_op, jnp.asarray(b), jnp.zeros(len(b), dtype=complex),
                            options=js.SolverOptions(**options), **j_extra)
    return t, j


def _assert_same(t, j):
    assert t.converged == bool(j.converged)
    k = t.num_iterations
    assert k == int(j.num_iterations) > 0
    assert not t.history.is_complex()
    ht, hj = t.history.numpy(), np.asarray(j.history)
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=1e-10, atol=1e-13 * hj[0])


class TestComplexScalarOps:
    def test_dot_conjugates_second_argument(self):
        rng = np.random.default_rng(1)
        x, y = _crandn(rng, 8), _crandn(rng, 8)
        got = complex(dot(torch.as_tensor(x), torch.as_tensor(y)))
        assert got == pytest.approx(np.sum(x * np.conj(y)))
        assert got == pytest.approx(complex(j_dot(jnp.asarray(x), jnp.asarray(y))), rel=1e-15)

    def test_norm_is_real_and_positive(self):
        x = _crandn(np.random.default_rng(2), 16)
        got = norm_2(torch.as_tensor(x))
        assert not got.is_complex()
        assert float(got) == pytest.approx(np.linalg.norm(x))

    def test_safe_divide_complex(self):
        """Elementwise on complex tensors: the breakdown guard gives an exact
        zero, no NaN."""
        num = torch.tensor([1 + 2j, 3.0 + 0j, 1j])
        den = torch.tensor([2.0 + 0j, 0.0 + 0j, 1 - 1j])
        out = safe_divide(num, den).numpy()
        assert out[0] == pytest.approx((1 + 2j) / 2)
        assert out[1] == 0.0 and not np.isnan(out).any()
        assert out[2] == pytest.approx(1j / (1 - 1j))
        assert safe_divide(num, den).dtype == num.dtype

    def test_sym_ortho_complex_is_unitary_rotation(self):
        rng = np.random.default_rng(3)
        for _ in range(5):
            a, b = complex(_crandn(rng, 1)[0]), complex(_crandn(rng, 1)[0])
            cs, sn, rr = sym_ortho(torch.tensor(a, dtype=torch.complex128),
                                   torch.tensor(b, dtype=torch.complex128))
            assert cs.is_complex() and sn.is_complex() and not rr.is_complex()
            cs, sn, rr = complex(cs), complex(sn), float(rr)
            assert rr > 0
            assert abs(cs) ** 2 + abs(sn) ** 2 == pytest.approx(1.0)
            # [[conj(cs), conj(sn)], [-sn, cs]] @ [a, b] = [rr, 0]
            assert np.conj(cs) * a + np.conj(sn) * b == pytest.approx(rr)
            assert -sn * a + cs * b == pytest.approx(0.0, abs=1e-12)
            jcs, jsn, jrr = j_sym_ortho(jnp.asarray(a), jnp.asarray(b))
            for got, want in ((cs, jcs), (sn, jsn), (rr, jrr)):
                assert abs(got - complex(want)) <= 1e-15 * abs(complex(want))

    @pytest.mark.parametrize("a,b", [(3.0, 4.0), (0.0, 0.0), (-1e-300, 2e-300), (5.0, 0.0)])
    def test_sym_ortho_real_path_unchanged(self, a, b):
        """The real path: real outputs, the JAX package's values to 1e-15,
        and (1, 0, 0) at the origin."""
        cs, sn, rr = sym_ortho(torch.tensor(a, dtype=torch.float64),
                               torch.tensor(b, dtype=torch.float64))
        assert not cs.is_complex() and cs.dtype == torch.float64
        jcs, jsn, jrr = j_sym_ortho(jnp.asarray(a), jnp.asarray(b))
        for got, want in ((cs, jcs), (sn, jsn), (rr, jrr)):
            assert abs(float(got) - float(want)) <= 1e-15 * abs(float(want))
        if a == b == 0.0:
            assert (float(cs), float(sn), float(rr)) == (1.0, 0.0, 0.0)


class TestComplexSolves:
    def test_cg_hermitian(self):
        a, b = _hermitian()
        t, j = _run_both("cg", [a], b)
        assert t.converged
        np.testing.assert_allclose(t.x.numpy(), np.linalg.solve(a, b), atol=1e-8)
        _assert_same(t, j)

    @pytest.mark.parametrize("method", GENERAL)
    def test_general_complex(self, method):
        """Every transpose-free solver on a complex general operator: the
        BiCG-family recurrences need the shadow pairing LINEAR in the
        evolving vector (shadow vector in the conjugated slot).

        BiCGStab(l) is held to the JAX package only as far as its own
        rounding lets any two runs agree: its minimal-residual part takes
        the Gram–Schmidt coefficient as ``dot(r_i, r_j)``
        (``stormx/solvers/bicgstab.py:197``), the conjugate of the
        projection, which the port mirrors.  For complex data the r_j are
        then not orthogonalized, and the recurrence amplifies rounding ~10×
        per iteration: a 1e-15 change of b moves the port's own history by
        up to ~0.5 relative at the end of this run.  So its histories are
        compared to 1e-10 up to the entry where that self-sensitivity
        passes 1e-12, and beyond it both runs must take the same iteration
        count to the same true residual bound."""
        a, b = _general()
        t, j = _run_both(method, [a], b, **_extra(method, N))
        assert t.converged
        r = a @ t.x.numpy() - b
        assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)
        if method != "bicgstab_l":
            _assert_same(t, j)
            return
        t2, _ = _run_both(method, [a], b * (1 + 1e-15))
        k = t.num_iterations
        assert k == int(j.num_iterations) and bool(j.converged)
        ht, hj, h2 = t.history.numpy(), np.asarray(j.history), t2.history.numpy()
        self_gap = np.abs(ht[: k + 1] - h2[: k + 1]) / ht[: k + 1]
        stable = int(np.argmax(self_gap > 1e-12)) if (self_gap > 1e-12).any() else k + 1
        assert stable >= 5
        np.testing.assert_allclose(ht[:stable], hj[:stable], rtol=1e-10)
        rj = a @ np.asarray(j.x) - b
        assert np.linalg.norm(rj) <= 1e-9 * np.linalg.norm(b)

    @pytest.mark.parametrize("method", ["lsqr", "lsmr"])
    def test_least_squares_complex(self, method):
        """LSQR/LSMR through the conjugate product 𝓐ᴴ; Golub–Kahan α/β stay
        real, so the real ``sym_ortho`` path applies."""
        a, b = _general(seed=6)
        t, j = _run_both(method, [a, a.conj().T], b)
        assert t.converged
        r = a @ t.x.numpy() - b
        assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b)
        _assert_same(t, j)

    def test_richardson_complex_contractive(self):
        """Richardson with ω sized to the operator on a contractive complex
        perturbation of the identity."""
        rng = np.random.default_rng(8)
        c = np.eye(N) - 0.02 * _crandn(rng, N, N)
        b = _crandn(rng, N)
        t, j = _run_both("richardson", [c], b, relaxation_factor=1.0)
        assert t.converged
        assert np.linalg.norm(c @ t.x.numpy() - b) <= 1e-9 * np.linalg.norm(b)
        _assert_same(t, j)

    @pytest.mark.parametrize("method", ["gmres", "fgmres", "lgmres"])
    def test_gmres_residual_estimate_tracks_true_residual(self, method):
        """|β(k+1)| equals the true residual norm only if the rotations stay
        UNITARY for complex data."""
        a, b = _general(seed=7)
        opts = dict(num_iterations=25, absolute_tolerance=0.0, relative_tolerance=0.0)
        t, j = _run_both(method, [a], b, options=opts)
        est = float(t.history[t.num_iterations])
        true = float(np.linalg.norm(a @ t.x.numpy() - b))
        assert est == pytest.approx(true, rel=1e-6)
        np.testing.assert_allclose(t.history.numpy(), np.asarray(j.history), rtol=1e-10,
                                   atol=1e-13 * float(t.history[0]))

    def test_real_gmres_path_unchanged(self):
        """On a real operator the conjugates are identities: the port's
        real GMRES history equals the JAX package's to 1e-10."""
        a, b = _general()
        a, b = a.real.copy(), b.real.copy()
        opts = dict(OPTS)
        t = ts.gmres(ts.make_operator(lambda x: torch.as_tensor(a) @ x), torch.as_tensor(b),
                     torch.zeros(N, dtype=torch.float64), options=ts.SolverOptions(**opts))
        j = js.gmres(js.make_operator(lambda x: jnp.asarray(a) @ x), jnp.asarray(b),
                     jnp.zeros(N), options=js.SolverOptions(**opts))
        _assert_same(t, j)


# -- the mesh operators of the card's complex phase, at a small size -------------
TAU, KAPPA = 1e-3, 0.5


def _meshes():
    return structured_tri_rect(12, 10), j_tri_rect(12, 10)


def _ops(dm, dg):
    """A_h c = (I − τΔ)c, A_g c = ((1 + iκ) − τΔ)c and A_gᴴ, from
    ``div_grad`` only (``dg`` is either package's)."""
    def a_h(c):
        return dg(dm, c, -TAU, c)

    def a_g(c):
        return dg(dm, (1 + 1j * KAPPA) * c, -TAU, c)

    def a_gh(c):
        return dg(dm, (1 - 1j * KAPPA) * c, -TAU, c)

    return a_h, a_g, a_gh


@pytest.fixture(scope="module")
def device_meshes():
    tm, jm = _meshes()
    return (tm, jm, tm.device_arrays(torch.float64, device="cpu", banded_gather=True),
            jm.device_arrays(jnp.float64, banded_gather=False),
            tm.device_arrays(torch.float64, device="cpu", banded_gather=False),
            jm.device_arrays(jnp.float64, banded_gather=True))


def _cfield(n, seed):
    return _crandn(np.random.default_rng(seed), n)


def test_equal_volumes_make_the_laplacian_symmetric(device_meshes):
    """The mesh's cells have equal volumes, so ⟨A_g x, y⟩ = ⟨x, A_gᴴ y⟩."""
    tm, _, td, _, _, _ = device_meshes
    assert np.ptp(tm.cell_volumes) <= 1e-12 * tm.cell_volumes.max()
    _, a_g, a_gh = _ops(td, div_grad)
    x = torch.as_tensor(_cfield(tm.num_cells, 1))
    y = torch.as_tensor(_cfield(tm.num_cells, 2))
    lhs, rhs = complex(dot(a_g(x), y)), complex(dot(x, a_gh(y)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("plan", ["face_inner", "face_outer", "cell_face", "cell_adj"])
def test_complex128_gathers_bit_exact(device_meshes, plan):
    """K3's plain version on a complex128 field against x[idx] and against
    the JAX plan in Pallas interpret mode: bit-exact.  Pallas's interpreter
    has no complex dtype, so the JAX plan gathers the real and the imaginary
    parts, which is the same copy of bits."""
    _, _, td, _, _, jd_plans = device_meshes
    tp, jp = getattr(td, "bg_" + plan), getattr(jd_plans, "bg_" + plan)
    x = _cfield(tp.n_src, 3)
    got = tp(torch.as_tensor(x)).numpy()
    want = np.asarray(jp(jnp.asarray(x.real))) + 1j * np.asarray(jp(jnp.asarray(x.imag)))
    assert got.dtype == np.complex128
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == x[decode_word(tp).numpy()].tobytes()


@pytest.mark.parametrize("which", [0, 1, 2])
def test_div_grad_complex_operators_match_jax(device_meshes, which):
    """A_h, A_g and A_gᴴ on a complex128 field: with K3's plain version and
    with tensor indexing, bit-equal to each other, and within 1e-14 of the
    JAX package's operator (its plain gathers: its plans' interpreter has
    no complex dtype)."""
    tm, _, td, jd, td_plain, _ = device_meshes
    x = _cfield(tm.num_cells, 4)
    got = _ops(td, div_grad)[which](torch.as_tensor(x))
    plain = _ops(td_plain, div_grad)[which](torch.as_tensor(x))
    want = np.asarray(_ops(jd, j_div_grad)[which](jnp.asarray(x)))
    assert got.dtype == torch.complex128
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14 * np.abs(want).max())


def test_complex64_needs_a_float32_mesh():
    """A float64 mesh times a complex64 field promotes to complex128, in
    torch as in JAX; a float32 mesh keeps complex64."""
    tm, jm = _meshes()
    x = _cfield(tm.num_cells, 5).astype(np.complex64)
    d64 = tm.device_arrays(torch.float64, device="cpu", banded_gather=True)
    d32 = tm.device_arrays(torch.float32, device="cpu", banded_gather=True)
    j64 = jm.device_arrays(jnp.float64, banded_gather=False)
    assert _ops(d64, div_grad)[1](torch.as_tensor(x)).dtype == torch.complex128
    assert _ops(j64, j_div_grad)[1](jnp.asarray(x)).dtype == jnp.complex128
    y32 = _ops(d32, div_grad)[1](torch.as_tensor(x))
    assert y32.dtype == torch.complex64
    y64 = _ops(d64, div_grad)[1](torch.as_tensor(x.astype(np.complex128)))
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=0,
                               atol=1e-5 * float(y64.abs().max()))


@pytest.mark.parametrize("method", ["cg", "gmres", "bicgstab", "lsqr"])
def test_mesh_operator_solves_match_jax(device_meshes, method):
    """CG on A_h, GMRES and BiCGStab on A_g, LSQR on (A_g, A_gᴴ): the
    port's histories equal the JAX package's to 1e-10 relative."""
    tm, _, td, jd, _, _ = device_meshes
    a_h, a_g, a_gh = _ops(td, div_grad)
    ja_h, ja_g, ja_gh = _ops(jd, j_div_grad)
    b = _cfield(tm.num_cells, 6)
    opts = dict(num_iterations=400, absolute_tolerance=0.0, relative_tolerance=1e-10)
    t_op = (ts.make_operator(a_h) if method == "cg" else
            ts.make_operator(a_g, a_gh if method == "lsqr" else None))
    j_op = (js.make_operator(ja_h) if method == "cg" else
            js.make_operator(ja_g, ja_gh if method == "lsqr" else None))
    t = getattr(ts, method)(t_op, torch.as_tensor(b), torch.zeros(len(b), dtype=torch.complex128),
                            options=ts.SolverOptions(**opts))
    j = getattr(js, method)(j_op, jnp.asarray(b), jnp.zeros(len(b), dtype=complex),
                            options=js.SolverOptions(**opts))
    assert t.converged
    _assert_same(t, j)
    r = (a_h if method == "cg" else a_g)(t.x) - torch.as_tensor(b)
    assert float(norm_2(r)) <= (1e-8 if method == "lsqr" else 1e-9) * np.linalg.norm(b)
