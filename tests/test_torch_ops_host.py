"""``stormx_torch.ops`` dense, permutation and segment helpers against the
JAX package's, on the same numpy-made inputs, on the CPU.

Integer results and every min/max are exact; float segment sums are
bit-equal too (both packages add each segment's entries in input order on
the CPU); LU solves agree to 1e-13 relative (LAPACK pivots the same way,
the back-substitutions round apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.ops as J
import stormx_torch.ops as T
from stormx_torch.core import assert_deterministic


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class TestDense:
    def test_aabb(self):
        rng = np.random.default_rng(0)
        pts = rng.standard_normal((50, 3))
        t, j = T.aabb_of(torch.as_tensor(pts)), J.aabb_of(jnp.asarray(pts))
        for attr in ("min", "max", "center", "extents"):
            np.testing.assert_array_equal(_np(getattr(t, attr)), _np(getattr(j, attr)))
        p = np.array([5.0, -7.0, 0.0])
        te, je = t.extend(torch.as_tensor(p)), j.extend(jnp.asarray(p))
        np.testing.assert_array_equal(_np(te.min), _np(je.min))
        np.testing.assert_array_equal(_np(te.max), _np(je.max))
        other = T.aabb_of(torch.as_tensor(pts + 10))
        tb = t.extend(other)
        jb = j.extend(J.aabb_of(jnp.asarray(pts + 10)))
        np.testing.assert_array_equal(_np(tb.max), _np(jb.max))
        np.testing.assert_array_equal(_np(tb.min), _np(jb.min))

    @pytest.mark.parametrize("dim", [2, 3])
    def test_cross_product(self, dim):
        rng = np.random.default_rng(dim)
        a, b = rng.standard_normal((7, dim)), rng.standard_normal((7, dim))
        got = _np(T.cross_product(torch.as_tensor(a), torch.as_tensor(b)))
        want = _np(J.cross_product(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)

    @pytest.mark.parametrize("rhs", [(6,), (6, 3)])
    def test_solve_lu(self, rhs):
        rng = np.random.default_rng(4)
        a = rng.standard_normal((6, 6)) + 6 * np.eye(6)
        b = rng.standard_normal(rhs)
        got = _np(T.solve_lu(torch.as_tensor(a), torch.as_tensor(b)))
        want = _np(J.solve_lu(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == want.shape == rhs
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(a @ got, b, atol=1e-12)

    def test_inverse_lu(self):
        rng = np.random.default_rng(5)
        a = rng.standard_normal((5, 5)) + 5 * np.eye(5)
        got = _np(T.inverse_lu(torch.as_tensor(a)))
        np.testing.assert_allclose(got, _np(J.inverse_lu(jnp.asarray(a))), rtol=1e-13,
                                   atol=1e-15)
        np.testing.assert_allclose(got @ a, np.eye(5), atol=1e-13)

    def test_complex_solve_lu(self):
        rng = np.random.default_rng(6)
        a = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)) + 4 * np.eye(4)
        b = rng.standard_normal(4) + 0j
        got = _np(T.solve_lu(torch.as_tensor(a), torch.as_tensor(b)))
        np.testing.assert_allclose(got, np.linalg.solve(a, b), rtol=1e-13)


class TestPermutations:
    @pytest.mark.parametrize("perm,ok", [
        ([2, 0, 1, 3], True), ([0], True), ([], True), ([1, 1, 0], False),
        ([0, 3, 1], False), ([-1, 0, 1], False),
    ])
    def test_is_permutation(self, perm, ok):
        p = np.asarray(perm, dtype=np.int32)
        assert bool(T.is_permutation(torch.as_tensor(p))) is ok
        assert bool(J.is_permutation(jnp.asarray(p))) is ok

    def test_invert_permute_inverse_permute(self):
        rng = np.random.default_rng(7)
        perm = rng.permutation(20).astype(np.int32)
        vals = rng.standard_normal((20, 2))
        inv_t = T.invert_permutation(torch.as_tensor(perm))
        assert inv_t.dtype == torch.int32
        np.testing.assert_array_equal(_np(inv_t), _np(J.invert_permutation(jnp.asarray(perm))))
        for name in ("permute", "inverse_permute"):
            got = _np(getattr(T, name)(torch.as_tensor(vals), torch.as_tensor(perm)))
            want = _np(getattr(J, name)(jnp.asarray(vals), jnp.asarray(perm)))
            np.testing.assert_array_equal(got, want)
        back = T.inverse_permute(T.permute(torch.as_tensor(vals), torch.as_tensor(perm)),
                                 torch.as_tensor(perm))
        np.testing.assert_array_equal(_np(back), vals)


SEGMENT_DTYPES = [np.float64, np.float32, np.int32, np.int64]


def _segment_inputs(dtype, shape=(200,), seed=8):
    rng = np.random.default_rng(seed)
    # 13 segments, of which 3, 7 and 12 stay empty; a few ids fall outside.
    ids = rng.choice([0, 1, 2, 4, 5, 6, 8, 9, 10, 11, -1, 13], size=shape[0]).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        data = rng.integers(-1000, 1000, size=shape).astype(dtype)
    else:
        data = rng.standard_normal(shape).astype(dtype)
    return data, ids


class TestSegments:
    @pytest.mark.parametrize("name", ["segment_sum", "segment_min", "segment_max"])
    @pytest.mark.parametrize("dtype", SEGMENT_DTYPES, ids=lambda d: np.dtype(d).name)
    def test_against_jax(self, name, dtype):
        data, ids = _segment_inputs(dtype)
        got = _np(getattr(T, name)(torch.as_tensor(data), torch.as_tensor(ids), 13))
        want = _np(getattr(J, name)(jnp.asarray(data), jnp.asarray(ids), 13))
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()

    def test_empty_segments_take_jax_values(self):
        f = torch.tensor([1.0, 2.0], dtype=torch.float64)
        i = torch.tensor([1, 2], dtype=torch.int32)
        ids = torch.tensor([0, 0])
        assert T.segment_sum(f, ids, 3).tolist() == [3.0, 0.0, 0.0]
        assert T.segment_min(f, ids, 3).tolist() == [1.0, float("inf"), float("inf")]
        assert T.segment_max(f, ids, 3).tolist() == [2.0, float("-inf"), float("-inf")]
        info = np.iinfo(np.int32)
        assert T.segment_min(i, ids, 2).tolist() == [1, info.max]
        assert T.segment_max(i, ids, 2).tolist() == [2, info.min]
        assert list(_np(J.segment_min(jnp.asarray([1, 2], jnp.int32), jnp.asarray([0, 0]), 2))) \
            == [1, info.max]

    @pytest.mark.parametrize("name", ["segment_sum", "segment_min", "segment_max"])
    def test_rows_of_components(self, name):
        data, ids = _segment_inputs(np.float64, shape=(200, 3))
        got = _np(getattr(T, name)(torch.as_tensor(data), torch.as_tensor(ids), 13))
        want = _np(getattr(J, name)(jnp.asarray(data), jnp.asarray(ids), 13))
        assert got.shape == (13, 3)
        assert got.tobytes() == want.tobytes()

    def test_complex_sum(self):
        data, ids = _segment_inputs(np.float64)
        cdata = data + 1j * data[::-1]
        got = _np(T.segment_sum(torch.as_tensor(cdata), torch.as_tensor(ids), 13))
        want = _np(J.segment_sum(jnp.asarray(cdata), jnp.asarray(ids), 13))
        assert got.dtype == np.complex128
        assert got.tobytes() == want.tobytes()

    def test_sum_is_deterministic(self):
        data, ids = _segment_inputs(np.float32, shape=(4096,))
        assert_deterministic(T.segment_sum, torch.as_tensor(data), torch.as_tensor(ids), 13)
