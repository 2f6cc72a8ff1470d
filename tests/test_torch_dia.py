"""K2 (the DIA SpMV and the fused CG update), ``DIA.matvec`` and
``assemble_divgrad_dia`` of stormx_torch against the JAX package, on the
CPU, where the port takes the kernels' plain versions.

The JAX side runs the Pallas kernels in interpret mode with 8-row tiles, as
``tests/test_pallas.py`` runs them.  Tolerances:
* float32: vectors within 1e-5·max|v|, dot products within 1e-5·Σ|aᵢ·bᵢ|
  (the two sides add in other orders: the JAX kernel per 128-lane tile,
  torch in its own blocked order);
* float64: within 1e-12 of the same scales;
* ``cg_step``: ten float64 iterations within 1e-10 relative, since the
  roundoff above is carried along the recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.fvm.divgrad import assemble_divgrad_dia as j_assemble_divgrad_dia
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx.ops import pallas_dia as pd
from stormx.ops import safe_divide as j_safe_divide
from stormx.sparse import formats as jf
from stormx_torch.fvm.divgrad import assemble_divgrad, assemble_divgrad_dia
from stormx_torch.mesh import structured_tri_rect
from stormx_torch.ops import dia as td
from stormx_torch.sparse.formats import DIA

TILE = 8  # rows of 128 lanes: several grid steps of the Pallas kernels

CASES = [
    (4096, (-128, -1, 0, 1, 128)),  # aligned ± multiple of 128
    (4096, (-130, -7, 0, 3, 257)),  # unaligned
    (5000, (-64, 0, 64)),  # ragged n
    (1024, (0,)),  # diagonal only
    (3000, (-2000, 0, 1700)),  # |offset| > n/2
]
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _data(n, offsets, dtype, seed=0, zero_outside=True):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n)).astype(dtype)
    if zero_outside:
        for d, off in enumerate(offsets):
            data[d, : max(0, -off)] = 0
            data[d, min(n, n - off):] = 0
    return data


def _both(data, offsets):
    n = data.shape[1]
    return (DIA(data=torch.as_tensor(data), offsets=offsets, shape=(n, n)),
            jf.DIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n)))


def _assert_vec(got, want, dtype):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("n,offsets", CASES)
def test_dia_spmv_and_dots_match_pallas(n, offsets, dtype):
    t, j = _both(_data(n, offsets, dtype), offsets)
    p = np.random.default_rng(1).standard_normal(n).astype(dtype)
    z_j, pz_j = pd._spmv_call(j, jnp.asarray(p), with_dot=True, tile_rows=TILE)
    z_t = td.dia_spmv(t, torch.as_tensor(p))
    z_d, pz_t = td.dia_spmv_dots(t, torch.as_tensor(p))
    assert z_t.dtype == z_d.dtype == pz_t.dtype == torch.from_numpy(p).dtype
    _assert_vec(z_t.numpy(), z_j, dtype)
    _assert_vec(z_d.numpy(), z_j, dtype)
    scale = float(np.abs(p.astype(np.float64) * np.asarray(z_j)).sum())
    assert abs(float(pz_t) - float(pz_j)) <= TOL[dtype] * scale


@pytest.mark.parametrize("n,offsets", CASES)
def test_dia_matvec_matches_jax_float64(n, offsets):
    # Entries outside the band are non-zero here: both must ignore them.
    t, j = _both(_data(n, offsets, np.float64, zero_outside=False), offsets)
    x = np.random.default_rng(2).standard_normal(n)
    _assert_vec(t.matvec(torch.as_tensor(x)).numpy(), j.matvec(jnp.asarray(x)), np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
def test_cg_fused_update_matches_pallas(dtype):
    n = 3000
    rng = np.random.default_rng(3)
    x, r, p, z = (rng.standard_normal(n).astype(dtype) for _ in range(4))
    alpha = dtype(0.37)
    xj, rj, rrj = pd.cg_fused_update(alpha, *(jnp.asarray(a) for a in (x, r, p, z)),
                                     tile_rows=TILE)
    inputs = [torch.tensor(a) for a in (x, r, p, z)]
    xt, rt, rrt = td.cg_fused_update(torch.tensor(alpha), *inputs)
    _assert_vec(xt.numpy(), xj, dtype)
    _assert_vec(rt.numpy(), rj, dtype)
    assert abs(float(rrt) - float(rrj)) <= TOL[dtype] * float(rrj)
    for t, a in zip(inputs, (x, r, p, z)):  # the update returns new tensors
        np.testing.assert_array_equal(t.numpy(), a)


def _spd_banded(n):
    offsets = (-128, -1, 0, 1, 128)
    data = np.zeros((5, n))
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 4.0 if off == 0 else -0.9
    return _both(data, offsets)


def test_cg_step_matches_jax_for_ten_iterations():
    """JAX's ``cg_step`` composed from its two kernels with 8-row tiles,
    as ``pallas_dia.py:267-279`` composes them."""
    n = 1024
    t, j = _spd_banded(n)
    b = np.random.default_rng(4).standard_normal(n)
    xj, rj, pj = jnp.zeros(n), jnp.asarray(b), jnp.asarray(b)
    gj = jnp.vdot(rj, rj)
    xt, rt, pt = torch.zeros(n, dtype=torch.float64), torch.as_tensor(b), torch.as_tensor(b)
    gt = torch.dot(rt, rt)
    for _ in range(10):
        z, pz = pd._spmv_call(j, pj, with_dot=True, tile_rows=TILE)
        alpha = j_safe_divide(gj, pz)
        xj, rj, rr = pd.cg_fused_update(alpha, xj, rj, pj, z, tile_rows=TILE)
        beta = j_safe_divide(rr, gj)
        pj, gj = rj + beta * pj, rr
        xt, rt, pt, gt = td.cg_step(t, xt, rt, pt, gt)
    for a_t, a_j in ((xt, xj), (rt, rj), (pt, pj)):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(a_j)).max())
    np.testing.assert_allclose(float(gt), float(gj), rtol=1e-10)
    assert float(gt) < 1e-3 * float(b @ b)


def test_cg_step_plain_equals_composition():
    """``cg_step`` is exactly K2a-with-dot, α, K2b, β and the p update."""
    t, _ = _spd_banded(512)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(512))
    x, p, g = torch.zeros_like(r), r, torch.dot(r, r)
    z, pz = td.dia_spmv_dots_plain(t, p)
    alpha = g / pz
    x2, r2, rr = td.cg_fused_update_plain(alpha, x, r, p, z)
    out = td.cg_step(t, x, r, p, g)
    for a, b_ in zip(out, (x2, r2, r2 + (rr / g) * p, rr)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("reorder", [False, True])
def test_assemble_divgrad_dia_matches_jax(reorder):
    dt, pt = assemble_divgrad_dia(structured_tri_rect(12, 10), reorder=reorder, device="cpu")
    dj, pj = j_assemble_divgrad_dia(j_rect(12, 10), reorder=reorder)
    assert dt.offsets == dj.offsets and dt.shape == dj.shape
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(dt.data.numpy(), np.asarray(dj.data), rtol=0, atol=1e-14)
    # The same operator as the ELL form, in the permuted order.
    ell = assemble_divgrad(structured_tri_rect(12, 10))
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(dt.shape[0]))
    np.testing.assert_allclose(dt.matvec(x[pt]).numpy(), ell.matvec(x).numpy()[pt],
                               rtol=1e-12, atol=1e-12)


def test_assemble_divgrad_dia_max_diags_error():
    with pytest.raises(ValueError, match="max_diags") as e_t:
        assemble_divgrad_dia(structured_tri_rect(12, 10), reorder=True, max_diags=3,
                             device="cpu")
    with pytest.raises(ValueError, match="max_diags") as e_j:
        j_assemble_divgrad_dia(j_rect(12, 10), reorder=True, max_diags=3)
    assert str(e_t.value) == str(e_j.value)
