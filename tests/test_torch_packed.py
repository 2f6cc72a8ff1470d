"""K4 (the chunk-packed SlicedELL SpMV) of stormx_torch against the JAX
package on the CPU, where the port takes the plain versions.

The JAX side runs ``PackedSELL.matvec`` in Pallas interpret mode, as
``tests/test_pallas_sell2.py`` does.  Tolerances:
* the packer: idx, vals and src bit-equal (the port keeps a copy of the
  JAX package's NumPy packer), and ``rows_used`` equal to a NumPy count over
  the JAX packer's values;
* the plain K4a and K4b: within 1e-6·max|y| of the interpret-mode kernels
  and of the ELL oracle in float32 (the three sum in other orders); the
  plain K4a reads only the live slots below ``rows_used``, as its kernel
  does, and with finite x equals the sum over every slot;
* CG + Jacobi through the packed operator in float32 on 960 cells: iteration
  counts within 1 of the JAX package's CG through its packed operator, and
  solutions within 1e-4 relative (measured: 147 iterations on both sides,
  solutions 3.6e-7 apart, in either variant).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.fvm.divgrad import assemble_laplacian as j_assemble_laplacian
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx.ops import pallas_sell2 as jp
from stormx.precond import JacobiPreconditioner as JJacobi
from stormx.solvers import SolverOptions as JOptions
from stormx.solvers import cg as j_cg
from stormx.solvers import make_operator as j_make_operator
from stormx.sparse import formats as jf
from stormx.sparse import windowed as jw
from stormx_torch import interop
from stormx_torch.ops import sell_packed as tp
from stormx_torch.precond import JacobiPreconditioner
from stormx_torch.solvers import SolverOptions, cg, make_operator
from stormx_torch.sparse import windowed as tw


def _banded_csr(n=1000, band=40, seed=0):
    """``tests/test_pallas_sell2.py``'s random banded matrix, as JAX CSR."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        nnz = rng.integers(2, 8)
        c = np.unique(np.clip(i + rng.integers(-band, band + 1, nnz), 0, n - 1))
        rows += [i] * len(c)
        cols += list(c)
        vals += list(rng.standard_normal(len(c)))
    rows, cols, vals = map(np.asarray, (rows, cols, vals))
    rp = np.zeros(n + 1, np.int32)
    np.add.at(rp, rows + 1, 1)
    return jf.CSR(data=jnp.asarray(vals.astype(np.float32)),
                  indices=jnp.asarray(cols.astype(np.int32)),
                  row_ptr=jnp.asarray(np.cumsum(rp).astype(np.int32)), shape=(n, n))


def _rect_laplacian_csr():
    """The float32 two-point-flux Laplacian of a 24×20 structured triangle
    mesh (960 cells), as JAX CSR."""
    c = j_assemble_laplacian(j_rect(24, 20)).to_csr()
    return jf.CSR(data=c.data.astype(jnp.float32), indices=c.indices, row_ptr=c.row_ptr,
                  shape=c.shape)


MATRICES = {"banded": _banded_csr, "rect_laplacian": _rect_laplacian_csr}


def _fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name)) if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _sells(cj, block_rows):
    """The JAX and the port SlicedELL of one CSR, not reordered."""
    sj, _ = jw.sell_from_csr(cj, block_rows=block_rows, mode="onehot", reorder=False)
    ct = interop.csr_from_fields(_fields(cj))
    st, _ = tw.sell_from_csr(ct, block_rows=block_rows, mode="cuda", reorder=False)
    return sj, st


@pytest.mark.parametrize("block_rows", [128, 256, 512])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_packer_bit_equal_to_jax(matrix, block_rows):
    sj, st = _sells(MATRICES[matrix](), block_rows)
    pj, pt = jp.pack_sell(sj, "gather"), tp.pack_sell(st, "gather")
    for name in ("idx", "vals", "src"):
        got, want = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    meta = ("shape", "window", "pad_lo", "block_rows", "ell_k", "variant")
    assert tuple(getattr(pt, f) for f in meta) == tuple(getattr(pj, f) for f in meta)
    assert pt.sub == pj.sub


def _rows_used_np(vals):
    """1 + the last tile row of each block with a non-zero value, counted in
    NumPy."""
    live = np.asarray(vals).reshape(vals.shape[0], vals.shape[1], -1) != 0
    out = np.zeros(vals.shape[0], dtype=np.int32)
    for b in range(vals.shape[0]):
        rows = np.nonzero(live[b].any(axis=1))[0]
        out[b] = rows[-1] + 1 if rows.size else 0
    return out


@pytest.mark.parametrize("block_rows", [128, 256, 512])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_rows_used_counts_the_jax_packers_rows(matrix, block_rows):
    sj, st = _sells(MATRICES[matrix](), block_rows)
    want = _rows_used_np(jp.pack_sell(sj, "matmul").vals)
    pt = tp.pack_sell(st, "matmul")
    assert pt.rows_used.dtype == torch.int32 and pt.rows_used.device == pt.vals.device
    np.testing.assert_array_equal(pt.rows_used.numpy(), want)
    assert (want >= 1).all() and (want <= pt.vals.shape[1]).all()


@pytest.mark.parametrize("variant", tp.VARIANTS)
@pytest.mark.parametrize("block_rows", [128, 256, 512])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_plain_matches_interpret_pallas_and_ell(matrix, block_rows, variant):
    cj = MATRICES[matrix]()
    sj, st = _sells(cj, block_rows)
    pj, pt = jp.pack_sell(sj, variant), tp.pack_sell(st, variant)
    x = np.random.default_rng(3).standard_normal(cj.shape[0]).astype(np.float32)
    y_j = np.asarray(pj.matvec(jnp.asarray(x), interpret=True))
    y_t = tp.packed_spmv_plain(pt, torch.as_tensor(x)).numpy()
    y_ell = np.asarray(jf.ell_from_csr(cj).matvec(jnp.asarray(x)))
    assert y_t.dtype == np.float32 and y_t.shape == y_j.shape
    assert np.abs(y_t - y_j).max() <= 1e-6 * np.abs(y_j).max()
    assert np.abs(y_t - y_ell).max() <= 1e-6 * np.abs(y_ell).max()
    # matvec on CPU tensors takes the plain version, through the Function
    np.testing.assert_array_equal(pt.matvec(torch.as_tensor(x)).numpy(), y_t)
    np.testing.assert_array_equal((pt @ torch.as_tensor(x)).numpy(), y_t)
    assert tp.launches == {"matmul": 0, "gather": 0}


def test_one_packing_feeds_both_packages():
    sj, _ = _sells(_banded_csr(n=700, seed=2), 256)
    for variant in tp.VARIANTS:
        pj = jp.pack_sell(sj, variant)
        pt = interop.packed_from_fields(_fields(pj))
        assert pt.variant == variant and pt.shape == pj.shape
        np.testing.assert_array_equal(pt.rows_used.numpy(), _rows_used_np(pj.vals))
        x = np.random.default_rng(4).standard_normal(700).astype(np.float32)
        y_j = np.asarray(pj.matvec(jnp.asarray(x), interpret=True))
        y_t = pt.matvec(torch.as_tensor(x)).numpy()
        assert np.abs(y_t - y_j).max() <= 1e-6 * np.abs(y_j).max()


@pytest.mark.parametrize("block_rows", [128, 512])
def test_plain_k4a_skips_only_what_changes_nothing(block_rows):
    """On the 960-cell Laplacian every block ends in whole zero tile rows
    (``rows_used`` < M); with finite x the plain K4a, which skips them and
    every zero-valued slot, equals the sum over every slot exactly."""
    _, st = _sells(_rect_laplacian_csr(), block_rows)
    pt = tp.pack_sell(st, "matmul")
    M = pt.vals.shape[1]
    used = pt.rows_used.long()
    assert (used < M).all()
    assert not bool((pt.vals != 0)[torch.arange(M)[None, :] >= used[:, None]].any())
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(pt.shape[1]).astype(np.float32))
    y_live = tp.packed_spmv_plain(pt, x)
    nb = pt.vals.shape[0]
    x_pad = torch.nn.functional.pad(x, (pt.pad_lo, nb * pt.block_rows + pt.window - pt.pad_lo
                                        - x.shape[0]))
    idx = pt.idx.long()
    base = (torch.arange(nb) * pt.block_rows)[:, None, None]
    prod = pt.vals * x_pad[base + (((idx >> 7) & 31) << 7) + (idx & 127)]
    owner = idx >> 12
    y_every = torch.stack([torch.where(owner == s, prod, 0.0).sum(dim=1)
                           for s in range(pt.sub)], dim=1).reshape(-1)[: pt.shape[0]]
    assert torch.equal(y_live, y_every)


def test_supports_and_pack_refuse_like_jax():
    cj = _banded_csr()
    sj, st = _sells(cj, 128)
    assert tp.supports_packed(st) == jp.supports_pallas2(sj) is True
    # float64 data
    bad_j = dataclasses.replace(sj, data=sj.data.astype(jnp.float64))
    bad_t = dataclasses.replace(st, data=st.data.double())
    assert tp.supports_packed(bad_t) == jp.supports_pallas2(bad_j) is False
    with pytest.raises(ValueError, match="f32"):
        jp.pack_sell(bad_j)
    with pytest.raises(ValueError, match="f32"):
        tp.pack_sell(bad_t)
    # a block height that is not a multiple of 128, and one over 2048
    for block_rows in (64, 4096):
        sj2, st2 = _sells(_banded_csr(n=8200, band=8), block_rows)
        assert tp.supports_packed(st2) == jp.supports_pallas2(sj2) is False
        with pytest.raises(ValueError, match="block_rows"):
            tp.pack_sell(st2)
    # a window over 4096
    sj3, st3 = _sells(_banded_csr(n=12000, band=3000, seed=1), 128)
    assert st3.window == sj3.window > 4096
    assert tp.supports_packed(st3) == jp.supports_pallas2(sj3) is False
    # an unknown variant
    with pytest.raises(ValueError, match="variant"):
        jp.pack_sell(sj, "onehot")
    with pytest.raises(ValueError, match="variant"):
        tp.pack_sell(st, "onehot")


def test_pack_keeps_the_sells_device_and_kernel_refuses_cpu():
    _, st = _sells(_banded_csr(n=300), 128)
    pt = tp.pack_sell(st)
    assert pt.idx.device == pt.vals.device == pt.src.device == st.data.device
    with pytest.raises(ValueError, match="CUDA"):
        tp.packed_spmv_cuda(pt, torch.zeros(300))


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_jvp_is_the_spmv_of_the_tangent_and_backward_raises(variant):
    _, st = _sells(_banded_csr(n=500, seed=3), 256)
    pt = tp.pack_sell(st, variant)
    rng = np.random.default_rng(5)
    x, t = (torch.as_tensor(rng.standard_normal(500).astype(np.float32)) for _ in range(2))
    y, dy = torch.func.jvp(pt.matvec, (x,), (t,))
    np.testing.assert_array_equal(y.numpy(), pt.matvec(x).numpy())
    np.testing.assert_array_equal(dy.numpy(), pt.matvec(t).numpy())
    # through a nonlinear operator, as Newton's default Jacobian takes it
    _, dz = torch.func.jvp(lambda u: 0.01 * pt.matvec(u) + torch.atan(u), (x,), (t,))
    np.testing.assert_allclose(dz.numpy(), (0.01 * pt.matvec(t) + t / (1 + x * x)).numpy(),
                               rtol=1e-6, atol=1e-7)
    xr = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="transpose"):
        pt.matvec(xr).sum().backward()


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_cg_through_packed_operator_matches_jax(variant):
    cj = _rect_laplacian_csr()
    sj, st = _sells(cj, 128)
    pj, pt = jp.pack_sell(sj, variant), tp.pack_sell(st, variant)
    n = cj.shape[0]
    rhs = np.random.default_rng(6).standard_normal(n)
    rhs = (rhs - rhs.mean()).astype(np.float32)
    diag = np.asarray(jf.ell_from_csr(cj).diagonal())
    opts = dict(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-5)
    res_j = jax.jit(lambda b: j_cg(
        j_make_operator(lambda x: pj.matvec(x, interpret=True)), b, jnp.zeros_like(b),
        precond=JJacobi(diag=jnp.asarray(diag)), options=JOptions(**opts)))(jnp.asarray(rhs))
    res_t = cg(make_operator(pt.matvec), torch.as_tensor(rhs), torch.zeros(n),
               precond=JacobiPreconditioner(diag=torch.as_tensor(diag)),
               options=SolverOptions(**opts))
    assert res_t.converged and bool(res_j.converged)
    assert abs(res_t.num_iterations - int(res_j.num_iterations)) <= 1
    x_j = np.asarray(res_j.x)
    assert np.linalg.norm(res_t.x.numpy() - x_j) <= 1e-4 * np.linalg.norm(x_j)
