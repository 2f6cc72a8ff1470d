"""Sparse formats, orderings, SlicedELL and kernel K1's plain version of
stormx_torch, held against the JAX package on the same inputs.

Tolerances: the formats and matvecs in float64 to 1e-12 (summation order
differs between torch and XLA); orderings and the SlicedELL build fields
bit-identical (pure host NumPy on both sides); K1's plain version within
1e-6·max|y| of the interpret-mode Pallas kernel in float32 (the K-sum order
differs, ``pallas_sell.py:124-129``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.fvm.divgrad import assemble_laplacian as j_assemble_laplacian
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx.mesh.unstructured import build_mesh as j_build_mesh
from stormx.ops.pallas_sell import sell_matvec_pallas
from stormx.parallel.partition import bandwidth_order as j_bandwidth_order
from stormx.parallel.partition import rcm_order as j_rcm_order
from stormx.sparse import formats as jf
from stormx.sparse import windowed as jw
from stormx_torch import interop
from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import build_mesh, structured_tri_rect
from stormx_torch.ops.sell_spmv import sell_spmv_cuda, sell_spmv_plain
from stormx_torch.parallel import partition as tp
from stormx_torch.sparse import formats as tf
from stormx_torch.sparse import windowed as tw


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fields(obj):
    return {f.name: (getattr(obj, f.name) if not hasattr(getattr(obj, f.name), "shape")
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _random_sparse(rng, n, density=0.2):
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return a + np.diag(rng.standard_normal(n) + 5.0)


def _delaunay_mesh(builder, n_points, seed):
    from scipy.spatial import Delaunay

    pts = np.random.default_rng(seed).random((n_points, 2))
    return builder(pts, Delaunay(pts).simplices)


class TestFormats:
    def test_csr_fields_and_matvecs(self, rng):
        a = _random_sparse(rng, 37)
        x = rng.standard_normal(37)
        j = jf.csr_from_dense(a)
        t = tf.csr_from_dense(a)
        for name in ("data", "indices", "row_ptr"):
            np.testing.assert_array_equal(_np(getattr(t, name)), np.asarray(getattr(j, name)))
        np.testing.assert_allclose(_np(t.matvec(torch.as_tensor(x))),
                                   np.asarray(j.matvec(jnp.asarray(x))), atol=1e-12)
        np.testing.assert_allclose(_np(t.diagonal()), np.asarray(j.diagonal()), atol=0)
        np.testing.assert_allclose(_np(t.todense()), a, atol=0)
        np.testing.assert_array_equal(_np(t.row_ids()), np.asarray(j.row_ids()))

    def test_coo_to_csr_sums_duplicates(self, rng):
        rows = rng.integers(0, 20, 200).astype(np.int32)
        cols = rng.integers(0, 20, 200).astype(np.int32)
        data = rng.standard_normal(200)
        jc = jf.COO(jnp.asarray(data), jnp.asarray(rows), jnp.asarray(cols), (20, 20)).to_csr()
        tc = tf.COO(torch.as_tensor(data), torch.as_tensor(rows), torch.as_tensor(cols),
                    (20, 20))
        x = rng.standard_normal(20)
        np.testing.assert_allclose(_np(tc.matvec(torch.as_tensor(x))),
                                   np.asarray(jc.matvec(jnp.asarray(x))), atol=1e-12)
        tc = tc.to_csr()
        np.testing.assert_array_equal(_np(tc.indices), np.asarray(jc.indices))
        np.testing.assert_array_equal(_np(tc.row_ptr), np.asarray(jc.row_ptr))
        np.testing.assert_allclose(_np(tc.data), np.asarray(jc.data), atol=1e-12)

    @pytest.mark.parametrize("device_arrays", [True, False])
    def test_ell_fields_matvec_roundtrip(self, rng, device_arrays):
        a = _random_sparse(rng, 41)
        x = rng.standard_normal(41)
        je = jf.ell_from_csr(jf.csr_from_dense(a))
        te = tf.ell_from_csr(tf.csr_from_dense(a), device=device_arrays)
        np.testing.assert_array_equal(_np(te.cols), np.asarray(je.cols))
        np.testing.assert_array_equal(_np(te.data), np.asarray(je.data))
        if device_arrays:
            np.testing.assert_allclose(_np(te.matvec(torch.as_tensor(x))),
                                       np.asarray(je.matvec(jnp.asarray(x))), atol=1e-12)
            np.testing.assert_array_equal(_np(te.diagonal()), np.asarray(je.diagonal()))
            back = te.to_csr()
            np.testing.assert_array_equal(_np(back.indices), np.asarray(je.to_csr().indices))

    def test_ell_row_width_guard(self, rng):
        with pytest.raises(ValueError):
            tf.ell_from_csr(tf.csr_from_dense(_random_sparse(rng, 10, 0.9)), row_width=2)

    def test_dia_fields_and_matvec(self, rng):
        n = 50
        a = np.zeros((n, n))
        for off in (-7, -1, 0, 2, 9):
            idx = np.arange(max(0, -off), min(n, n - off))
            a[idx, idx + off] = rng.standard_normal(len(idx))
        jd = jf.dia_from_csr(jf.csr_from_dense(a))
        td = tf.dia_from_csr(tf.csr_from_dense(a))
        assert td.offsets == jd.offsets
        np.testing.assert_array_equal(_np(td.data), np.asarray(jd.data))
        x = rng.standard_normal(n)
        np.testing.assert_allclose(_np(td.matvec(torch.as_tensor(x))),
                                   np.asarray(jd.matvec(jnp.asarray(x))), atol=1e-12)
        np.testing.assert_array_equal(_np(td.diagonal()), np.asarray(jd.diagonal()))
        carried = interop.dia_from_fields(_fields(jd), device="cpu")
        assert carried.offsets == td.offsets
        np.testing.assert_array_equal(_np(carried.data), _np(td.data))
        with pytest.raises(ValueError):
            tf.dia_from_csr(tf.csr_from_dense(a), max_diags=3)

    def test_spgemm_and_add(self, rng):
        mesh_j, mesh_t = j_rect(7, 6), structured_tri_rect(7, 6)
        from stormx.fvm.divgrad import assemble_divgrad as j_divgrad
        from stormx_torch.fvm.divgrad import assemble_divgrad as t_divgrad

        Dj, Dt = j_divgrad(mesh_j), t_divgrad(mesh_t)
        np.testing.assert_array_equal(_np(Dt.cols), np.asarray(Dj.cols))
        np.testing.assert_allclose(_np(Dt.data), np.asarray(Dj.data), atol=1e-12)
        Cj, Ct = jf.ell_spgemm(Dj, Dj), tf.ell_spgemm(Dt, Dt)
        np.testing.assert_array_equal(_np(Ct.indices), np.asarray(Cj.indices))
        np.testing.assert_array_equal(_np(Ct.row_ptr), np.asarray(Cj.row_ptr))
        np.testing.assert_allclose(_np(Ct.data), np.asarray(Cj.data), atol=1e-12)
        n = mesh_t.num_cells
        Aj = jf.ell_add([(1.0, None), (-0.3, Dj), (0.7, Cj)], (n, n))
        At = tf.ell_add([(1.0, None), (-0.3, Dt), (0.7, Ct)], (n, n))
        np.testing.assert_array_equal(_np(At.indices), np.asarray(Aj.indices))
        np.testing.assert_allclose(_np(At.data), np.asarray(Aj.data), atol=1e-12)
        x = rng.standard_normal(n)
        np.testing.assert_allclose(_np(At.matvec(torch.as_tensor(x))),
                                   np.asarray(Aj.matvec(jnp.asarray(x))), atol=1e-12)

    def test_interop_carries_operators(self, rng):
        a = _random_sparse(rng, 23)
        j = jf.csr_from_dense(a)
        x = rng.standard_normal(23)
        y = np.asarray(j.matvec(jnp.asarray(x)))
        t_csr = interop.csr_from_fields(_fields(j), device="cpu")
        t_ell = interop.ell_from_fields(_fields(jf.ell_from_csr(j)), device="cpu")
        for op in (t_csr, t_ell):
            np.testing.assert_allclose(_np(op.matvec(torch.as_tensor(x))), y, atol=1e-12)

    @pytest.mark.parametrize("kind", ["csr", "ell", "dia", "sell", "packed"])
    def test_interop_defaults_to_the_card(self, kind, monkeypatch):
        """Without ``device`` each ``*_from_fields`` puts its tensors on the
        card, as the port's other entry points do: with no card that raises
        and says how to ask for the CPU."""
        from stormx.ops import pallas_sell2 as jp
        from stormx_torch.core.exceptions import StormError

        n = 300
        a = np.diag(np.full(n, 4.0)) - np.diag(np.ones(n - 1), 1) - np.diag(np.ones(n - 1), -1)
        j = jf.csr_from_dense(a.astype(np.float32))
        sj, _ = jw.sell_from_csr(j, block_rows=128, mode="onehot", reorder=False)
        fields = _fields({"csr": j, "ell": jf.ell_from_csr(j), "dia": jf.dia_from_csr(j),
                          "sell": sj, "packed": jp.pack_sell(sj, "gather")}[kind])
        convert = getattr(interop, f"{kind}_from_fields")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(StormError, match="device='cpu'"):
            convert(fields)
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        op = convert(fields, device="cpu")
        np.testing.assert_allclose(_np(op.matvec(torch.as_tensor(x))), a @ x, rtol=1e-5,
                                   atol=1e-5)


def _adjacency(mesh):
    interior = mesh.interior_faces()
    inner, outer = mesh.face_cells[interior, 0], mesh.face_cells[interior, 1]
    return np.concatenate([inner, outer]), np.concatenate([outer, inner])


class TestOrderings:
    @pytest.mark.parametrize("kind", ["rect", "delaunay"])
    def test_rcm_and_bandwidth_order_bit_identical(self, kind):
        mesh = j_rect(13, 9) if kind == "rect" else _delaunay_mesh(j_build_mesh, 700, 3)
        rows, cols = _adjacency(mesh)
        n = mesh.num_cells
        np.testing.assert_array_equal(tp.rcm_order(n, rows, cols), j_rcm_order(n, rows, cols))
        for coords in (None, mesh.cell_centers):
            np.testing.assert_array_equal(
                tp.bandwidth_order(n, rows, cols, coords),
                j_bandwidth_order(n, rows, cols, coords),
            )

    def test_numpy_fallback_equals_native(self):
        mesh = _delaunay_mesh(j_build_mesh, 500, 5)
        rows, cols = _adjacency(mesh)
        n = mesh.num_cells
        ptr, c, deg = tp._csr_adjacency(n, rows, cols)
        np.testing.assert_array_equal(tp._rcm_python(n, ptr, c, deg), tp.rcm_order(n, rows, cols))


def _laplacians(mesh_kind, dtype=np.float64):
    if mesh_kind == "rect":
        mj, mt = j_rect(20, 16), structured_tri_rect(20, 16)
    else:
        mj = _delaunay_mesh(j_build_mesh, 900, 7)
        mt = _delaunay_mesh(build_mesh, 900, 7)
    cj = j_assemble_laplacian(mj).to_csr()
    ct = assemble_laplacian(mt).to_csr()
    cj = jf.CSR(jnp.asarray(np.asarray(cj.data, dtype=dtype)), cj.indices, cj.row_ptr, cj.shape)
    ct = tf.CSR(torch.as_tensor(_np(ct.data).astype(dtype)), ct.indices, ct.row_ptr, ct.shape)
    return mj, mt, cj, ct


class TestSlicedELL:
    @pytest.mark.parametrize("mode,block_rows", [("dense", 128), ("onehot", 128),
                                                 ("dense", 256), ("onehot", 64)])
    def test_build_fields_identical(self, mode, block_rows):
        mj, mt, cj, ct = _laplacians("delaunay")
        sj, pj = jw.sell_from_csr(cj, mode=mode, block_rows=block_rows, coords=mj.cell_centers)
        st, pt = tw.sell_from_csr(ct, mode=mode, block_rows=block_rows, coords=mt.cell_centers)
        np.testing.assert_array_equal(pt, pj)
        assert (st.window, st.pad_lo, st.shape, st.block_rows) == (
            sj.window, sj.pad_lo, sj.shape, sj.block_rows)
        np.testing.assert_array_equal(_np(st.data).transpose(0, 2, 1), np.asarray(sj.data))
        np.testing.assert_array_equal(_np(st.local_cols).transpose(0, 2, 1),
                                      np.asarray(sj.local_cols))
        if mode == "dense":
            np.testing.assert_array_equal(_np(st.dense_blocks), np.asarray(sj.dense_blocks))
        x = np.random.default_rng(2).standard_normal(ct.shape[0])
        np.testing.assert_allclose(_np(st.matvec(torch.as_tensor(x))),
                                   np.asarray(sj.matvec(jnp.asarray(x))), atol=1e-12)
        carried = interop.sell_from_fields(_fields(sj), device="cpu")
        np.testing.assert_array_equal(_np(carried.data), _np(st.data))
        np.testing.assert_array_equal(_np(carried.local_cols), _np(st.local_cols))

    @pytest.mark.parametrize("mode", ["dense", "onehot", "cuda"])
    def test_sell_from_ell_identical(self, mode):
        _, _, cj, ct = _laplacians("rect", np.float32)
        sj = jw.sell_from_ell(jf.ell_from_csr(cj), block_rows=128,
                              mode="pallas" if mode == "cuda" else mode)
        st = tw.sell_from_ell(tf.ell_from_csr(ct), block_rows=128, mode=mode)
        assert (st.window, st.pad_lo, st.mode) == (sj.window, sj.pad_lo, mode)
        np.testing.assert_array_equal(_np(st.data).transpose(0, 2, 1), np.asarray(sj.data))
        np.testing.assert_array_equal(_np(st.local_cols).transpose(0, 2, 1),
                                      np.asarray(sj.local_cols))
        x = np.random.default_rng(3).standard_normal(ct.shape[0]).astype(np.float32)
        y = np.asarray(jf.ell_from_csr(cj).matvec(jnp.asarray(x)))
        assert np.abs(_np(st.matvec(torch.as_tensor(x))) - y).max() <= 1e-6 * np.abs(y).max()

    @pytest.mark.parametrize("kind,max_diags", [("rect", 64), ("delaunay", 64), ("rect", 1)])
    def test_auto_operator_same_choice(self, kind, max_diags):
        mj, mt, cj, ct = _laplacians(kind)
        oj, pj = jw.auto_operator(cj, coords=mj.cell_centers, max_diags=max_diags)
        ot, pt = tw.auto_operator(ct, coords=mt.cell_centers, max_diags=max_diags, device="cpu")
        assert type(ot).__name__ == type(oj).__name__
        np.testing.assert_array_equal(pt, pj)
        if isinstance(ot, tw.SlicedELL):
            assert ot.mode == oj.mode == "dense"  # the kernel mode needs CUDA
        x = np.random.default_rng(4).standard_normal(ct.shape[0])
        np.testing.assert_allclose(_np(ot.matvec(torch.as_tensor(x))),
                                   np.asarray(oj.matvec(jnp.asarray(x))), atol=1e-12)

    def test_kernel_mode_is_keyed_on_the_device(self):
        _, mt, _, ct = _laplacians("delaunay", np.float32)
        op, _ = tw.auto_operator(ct, coords=mt.cell_centers, device="cpu")
        assert op.mode == "dense"
        op, _ = tw.auto_operator(ct, coords=mt.cell_centers, device="cpu", mode="cuda")
        assert op.mode == "cuda" and op.block_rows == tw.KERNEL_BLOCK_ROWS

    def test_wide_band_falls_back_to_ell(self, rng):
        n = 600
        a = _random_sparse(rng, n, density=0.01)
        op, _ = tw.auto_operator(tf.csr_from_dense(a), reorder=False, max_diags=4,
                                 device="cpu")
        assert isinstance(op, tf.ELL)

    def test_auto_operator_defaults_to_the_card(self, monkeypatch):
        """Without ``device`` the operator goes to the card, whatever the CSR's
        device: with no card that raises and says how to ask for the CPU."""
        from stormx_torch.core.exceptions import StormError

        _, mt, _, ct = _laplacians("delaunay", np.float32)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(StormError, match="device='cpu'"):
            tw.auto_operator(ct, coords=mt.cell_centers)
        op, _ = tw.auto_operator(ct, coords=mt.cell_centers, device="cpu")
        assert op.data.device.type == "cpu"


class TestSellKernelPlainVersion:
    @pytest.mark.parametrize("block_rows", [128, 256])
    def test_plain_matches_interpret_pallas_and_ell(self, block_rows):
        mj, mt, cj, ct = _laplacians("delaunay", np.float32)
        sj, perm = jw.sell_from_csr(cj, mode="pallas", block_rows=block_rows)
        st, perm_t = tw.sell_from_csr(ct, mode="cuda", block_rows=block_rows)
        np.testing.assert_array_equal(perm_t, perm)
        x = np.random.default_rng(0).standard_normal(ct.shape[0]).astype(np.float32)
        xp = x[perm]
        y_pal = np.asarray(sell_matvec_pallas(sj, jnp.asarray(xp), interpret=True))
        y_t = _np(sell_spmv_plain(st, torch.as_tensor(xp)))
        assert np.abs(y_t - y_pal).max() <= 1e-6 * np.abs(y_pal).max()
        # dispatch: a CPU tensor takes the plain version through matvec
        np.testing.assert_array_equal(_np(st.matvec(torch.as_tensor(xp))), y_t)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        y_ell = np.asarray(jf.ell_from_csr(cj).matvec(jnp.asarray(x)))
        assert np.abs(y_t[inv] - y_ell).max() <= 1e-5 * np.abs(y_ell).max()

    def test_onehot_mode_equals_jax_onehot(self):
        mj, mt, cj, ct = _laplacians("rect")
        sj, perm = jw.sell_from_csr(cj, mode="onehot", block_rows=64)
        st, _ = tw.sell_from_csr(ct, mode="onehot", block_rows=64)
        x = np.random.default_rng(1).standard_normal(ct.shape[0])
        np.testing.assert_allclose(_np(st.matvec(torch.as_tensor(x))),
                                   np.asarray(sj.matvec(jnp.asarray(x))), atol=1e-12)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        _, _, _, ct = _laplacians("rect", np.float32)
        st, _ = tw.sell_from_csr(ct, mode="cuda")
        with pytest.raises(ValueError):
            sell_spmv_cuda(st, torch.zeros(ct.shape[0]))
