"""The port's triangular solve (``stormx_torch.precond.tri_solve``) against
the JAX package's, in float64 on the CPU, on the factors of IC(0), ILU(0),
SGS and IQR built on a ``structured_tri_rect`` mesh and a twice-``refine``d
one; and the host arrays that T1, its exact-solve kernel, reads.

* Both modes of the plain slot-order solve equal the JAX ``tri_solve``
  within 1e-12 relative (max norm): the two add each row's slots in other
  orders (torch one slot at a time, XLA its own ``sum``), so they agree to
  roundoff, not bit for bit.  The factors' JAX arrays are bit-equal.
* ``order`` lists the rows level by level, ascending within a level, and
  puts every real dependency of a row before it; ``row_len`` counts each
  row's real entries.  A hypothesis test holds both on random triangular
  patterns, and the port's NumPy build bit-equal to the JAX package's row
  loop there.
* A model of T1's schedule (warp w takes positions w, w + W, ... of
  ``order``, and a row waits for its real dependencies) finishes every
  pattern at every W, and its arithmetic (real slots only, in slot order)
  gives the plain exact solve's bits.  The kernel itself is held to the
  plain version on the card (``tests/test_torch_kernels.py``).
* Every rank's RAS factors carry ``order`` and ``row_len`` beside the
  arrays of the JAX package's stacked factors.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import stormx.parallel as jpar
from stormx import precond as jp
from stormx.sparse import formats as jf
from stormx_torch import parallel as tpar
from stormx_torch import precond as tp
from stormx_torch.fvm.convdiff import assemble_convection_diffusion
from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import refine, structured_tri_rect
from stormx_torch.ops import tri_solve as tk
from stormx_torch.parallel.ras import _rank_factors
from stormx_torch.sparse import formats as tf

CPU = dict(device="cpu")
TAU = 1e-2  # V + τ·L, the implicit diffusion step of chip_smoke.py's phase 20
MESHES = {"rect": lambda: structured_tri_rect(9, 7),
          "refined": lambda: refine(structured_tri_rect(4, 3), times=2)}


def _host(csr):
    return (tf.host(csr.row_ptr).astype(np.int64), tf.host(csr.indices).astype(np.int64),
            tf.host(csr.data).astype(np.float64))


def _diffusion(mesh):
    rp, cols, vals = _host(assemble_laplacian(mesh).to_csr())
    rows = np.repeat(np.arange(mesh.num_cells), np.diff(rp))
    return rp, cols, TAU * vals + np.where(cols == rows, mesh.cell_volumes[rows], 0.0)


def _convdiff(mesh):
    return _host(assemble_convection_diffusion(
        mesh, lambda r: np.stack([-(r[:, 1] - 0.5), r[:, 0] - 0.5], axis=1), 0.05).to_csr())


def _face_difference(mesh):
    """Rows x[outer] − x[inner] of interior faces, x[inner] of boundary ones."""
    fc = mesh.face_cells
    inner, outer = fc[:, 0].astype(np.int64), fc[:, 1].astype(np.int64)
    interior = outer >= 0
    m = len(fc)
    rows = np.concatenate([np.arange(m), np.nonzero(interior)[0]])
    cols = np.concatenate([inner, outer[interior]])
    vals = np.concatenate([np.where(interior, -1.0, 1.0), np.ones(int(interior.sum()))])
    order = np.lexsort((cols, rows))
    rp = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return (np.cumsum(rp), cols[order], vals[order]), (m, mesh.num_cells)


def _csr_pair(triples, shape):
    rp, cols, vals = triples
    t = tf.CSR(data=torch.as_tensor(vals), indices=torch.as_tensor(cols.astype(np.int32)),
               row_ptr=torch.as_tensor(rp.astype(np.int32)), shape=shape)
    j = jf.CSR(data=jnp.asarray(vals), indices=jnp.asarray(cols.astype(np.int32)),
               row_ptr=jnp.asarray(rp.astype(np.int32)), shape=shape)
    return t, j


@functools.lru_cache(maxsize=None)
def _factors(mesh_name, kind):
    """{"lower": (port factor, JAX factor), "upper": (...)} of one
    preconditioner's two triangular factors."""
    mesh = MESHES[mesh_name]()
    n = mesh.num_cells
    if kind == "iqr":
        t, j = _csr_pair(*_face_difference(mesh))
        tpre, jpre = tp.IqrPreconditioner(t, **CPU), jp.IqrPreconditioner(j)
        return {"lower": (tpre._rt, jpre._rt), "upper": (tpre._r, jpre._r)}
    build = _convdiff if kind == "ilu0" else _diffusion
    t, j = _csr_pair(build(mesh), (n, n))
    cls = {"ic0": "IcPreconditioner", "ilu0": "IluPreconditioner", "sgs": "SgsPreconditioner"}
    tpre, jpre = getattr(tp, cls[kind])(t, **CPU), getattr(jp, cls[kind])(j)
    return {"lower": (tpre._first, jpre._first), "upper": (tpre._second, jpre._second)}


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _positions(tri):
    pos = np.empty(tri.num_rows, dtype=np.int64)
    pos[tri.order.numpy()] = np.arange(tri.num_rows)
    return pos


def _check_schedule(tri):
    """``order`` is the levels concatenated and puts every real dependency
    first; ``row_len`` marks the real slots."""
    n = tri.num_rows
    lr = tri.level_rows.numpy()
    assert tri.order.dtype == torch.int32 and tri.row_len.dtype == torch.int32
    assert tri.ell_cols.dtype == torch.int32
    np.testing.assert_array_equal(tri.order.numpy(), lr[lr < n])
    pos = _positions(tri)
    cols, vals, row_len = tri.ell_cols.numpy()[:n], tri.ell_vals.numpy()[:n], tri.row_len.numpy()
    real = np.arange(cols.shape[1])[None, :] < row_len[:, None]
    assert np.all(pos[cols[real]] < np.repeat(pos, row_len))
    assert np.all(vals[~real] == 0) and np.all(cols[~real] == 0)


def _t1_model(tri, r, warps):
    """T1's schedule and arithmetic in Python: in each round every warp
    whose current row has its real dependencies done computes it (real
    slots only, in slot order) and moves W positions on.  Fails if a round
    makes no progress."""
    n = tri.num_rows
    order, row_len = tri.order.tolist(), tri.row_len.tolist()
    cols, vals, inv = tri.ell_cols, tri.ell_vals, tri.inv_diag
    y = torch.zeros(n + 1, dtype=r.dtype)
    done = [False] * n
    nxt = list(range(min(warps, n)))
    while nxt:
        progressed, keep = False, []
        for p in nxt:
            row = order[p]
            deps = cols[row, : row_len[row]].tolist()
            if all(done[c] for c in deps):
                acc = torch.zeros((), dtype=r.dtype)
                for k in range(row_len[row]):
                    acc = acc + vals[row, k] * y[cols[row, k]]
                y[row] = (r[row] - acc) * inv[row]
                done[row], progressed = True, True
                p += warps
            if p < n:
                keep.append(p)
        assert progressed, "T1's schedule stalled"
        nxt = keep
    return y[:n]


FACTORS = [(m, k, side) for m in MESHES for k in ("ic0", "ilu0", "sgs", "iqr")
           for side in ("lower", "upper")]


@pytest.mark.parametrize("sweeps", [None, 3], ids=["exact", "sweeps3"])
@pytest.mark.parametrize("mesh_name,kind,side", FACTORS)
def test_slot_order_solve_matches_jax(mesh_name, kind, side, sweeps):
    t, j = _factors(mesh_name, kind)[side]
    for got, want in zip(t, j):  # the JAX factor's four arrays
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r = np.random.default_rng(4).standard_normal(t.num_rows)
    got = tp.tri_solve(t, torch.as_tensor(r), sweeps=sweeps)
    _close(got, jp.tri_solve(j, jnp.asarray(r), sweeps=sweeps), 1e-12)
    assert got.dtype == torch.float64 and got.shape == (t.num_rows,)


@pytest.mark.parametrize("mesh_name,kind,side", FACTORS)
def test_order_row_len_and_t1_model(mesh_name, kind, side):
    t, _ = _factors(mesh_name, kind)[side]
    _check_schedule(t)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(t.num_rows))
    want = tk.exact_plain(t, r)
    for warps in (1, 7, 64):
        assert torch.equal(_t1_model(t, r, warps), want)


def test_sweep_plain_is_the_sweep_formula():
    """``sweep_plain`` is y ← D⁻¹(r − N·y) from y0 = D⁻¹r, and as many sweeps
    as levels give the exact solve."""
    t, _ = _factors("rect", "ic0")["lower"]
    n = t.num_rows
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(n))
    dense_n = torch.zeros(n, n + 1, dtype=torch.float64)
    dense_n.scatter_add_(1, t.ell_cols[:n].long(), t.ell_vals[:n])
    y = t.inv_diag[:n] * r
    for _ in range(2):
        y = t.inv_diag[:n] * (r - dense_n[:, :n] @ y)
    _close(tk.sweep_plain(t, r, 2), y, 1e-14)
    _close(tk.sweep_plain(t, r, t.num_levels), tk.exact_plain(t, r), 1e-12)


@st.composite
def _triangles(draw):
    n = draw(st.integers(1, 40))
    lower = draw(st.booleans())
    seed = draw(st.integers(0, 2**31 - 1))
    density = draw(st.sampled_from([0.05, 0.2, 0.6]))
    unit = draw(st.booleans())
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    a = np.tril(a, -1) if lower else np.triu(a, 1)
    np.fill_diagonal(a, 0.0 if unit else 2.0 + rng.random(n))
    return a, lower, unit


@settings(max_examples=60, deadline=None, database=None)
@given(_triangles())
def test_schedule_on_random_triangles(case):
    a, lower, unit = case
    n = a.shape[0]
    rows, cols = np.nonzero(a)
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    args = (np.cumsum(rp), cols, a[rows, cols], n)
    tri = tp.build_triangular(*args, lower=lower, unit_diagonal=unit, **CPU)
    for got, want in zip(tri, jp.build_triangular(*args, lower=lower, unit_diagonal=unit)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_schedule(tri)
    np.testing.assert_array_equal(tri.row_len.numpy(), np.count_nonzero(a - np.diag(np.diag(a)),
                                                                        axis=1))
    r = torch.as_tensor(np.random.default_rng(n).standard_normal(n))
    want = tk.exact_plain(tri, r)
    for warps in (1, 5):
        assert torch.equal(_t1_model(tri, r, warps), want)
    dense = a + np.eye(n) if unit else a
    np.testing.assert_allclose(dense @ want.numpy(), r.numpy(), atol=1e-8 * (1 + np.abs(
        want.numpy()).max() * np.abs(dense).max()))


@pytest.mark.parametrize("kind", ["ilu0", "sgs"])
@pytest.mark.parametrize("parts", [1, 3])
def test_ras_rank_factors_carry_t1_arrays(kind, parts):
    mesh = MESHES["rect"]()
    n = mesh.num_cells
    t, j = _csr_pair(_diffusion(mesh), (n, n))
    pop = tpar.partition_csr(t, parts, **CPU)
    stacked = jpar.build_ras_factors(jpar.partition_csr(j, parts), kind=kind)
    for rank in range(parts):
        f1, f2, mid = _rank_factors(pop, kind, rank, dtype=torch.float64,
                                    device=torch.device("cpu"))
        for f, s in ((f1, "1"), (f2, "2")):
            _check_schedule(f)
            lv, k = f.level_rows.shape, f.ell_cols.shape[1]
            lr, ec = np.asarray(stacked["ras_lr" + s][rank]), np.asarray(stacked["ras_ec" + s][rank])
            np.testing.assert_array_equal(f.level_rows.numpy(), lr[: lv[0], : lv[1]])
            np.testing.assert_array_equal(f.ell_cols.numpy(), ec[:, :k])
            np.testing.assert_array_equal(f.ell_vals.numpy(),
                                          np.asarray(stacked["ras_ev" + s][rank])[:, :k])
            np.testing.assert_array_equal(f.inv_diag.numpy(),
                                          np.asarray(stacked["ras_id" + s][rank]))
        np.testing.assert_array_equal(mid.numpy(), np.asarray(stacked["ras_mid"][rank]))
        r = torch.as_tensor(np.random.default_rng(rank).standard_normal(pop.n_pad))
        assert torch.equal(_t1_model(f1, r, 8), tk.exact_plain(f1, r))
