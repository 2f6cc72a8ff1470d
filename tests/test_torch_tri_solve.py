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
* T1's strands (``precond.triangular.strands``) hold every row once, in
  increasing levels, as many as the widest level has rows.  A model of the
  kernel's schedule (a warp a strand, lane j holding its rows j, j + 32,
  ..., S slots at once; a lane sees a flag one round after it is written;
  the strand's rows solved in turn from its head, a row's link read from
  the warp in the same round) finishes every pattern, also on round-robin
  strands (the card's room below the factor's strands) and at other lanes
  a strand, and its arithmetic (real slots only, in slot order) gives the
  plain exact solve's bits, in float64 and in float32 (the cells' dtype;
  ``astype`` keeps the arrays T1 reads), also on long chains and on
  narrow levels of few slots.
  ``grid_slots`` decides fixed K.  The kernel itself is held to the plain
  version on the card (``tests/test_torch_kernels.py``).
* Every rank's RAS factors carry ``order``, ``row_len`` and the strands
  beside the arrays of the JAX package's stacked factors.
"""

import functools
import itertools

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


def _t1_model(tri, r, G=32, S=2, strands=None):
    """T1's schedule and arithmetic in Python: for every strand (the
    factor's, or ``strands`` as (rows, ptr)) a group of G lanes, lane j
    holding the strand's rows j, j + G, ... in turn, S slots at once.  In
    each round a lane sees the flags written before the round; a lane whose
    row has more than S slots adds a whole pass before its last once its
    flags are seen; then the group solves its strand's rows from its head,
    in turn, while the head's last pass has seen every flag but the one of
    its link (the strand's row before, read from the group in that round).
    Fails if a round makes no progress."""
    n = tri.num_rows
    rows, ptr = strands or (tri.strand_rows, tri.strand_ptr)
    rows, ptr, row_len = rows.tolist(), ptr.tolist(), tri.row_len.tolist()
    cols, vals, inv = tri.ell_cols.tolist(), tri.ell_vals, tri.inv_diag
    y = torch.zeros(n + 1, dtype=r.dtype)
    done = [False] * n
    zero = torch.zeros((), dtype=r.dtype)
    # Per strand: its head and carry; per lane (strand, j): its place in
    # strand_rows, the first slot of its pass and its sum so far.
    heads = {s: [ptr[s], zero] for s in range(len(ptr) - 1) if ptr[s] < ptr[s + 1]}
    lanes = {(s, j): [ptr[s] + j, 0, zero] for s in heads for j in range(G)}

    def link_of(q, s):
        row = rows[q]
        if q == ptr[s] or row_len[row] > S:
            return None
        return rows[q - 1] if rows[q - 1] in cols[row][: row_len[row]] else None

    while heads:
        seen, progressed = list(done), False
        for (s, j), lane in lanes.items():
            q, base, acc = lane
            if q >= ptr[s + 1] or base + S >= row_len[rows[q]]:
                continue
            row = rows[q]
            if all(seen[cols[row][k]] for k in range(base, base + S)):
                for k in range(base, base + S):
                    acc = acc + vals[row, k] * y[cols[row][k]]
                lane[1], lane[2], progressed = base + S, acc, True
        for s in list(heads):
            for _ in range(G):
                head, carry = heads[s]
                lane = lanes[(s, (head - ptr[s]) % G)]
                q, base, acc = lane
                row, link = rows[q], link_of(q, s)
                slots = range(base, row_len[row])
                if base + S < row_len[row] or not all(
                        seen[cols[row][k]] or cols[row][k] == link for k in slots):
                    break
                for k in slots:
                    acc = acc + vals[row, k] * (carry if cols[row][k] == link else
                                                y[cols[row][k]])
                y[row] = (r[row] - acc) * inv[row]
                done[row], progressed = True, True
                lane[:] = [q + G, 0, zero]
                heads[s] = [head + 1, y[row]]
                if head + 1 == ptr[s + 1]:
                    del heads[s]
                    break
        assert progressed, "T1's schedule stalled"
    return y[:n]


def _check_strands(tri):
    """Every row in one strand; a strand's levels increase; as many strands
    as the widest level has rows; some row reads the strand's row before it
    (its link) wherever there is more than one level."""
    n = tri.num_rows
    rows, ptr = tri.strand_rows.long(), tri.strand_ptr.long()
    assert tri.strand_rows.dtype == tri.strand_ptr.dtype == torch.int32
    assert torch.equal(torch.sort(rows).values, torch.arange(n))
    assert int(ptr[0]) == 0 and int(ptr[-1]) == n and bool((torch.diff(ptr) > 0).all())
    assert ptr.numel() - 1 == (tri.level_rows.shape[1] if n else 0)
    lr = tri.level_rows
    real = lr < n
    level = torch.empty(n, dtype=torch.long)
    level[lr[real]] = torch.arange(tri.num_levels)[:, None].expand_as(lr)[real]
    lv = level[rows]
    first = torch.zeros(n, dtype=torch.bool)
    first[ptr[:-1]] = True
    assert bool((lv[1:] > lv[:-1])[~first[1:]].all())  # levels increase along a strand
    links = sum(int(rows[i - 1]) in tri.ell_cols[int(rows[i]), : tri.row_len[rows[i]]].tolist()
                for i in torch.nonzero(~first).flatten().tolist())
    assert links > 0 or tri.num_levels == 1  # strands are chains of links, packed


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


# The float64 factors under their own ids, and each again cast to float32,
# as the cells run it.
FACTOR_DTYPES = ([pytest.param(*f, torch.float64, id="-".join(f)) for f in FACTORS]
                 + [pytest.param(*f, torch.float32, id="-".join(f) + "-float32")
                    for f in FACTORS])


@pytest.mark.parametrize("mesh_name,kind,side,dtype", FACTOR_DTYPES)
def test_order_row_len_and_t1_model(mesh_name, kind, side, dtype):
    """``order``, ``row_len`` and the strands, and the model at the kernel's
    G = 32 and at other lanes and slots, on the factor's strands and on
    round-robin ones, give the plain exact solve's bits.  In float32,
    ``astype`` keeps the arrays T1 reads beside the values it casts."""
    t64, _ = _factors(mesh_name, kind)[side]
    t = t64.astype(dtype)
    if dtype == torch.float32:
        assert t.ell_vals.dtype == t.inv_diag.dtype == torch.float32
        for name in ("level_rows", "ell_cols", "order", "row_len", "strand_rows", "strand_ptr"):
            assert getattr(t, name) is getattr(t64, name), name
    _check_schedule(t)
    _check_strands(t)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(t.num_rows)).to(dtype)
    want = tk.exact_plain(t, r)
    assert want.dtype == dtype and bool(torch.isfinite(want).all())
    S = tk.grid_slots(t.ell_cols.shape[1])
    for G, s in ((32, S), (32, 1), (32, 8), (1, 1), (4, 2)):  # the kernel's G is 32
        assert torch.equal(_t1_model(t, r, G, s), want), (G, s)
    for count in (1, 7, 64):  # the card's room below the factor's strands
        strands = tk.round_robin_strands(t.order, count)
        assert torch.equal(_t1_model(t, r, 32, S, strands), want), count


def _wide_factor(width, levels, seed):
    """Levels of ``width`` rows, each row reading 1–3 rows of earlier
    levels, one of them in the level just before."""
    rng = np.random.default_rng(seed)
    n = width * levels
    rows, cols, vals = [], [], []
    for i in range(n):
        lev = i // width
        deps = set()
        if lev:
            deps = {int(j) for j in rng.choice(lev * width, size=int(rng.integers(1, 3)),
                                               replace=False)}
            deps.add((lev - 1) * width + int(rng.integers(width)))
        for j in sorted(deps) + [i]:
            rows.append(i), cols.append(j)
            vals.append(2.0 + rng.random() if j == i else rng.standard_normal())
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, np.asarray(rows) + 1, 1)
    tri = tp.build_triangular(np.cumsum(rp), np.asarray(cols), np.asarray(vals), n, lower=True,
                              **CPU)
    assert tri.num_levels == levels
    return tri


def test_t1_grid_slots_and_round_robin_strands():
    """T1's slots a lane: the power of two at or above K, at most 8
    (a row of more takes passes), a count the kernel is built for.
    Round-robin strands deal the level order out in turn."""
    slots = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 7: 8, 8: 8, 9: 8, 33: 8, 500: 8}
    assert {K: tk.grid_slots(K) for K in slots} == slots
    assert set(slots.values()) == set(tk.GRID_SLOTS)
    order = torch.as_tensor(np.random.default_rng(1).permutation(23).astype(np.int32))
    for count in (1, 5, 23, 40):
        rows, ptr = tk.round_robin_strands(order, count)
        assert rows.dtype == ptr.dtype == torch.int32 and ptr.numel() == count + 1
        for s in range(count):
            assert rows[ptr[s]:ptr[s + 1]].tolist() == order[s::count].tolist()


def _chain(n, seed):
    """A lower bidiagonal factor: row i reads row i − 1, so n levels of one
    row (K = 1)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1)])
    vals = np.concatenate([1.0 + rng.random(n), -0.9 * rng.random(n - 1)])
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return tp.build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True, **CPU)


def test_strands_on_wide_and_chained_factors():
    """``strands`` on a chain (one strand), on levels wider than a warp
    and on levels that begin inside a warp's rows: the properties
    ``_check_strands`` holds, and the model's bits."""
    for tri in (_wide_factor(37, 5, 0), _wide_factor(150, 3, 1),
                _factors("refined", "sgs")["lower"][0]):
        _check_strands(tri)
        r = torch.as_tensor(np.random.default_rng(6).standard_normal(tri.num_rows))
        assert torch.equal(_t1_model(tri, r), tk.exact_plain(tri, r))
    n = 50  # a chain: every row reads the one before, so one strand holds all
    tri = _chain(n, 0)
    _check_strands(tri)
    assert tri.strand_ptr.tolist() == [0, n] and tri.strand_rows.tolist() == list(range(n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_t1_model_on_the_old_block_shapes(dtype):
    """Chains and narrow levels of few slots (K ≤ 3, at most 75 rows a level
    on average), which T1's one kernel solves too: a chain of 2,000 rows
    (K = 1) and levels of 20–75 rows at K = 2–3.
    The model at the kernel's G = 32 and S = ``grid_slots(K)``, on the
    factor's strands and on round-robin ones, gives the plain exact solve's
    bits."""
    for tri, counts in ((_chain(2_000, 1), (1, 7)), (_wide_factor(20, 12, 2), (1, 7, 64)),
                        (_wide_factor(48, 6, 3), (1, 7, 64)),
                        (_wide_factor(75, 4, 4), (1, 7, 64))):
        K = tri.ell_cols.shape[1]
        assert K <= 3 and tri.num_rows <= 75 * tri.num_levels
        _check_strands(tri)
        t = tri.astype(dtype)
        r = torch.as_tensor(np.random.default_rng(7).standard_normal(t.num_rows)).to(dtype)
        want = tk.exact_plain(t, r)
        assert bool(torch.isfinite(want).all())
        S = tk.grid_slots(K)
        assert torch.equal(_t1_model(t, r, 32, S), want), tri.num_rows
        for count in counts:
            strands = tk.round_robin_strands(t.order, count)
            assert torch.equal(_t1_model(t, r, 32, S, strands), want), (tri.num_rows, count)


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
    _check_strands(tri)
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
            _check_strands(f)
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
        for f in (f1, f2):
            assert torch.equal(_t1_model(f, r, 8), tk.exact_plain(f, r))


def test_t1_refuses_capture_before_taking_state(monkeypatch):
    """Inside a CUDA graph capture T1's wrapper raises CaptureRefusedError
    before it reads earlier solves' error words, plans, takes a slot or
    allocates; its slots, pending queue and counters are left as they were."""
    from stormx_torch.core.exceptions import CaptureRefusedError
    from stormx_torch.ops import capture

    rp = np.array([0, 1, 3, 5])
    tri = tp.build_triangular(rp, np.array([0, 0, 1, 1, 2]), np.array([2.0, -1.0, 2.0, -1.0, 2.0]),
                              3, lower=True, **CPU)

    def untouchable(*args, **kwargs):
        raise AssertionError("T1 took state inside a capture")

    for name in ("_read_errors", "_plan", "_take_slot", "_launch_exact"):
        monkeypatch.setattr(tk, name, untouchable)
    monkeypatch.setattr(capture, "capturing", lambda: True)
    monkeypatch.setattr(torch, "empty_like", untouchable)
    state = (len(tk._pending), {k: list(v) for k, v in tk._free_slots.items()},
             dict(tk.launches), dict(tk.slot_launches))
    with pytest.raises(CaptureRefusedError, match="capture"):
        tk.exact_cuda(tri, torch.ones(3))
    assert state == (len(tk._pending), {k: list(v) for k, v in tk._free_slots.items()},
                     dict(tk.launches), dict(tk.slot_launches))
