"""K1's two branches, host side: the staged branch's tile geometry and ring
bytes, the branch rule, the wrapper's refusals, and K1's plain version
against the JAX K1 (``sell_matvec_pallas`` in interpret mode).

The kernels themselves run only on the card (``tests/test_torch_kernels.py``
holds "staged" to "rows" bit for bit there).  Tolerance: the plain version
within 1e-6·max|y| of the JAX kernel in float32 (the K-sum order differs,
``pallas_sell.py:124-129``), and non-finite in exactly the JAX kernel's rows
when x holds Inf at a column that only padding slots read (0·Inf is NaN in
both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.ops.pallas_sell import sell_matvec_pallas
from stormx.sparse import formats as jf
from stormx.sparse import windowed as jw
from stormx_torch.ops import sell_spmv as k1
from stormx_torch.sparse import formats as tf
from stormx_torch.sparse import windowed as tw
from stormx_torch.sparse.windowed import SlicedELL

H100_SMS = 132
H100_OPTIN = 232_448  # bytes of shared memory a block may opt in to


def _sell(nb, K, R, *, data=None):
    """A SlicedELL of zeros (or ``data``) of shape (nb, K, R) on the CPU."""
    if data is None:
        data = torch.zeros(nb, K, R, dtype=torch.float32)
    return SlicedELL(data=data, local_cols=torch.zeros(data.shape, dtype=torch.int32),
                     shape=(nb * R, nb * R), window=R, pad_lo=0, mode="cuda",
                     dense_blocks=None)


def _branch(nb, K, R, n_cols=None, sms=H100_SMS, smem_optin=H100_OPTIN):
    return k1.k1_branch(nb, K, R, nb * R if n_cols is None else n_cols, sms=sms,
                        smem_optin=smem_optin)


# -- geometry ---------------------------------------------------------------------

# (nb, K, R) -> (T, consumers, tiles): the CH operator of the smoke (2,488
# blocks of 10 slots), its Laplacian (K = 4), K = 1, K = 17, a slab's
# interior (R = 512), one block.
GEOMETRY = [((2488, 10, 128), (5, 320, 498)),
            ((2488, 4, 128), (2, 128, 1244)),
            ((2488, 1, 128), (1, 64, 2488)),
            ((2488, 17, 128), (3, 192, 830)),
            ((156, 4, 512), (1, 256, 156)),
            ((1, 5, 128), (1, 64, 1)),
            ((3, 6, 40), (1, 32, 3))]


@pytest.mark.parametrize("shape,expected", GEOMETRY, ids=lambda v: "x".join(map(str, v)))
def test_staged_geometry(shape, expected):
    nb, K, R = shape
    g = k1.staged_geometry(nb, K, R, H100_SMS)
    assert (g.tile_blocks, g.consumers, g.tiles) == expected
    assert g.stages == k1.STAGES
    assert g.consumers % 32 == 0 and g.consumers <= k1.MAX_CONSUMERS
    assert g.consumers * k1.ROWS_PER_THREAD >= min(g.tile_blocks * R,
                                                   k1.MAX_CONSUMERS * k1.ROWS_PER_THREAD)
    # the tiles cover the blocks, the last one ragged
    assert (g.tiles - 1) * g.tile_blocks < nb <= g.tiles * g.tile_blocks
    assert g.smem_bytes == k1.ring_bytes(g.tile_blocks, g.stages, K, R)
    # a tile holds about 64·K rows, within the stage's byte cap unless one
    # block is already over it, and leaves two tiles an SM where it can
    assert g.tile_blocks * R <= max(k1.TILE_ROWS_PER_SLOT * K, R)
    assert 8 * g.tile_blocks * K * R <= max(k1.MAX_STAGE_BYTES, 8 * K * R)
    assert g.tiles >= min(nb, k1.MIN_BLOCKS_PER_SM * H100_SMS)


def test_ring_bytes():
    # The CH operator at T = 4, S = 3: 2·S·T·K·R·4 bytes of values and
    # columns, and 2·S barriers.
    assert k1.ring_bytes(4, 3, 10, 128) == 122_880 + 48
    assert k1.ring_bytes(1, 1, 1, 128) == 1024 + 16
    assert k1.ring_bytes(2, 6, 10, 128) == 2 * 6 * 2 * 10 * 128 * 4 + 2 * 6 * 8
    # the smoke's CH ring: two stages of five blocks, two rings an SM
    assert k1.staged_geometry(2488, 10, 128, H100_SMS).smem_bytes == 102_432


# -- the branch rule ----------------------------------------------------------------

BRANCHES = [
    ("ch", (2488, 10, 128), "staged"),
    ("laplacian_k4", (2488, 4, 128), "rows"),
    ("k_under_min_staged_k", (2488, k1.MIN_STAGED_K - 1, 128), "rows"),
    ("k_at_min_staged_k", (2488, k1.MIN_STAGED_K, 128), "staged"),
    ("k1", (2488, 1, 128), "rows"),
    ("k17_runtime_k", (2488, 17, 128), "staged"),
    ("one_block", (1, 10, 128), "rows"),
    ("n_under_r", (1, 4, 128), "rows"),
    ("slab_interior", (156, 4, 512), "rows"),
    ("two_blocks_an_sm", (264, 10, 512), "staged"),
    ("under_two_blocks_an_sm", (263, 10, 512), "rows"),
    ("slab_head", (2, 4, 512), "rows"),
    ("slab_tail", (3, 4, 512), "rows"),
    ("ring_over_optin", (2488, 64, 512), "rows"),
    ("r_not_multiple_of_4", (2488, 4, 6), "rows"),
]


@pytest.mark.parametrize("name,shape,branch", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_branch_rule(name, shape, branch):
    nb, K, R = shape
    assert _branch(nb, K, R) == branch


def test_branch_rule_needs_32_bit_indices():
    nb = 2**31 // 128
    assert _branch(nb - 1, 10, 128, n_cols=1000) == "staged"
    assert _branch(nb, 10, 128, n_cols=1000) == "rows"
    assert _branch(1000, 10, 128, n_cols=2**31 - 1) == "staged"
    assert _branch(1000, 10, 128, n_cols=2**31) == "rows"


def test_branch_rule_follows_the_card():
    # fewer SMs: a small operator has a block for each; less shared memory:
    # the CH ring no longer fits.
    assert _branch(40, 10, 128, sms=16) == "staged"
    assert _branch(40, 10, 128, sms=132) == "rows"
    assert _branch(2488, 10, 128, smem_optin=100_000) == "rows"


# -- refusals ------------------------------------------------------------------------


def test_check_branch_refuses_what_staged_cannot_take():
    kw = dict(sms=H100_SMS, smem_optin=H100_OPTIN)
    assert k1.check_branch(_sell(4, 4, 128), "rows", **kw) is None
    g = k1.check_branch(_sell(4, 4, 128), "staged", **kw)
    assert g == k1.staged_geometry(4, 4, 128, H100_SMS)
    with pytest.raises(ValueError, match="unknown K1 branch"):
        k1.check_branch(_sell(4, 4, 128), "tiles", **kw)
    with pytest.raises(ValueError, match="opt-in limit"):
        k1.check_branch(_sell(2, 64, 512), "staged", **kw)
    with pytest.raises(ValueError, match="multiple of 4"):
        k1.check_branch(_sell(4, 4, 6), "staged", **kw)
    # a view one float into its storage is not 16-byte aligned
    flat = torch.zeros(4 * 4 * 128 + 1, dtype=torch.float32)
    view = flat[1:].reshape(4, 4, 128)
    assert view.data_ptr() % 16
    with pytest.raises(ValueError, match="align"):
        k1.check_branch(_sell(4, 4, 128, data=view), "staged", **kw)
    # "rows" takes any of them
    assert k1.check_branch(_sell(4, 4, 128, data=view), "rows", **kw) is None


def test_slab_views_stay_aligned():
    """The slab product's block ranges are views at lo·K·R floats: 16-byte
    aligned when K·R is a multiple of 4, as at R = 128 and 512."""
    base = _sell(40, 7, 512)
    for lo, hi in ((0, 3), (3, 37), (37, 40)):
        view = _sell(hi - lo, 7, 512, data=base.data[lo:hi])
        assert k1.check_branch(view, "staged", sms=1, smem_optin=H100_OPTIN) is not None


def test_wrapper_refuses_cpu_tensors_with_either_branch():
    op = _sell(4, 4, 128)
    for branch in (None, "staged", "rows"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            k1.sell_spmv_cuda(op, torch.zeros(op.shape[1]), branch=branch)


# -- the plain version against the JAX K1 ---------------------------------------------


def _banded(n, K, band, R, seed, empty_block):
    """A float32 CSR of up to K entries a row within ``band`` of the
    diagonal, with one entry at −band (so ``pad_lo`` = band), every seventh
    row cut to K // 2 entries (padding slots), and column R·empty_block −
    band named by no entry: only the padding slots of block ``empty_block``
    read it."""
    rng = np.random.default_rng(seed)
    empty = R * empty_block - band
    rows, cols = [], []
    for i in range(n):
        width = K // 2 if i % 7 == 0 else K
        near = np.arange(max(0, i - band + 1), min(n, i + band + 1))
        near = near[near != empty]
        picked = np.sort(rng.choice(near, min(width, len(near)), replace=False))
        rows.append(np.full(len(picked), i))
        cols.append(picked)
    rows.append(np.array([band + 5]))
    cols.append(np.array([5]))  # offset −band: the lower bandwidth
    r, c = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = rng.standard_normal(len(r)).astype(np.float32)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptr, r + 1, 1)
    return np.cumsum(row_ptr), c, v, empty


@pytest.mark.parametrize("R", [128, 256])
def test_plain_matches_jax_k1_with_pad_lo_over_r_and_padding_inf(R):
    n, K, band, block = 1000, 6, 300, 600 // R  # nb = ⌈1000/R⌉, the last block ragged
    row_ptr, cols, vals, empty = _banded(n, K, band, R, seed=R, empty_block=block)
    cj = jf.CSR(jnp.asarray(vals), jnp.asarray(cols.astype(np.int32)),
                jnp.asarray(row_ptr.astype(np.int32)), (n, n))
    ct = tf.CSR(torch.as_tensor(vals), torch.as_tensor(cols.astype(np.int32)),
                torch.as_tensor(row_ptr.astype(np.int32)), (n, n))
    sj, _ = jw.sell_from_csr(cj, mode="pallas", block_rows=R, reorder=False)
    st, _ = tw.sell_from_csr(ct, mode="cuda", block_rows=R, reorder=False, device="cpu")
    assert st.pad_lo == sj.pad_lo == band > R
    assert n % R  # a ragged last block
    np.testing.assert_array_equal(st.data.numpy().transpose(0, 2, 1), np.asarray(sj.data))
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y_j = np.asarray(sell_matvec_pallas(sj, jnp.asarray(x), interpret=True))
    y_t = k1.sell_spmv_plain(st, torch.as_tensor(x)).numpy()
    assert y_t.shape == y_j.shape == (n,)
    assert np.abs(y_t - y_j).max() <= 1e-6 * np.abs(y_j).max()

    # Inf at the column no entry names: 0·Inf in the padding slots of block
    # `block`, and nowhere else.
    assert not np.isin(empty, cols)
    x[empty] = np.inf
    y_j = np.asarray(sell_matvec_pallas(sj, jnp.asarray(x), interpret=True))
    y_t = k1.sell_spmv_plain(st, torch.as_tensor(x)).numpy()
    bad_j, bad_t = np.flatnonzero(~np.isfinite(y_j)), np.flatnonzero(~np.isfinite(y_t))
    padded = np.flatnonzero((st.data[block] == 0).any(dim=0).numpy()) + block * R
    np.testing.assert_array_equal(bad_t, bad_j)
    np.testing.assert_array_equal(bad_t, padded[padded < n])
    assert np.isnan(y_t[bad_t]).all() and np.isnan(y_j[bad_j]).all()
    ok = np.isfinite(y_j)
    assert np.abs(y_t[ok] - y_j[ok]).max() <= 1e-6 * np.abs(y_j[ok]).max()
