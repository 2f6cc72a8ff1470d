"""The two probes of stormx_torch (P1 ``lane_gather``, P2
``dia_stream_probe``) against the Pallas probe kernels in interpret mode, on
the CPU, where the port takes the plain versions.

The probe scripts set a compilation-cache path and ``sys.path`` when
imported (``scripts/perf_pallas_bisect.py:19-20,29``), so this file builds
the same ``pallas_call``s with the same BlockSpecs from copies of their
kernels instead of importing them.  Tolerances: P1 bit-exact; P2's
``"win"`` and ``"zonly"`` exact, ``"full"`` and ``"diag"`` within
1e-6·max|z| (interpret mode lets XLA fuse and reorder the five-term sums;
measured 9.5e-7 absolute at 4 tiles of 8×128).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stormx_torch.ops import probes

LANE = 128
ND = 5


def _p1_kernel(x_ref, idx_ref, out_ref):
    """Copy of ``scripts/pallas_gather_probe.py:35-38``."""
    out_ref[:, :] = jnp.take_along_axis(x_ref[:, :], idx_ref[:, :], axis=1,
                                        mode="promise_in_bounds")


def _p1_pallas(x, idx):
    """The probe's ``pallas_call`` (``pallas_gather_probe.py:44-53``) in
    interpret mode."""
    f = pl.pallas_call(
        _p1_kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(idx)))


def _p2_kernel(mode, tile, s_ref, x_hbm, diag_ref, z_ref, win, sem):
    """Copy of ``scripts/perf_pallas_bisect.py:36-73``."""
    i = pl.program_id(0)
    n_tiles = pl.num_programs(0)
    w_rows = tile + 16

    def copy_for(t, slot):
        return pltpu.make_async_copy(
            x_hbm.at[pl.ds(t * tile, w_rows), :], win.at[slot], sem.at[slot]
        )

    if mode in ("win", "full"):
        @pl.when(i == 0)
        def _():
            copy_for(0, 0).start()

        @pl.when(i + 1 < n_tiles)
        def _():
            copy_for(i + 1, (i + 1) % 2).start()

        copy_for(i, i % 2).wait()

    c = s_ref[0, 0]
    if mode == "diag":
        acc = jnp.full((tile, LANE), c, jnp.float32)
        for d in range(ND):
            acc += diag_ref[d]
        z_ref[...] = acc
    elif mode == "win":
        z_ref[...] = win[i % 2, 8 : 8 + tile, :] * 2.0 + c
    elif mode == "zonly":
        z_ref[...] = jnp.full((tile, LANE), 1.5, jnp.float32) + c
    else:  # full
        acc = jnp.full((tile, LANE), c, jnp.float32)
        for d in range(ND):
            acc += diag_ref[d] * win[i % 2, d : d + tile, :]
        z_ref[...] = acc


def _p2_pallas(mode, c, x, diag, n_tiles, tile):
    """The probe's ``pallas_call`` (``perf_pallas_bisect.py:87-102``) in
    interpret mode."""
    call = pl.pallas_call(
        functools.partial(_p2_kernel, mode, tile),
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((ND, tile, LANE), lambda i: (0, i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile, LANE), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_tiles * tile, LANE), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((2, tile + 16, LANE), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )
    z = call(jnp.full((1, 1), c, jnp.float32), jnp.asarray(x).reshape(-1, LANE),
             jnp.asarray(diag).reshape(ND, -1, LANE))
    return np.asarray(z).reshape(-1)


@pytest.mark.parametrize("rows", [16, 300])
def test_lane_gather_bit_exact_against_pallas_probe(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, LANE)).astype(np.float32)
    idx = rng.integers(0, LANE, size=(rows, LANE)).astype(np.int32)
    y = probes.lane_gather(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(y.numpy(), _p1_pallas(x, idx))
    np.testing.assert_array_equal(y.numpy(), np.take_along_axis(x, idx, axis=1))


@pytest.mark.parametrize("mode", probes.STREAM_MODES)
def test_dia_stream_probe_matches_pallas_probe(mode):
    n_tiles, tile = 4, 8
    n = n_tiles * tile * LANE
    rng = np.random.default_rng(0)
    diag = rng.standard_normal((ND, n)).astype(np.float32)
    x = rng.standard_normal(n + probes.X_HALO).astype(np.float32)
    c = 0.3125
    z = probes.dia_stream_probe(mode, c, torch.as_tensor(x), torch.as_tensor(diag)).numpy()
    z_j = _p2_pallas(mode, c, x, diag, n_tiles, tile)
    assert z.shape == z_j.shape == (n,)
    if mode in ("win", "zonly"):
        np.testing.assert_array_equal(z, z_j)
    else:
        assert np.abs(z - z_j).max() <= 1e-6 * np.abs(z_j).max()
    want = {
        "full": c + sum(diag[d].astype(np.float64) * x[128 * d: 128 * d + n] for d in range(ND)),
        "diag": c + diag.astype(np.float64).sum(axis=0),
        "win": 2.0 * x[1024: 1024 + n].astype(np.float64) + c,
        "zonly": np.full(n, 1.5 + c),
    }[mode]
    assert np.abs(z - want).max() <= 1e-6 * np.abs(want).max()


def test_probe_arguments_are_checked():
    n = 1024
    x, diag = torch.zeros(n + probes.X_HALO), torch.zeros(ND, n)
    with pytest.raises(ValueError, match="mode"):
        probes.dia_stream_probe("half", 0.0, x, diag)
    with pytest.raises(ValueError, match="CUDA"):
        probes.dia_stream_probe_cuda("full", 0.0, x, diag)
    with pytest.raises(ValueError, match="CUDA"):
        probes.lane_gather_cuda(torch.zeros(4, LANE), torch.zeros(4, LANE, dtype=torch.int32))
    assert probes.stream_bytes("full", n) == 4 * 7 * n
    assert probes.launches == {"lane_gather": 0, "dia_stream_probe": 0}
