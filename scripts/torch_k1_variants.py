#!/usr/bin/env python3
"""Check and time K1's two branches, and variants of its staged geometry, on
one CUDA card.

    python3 scripts/torch_k1_variants.py --check   # build, ptxas, bitwise checks
    python3 scripts/torch_k1_variants.py           # time the smoke's shapes
    python3 scripts/torch_k1_variants.py --sweep   # time both branches over K

``--check`` builds ``stormx_torch/csrc/sell_spmv.cu``, prints ptxas's
register and spill lines of each kernel, and launches both branches once on
synthetic banded operators (``banded_csr``: a Cahn–Hilliard-like K = 10 at
318,402 rows with a window offset ``pad_lo`` over R, K = 4, K = 1, K = 17,
one row block, fewer rows than R, and the interior, head and tail block
ranges of a R = 512 slab in the slab product's rectangular form), each
held bit for bit against the other and within 1e-5·max|y| of the plain
version, also with Inf in x where padding slots read it.

Without ``--check`` it builds the operators of ``chip_smoke.py`` on the
318,402-cell jittered Delaunay mesh (the Cahn–Hilliard operator, the
Laplacian, the convection–diffusion operator, V + τ·L, and rank 1 of 4's
slab of V + τ·L with its three block ranges) and times, in one process,
the "rows" branch, the staged branch at each variant of ``VARIANTS``
(rows a consumer thread takes, built once per value; rows a tile,
stages), and ``torch.sparse_csr_tensor @ x``: CUDA-event medians
(``time_ms``), L2 warm, flushed by a write (dirty lines) and by a read
(clean lines), and two launches back to back warm (the second's
marginal time carries no fixed cost of the first), the variants in turns
(forward, then backward), beside an empty kernel's time through the same
timer (the timer's floor) and the bound.  Every variant is first held bit
for bit to "rows".  One JSON line per operator, then the card's
``nvidia-smi`` name and power limit.

``--sweep`` times "rows" and the package's staged branch, in turns, warm
and flushed by a write, on synthetic banded operators of the Cahn–Hilliard
operator's 2,488 row blocks of R = 128 rows at K = 2..16 slots (the branch
rule's ``MIN_STAGED_K``), each held bit for bit to "rows" first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# name -> the staged geometry's rows a tile, stages and rows a consumer
# thread (kRowsPerThread of csrc/sell_spmv.cu, each value its own build) in
# place of the package's constants (``variant_geometry``).  "as_built" is
# the package's own.
VARIANTS = {
    "as_built": dict(),
    "rows256": dict(tile_rows=256),
    "rows512": dict(tile_rows=512),
    "rows1024": dict(tile_rows=1024),
    "s3": dict(stages=3),
    "rpt1": dict(rows_per_thread=1),
    "rpt4": dict(rows_per_thread=4),
}
SWEEP_K = (2, 3, 4, 5, 6, 7, 8, 10, 12, 16)


def variant_geometry(nb: int, K: int, R: int, sms: int, kw: dict):
    """``sell_spmv.staged_geometry`` with a variant's ``tile_rows``,
    ``stages`` and ``rows_per_thread`` in place of TILE_ROWS_PER_SLOT·K,
    STAGES and ROWS_PER_THREAD."""
    from stormx_torch.ops import sell_spmv as k1

    rows = kw.get("tile_rows", k1.TILE_ROWS_PER_SLOT * K)
    S, rpt = kw.get("stages", k1.STAGES), kw.get("rows_per_thread", k1.ROWS_PER_THREAD)
    T = max(1, min(rows // R, k1.MAX_STAGE_BYTES // (8 * K * R),
                   nb // max(k1.MIN_BLOCKS_PER_SM * sms, 1)))
    consumers = min(k1.MAX_CONSUMERS, -(-T * R // (32 * rpt)) * 32)
    g = k1.StagedGeometry(tile_blocks=T, stages=S, consumers=consumers, tiles=-(-nb // T),
                          smem_bytes=k1.ring_bytes(T, S, K, R))
    if not kw and g != k1.staged_geometry(nb, K, R, sms):
        raise RuntimeError("variant_geometry no longer matches sell_spmv.staged_geometry")
    return g


def time_ms(torch, fn, *, flush=None, read_flush=None) -> float:
    """``chip_smoke.time_ms``, or with ``read_flush``, a tensor larger than
    L2, read (summed) before every timed call, so L2 holds clean lines."""
    if read_flush is None:
        return cs.time_ms(torch, fn, flush=flush)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(cs.TIMING_REPS):
        torch.cuda._sleep(cs.SLEEP_CYCLES)
        read_flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_variants() -> dict:
    """One library of csrc/sell_spmv.cu per kRowsPerThread of ``VARIANTS``
    (the package's own value is the package's library), built together into
    build/k1_variants/."""
    import ctypes
    import re
    import subprocess

    from stormx_torch.ops import _cuda, sell_spmv

    own = sell_spmv.ROWS_PER_THREAD
    _cuda.build(["sell_spmv"])
    libs = {own: _cuda.library("sell_spmv")}
    out_dir = os.path.join(REPO, "build", "k1_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(REPO, "stormx_torch", "csrc", "sell_spmv.cu")) as f:
        text = f.read()
    procs = {}
    for key in {variant_key(v) for v in VARIANTS.values()} - {own}:
        src, n = re.subn(r"(constexpr int kRowsPerThread = )\d+;", rf"\g<1>{key};", text)
        if n != 1:
            raise RuntimeError("kRowsPerThread not found once in sell_spmv.cu")
        name = f"rpt{key}"
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[key] = (lib, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
        print(json.dumps(dict(variant_build=key, spill_lines=spills)), flush=True)
        lib = ctypes.CDLL(path)
        for entry, argtypes in _cuda.ENTRIES["sell_spmv"].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        lib.stormx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.stormx_cuda_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def variant_key(kw: dict) -> int:
    from stormx_torch.ops import sell_spmv

    return kw.get("rows_per_thread", sell_spmv.ROWS_PER_THREAD)


def banded_csr(n: int, K: int, band: int, seed: int):
    """A float32 host CSR whose rows hold up to K entries within ``band``
    of the diagonal (duplicates and columns outside [0, n) dropped, every
    seventh row cut to K // 2 + 1), so the SlicedELL has padding slots."""
    from stormx_torch.sparse.formats import CSR

    rng = np.random.default_rng(seed)
    offs = rng.integers(-band, band + 1, size=(n, K))
    offs[:, 0] = 0
    cols = np.sort(np.arange(n)[:, None] + offs, axis=1)
    keep = (cols >= 0) & (cols < n)
    keep[:, 1:] &= cols[:, 1:] != cols[:, :-1]
    keep[::7, K // 2 + 1:] = False
    row_ptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(np.int32)
    return CSR(data=rng.standard_normal(int(row_ptr[-1])).astype(np.float32),
               indices=cols[keep].astype(np.int32), row_ptr=row_ptr, shape=(n, n))


def slab_ranges(op, lo_blocks: int, hi_blocks: int):
    """The slab product's three rectangular operators (interior, head and
    tail block ranges, ``parallel/sliced.py``) over the blocks of ``op``
    that lie ``lo_blocks`` after its start and ``hi_blocks`` before its end:
    views of its arrays at pad_lo 0, each with the x its windows read."""
    from stormx_torch.sparse.windowed import SlicedELL

    nb, _, R = op.data.shape
    C = op.window

    def view(lo, hi):
        n_cols = (hi - lo - 1) * R + C
        return SlicedELL(data=op.data[lo:hi], local_cols=op.local_cols[lo:hi],
                         shape=((hi - lo) * R, n_cols), window=C, pad_lo=0, mode="cuda",
                         dense_blocks=None)

    return {"slab_interior": view(lo_blocks, nb - hi_blocks),
            "slab_head": view(0, lo_blocks), "slab_tail": view(nb - hi_blocks, nb)}


def synthetic_ops(torch, dev) -> dict:
    from stormx_torch.sparse.windowed import sell_from_csr

    def sell(csr, R=128):
        return sell_from_csr(csr, block_rows=R, mode="cuda", reorder=False, device=dev)[0]

    n = 318_402
    ops = {"ch_like_k10": sell(banded_csr(n, 10, 1400, 0)),
           "k4": sell(banded_csr(n, 4, 600, 1)),
           "k1": sell(banded_csr(n, 1, 0, 2)),
           "k17": sell(banded_csr(n, 17, 700, 3)),
           "one_block": sell(banded_csr(100, 6, 20, 4)),
           "n_under_r": sell(banded_csr(50, 5, 10, 5))}
    ops.update(slab_ranges(sell(banded_csr(80_000, 10, 900, 6), R=512), 2, 3))
    return ops


def bit_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check(torch, dev) -> int:
    from stormx_torch.ops import _cuda, sell_spmv

    build_s = _cuda.build(["sell_spmv"])
    ptxas = [ln.strip() for ln in _cuda.build_log.get("sell_spmv", "").splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print(json.dumps(dict(build_s=build_s, ptxas=ptxas)), flush=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    failures = []
    for name, op in synthetic_ops(torch, dev).items():
        x = torch.randn(op.shape[1], generator=gen, dtype=torch.float32).to(dev)
        nb, K, R = op.data.shape
        sms, _ = sell_spmv.card_numbers(dev)
        chosen = sell_spmv.branch_of(op)
        y_rows = sell_spmv.sell_spmv_cuda(op, x, branch="rows")
        y_staged = sell_spmv.sell_spmv_cuda(op, x, branch="staged")
        y_plain = sell_spmv.sell_spmv_plain(op, x)
        torch.cuda.synchronize()
        scale = float(y_plain.abs().max())
        err = float((y_staged - y_plain).abs().max())
        x_view = torch.empty(op.shape[1] + 1, dtype=torch.float32, device=dev)[1:]
        x_view.copy_(x)
        same = bit_equal(torch, y_rows, y_staged) and bit_equal(
            torch, y_rows, sell_spmv.sell_spmv_cuda(op, x_view, branch="staged"))
        # Inf where padding slots read: x[R·b − pad_lo] of a block with padding.
        xi = x.clone()
        pads = (op.data == 0).any(dim=1).any(dim=1).nonzero().reshape(-1)
        g = pads * R - op.pad_lo
        g = g[(g >= 0) & (g < op.shape[1])]
        if g.numel():
            xi[g[0]] = float("inf")
        yi_rows = sell_spmv.sell_spmv_cuda(op, xi, branch="rows")
        yi_staged = sell_spmv.sell_spmv_cuda(op, xi, branch="staged")
        yi_plain = sell_spmv.sell_spmv_plain(op, xi)
        torch.cuda.synchronize()
        nan_rows = cs.nonfinite_rows(torch, yi_plain)
        same_inf = bit_equal(torch, yi_rows, yi_staged)
        same_nan = torch.equal(cs.nonfinite_rows(torch, yi_staged), nan_rows)
        row = dict(operator=name, nb=nb, K=K, R=R, rows=op.shape[0], cols=op.shape[1],
                   pad_lo=op.pad_lo, window=op.window, branch=chosen,
                   geometry=sell_spmv.staged_geometry(nb, K, R, sms).__dict__,
                   staged_bit_equal_rows=same, max_abs_err=err, max_abs_y=scale,
                   inf_at=int(g[0]) if g.numel() else None, nan_rows=int(nan_rows.numel()),
                   inf_bit_equal=same_inf, inf_nan_rows_equal=same_nan)
        print(json.dumps(row), flush=True)
        if not (same and same_inf and same_nan and err <= 1e-5 * scale):
            failures.append(name)
    print(json.dumps(dict(failures=failures, branch_launches=sell_spmv.branch_launches)),
          flush=True)
    return 1 if failures else 0


def smoke_ops(torch, dev) -> dict:
    """The operators K1 runs on in ``chip_smoke.py``, float32 on ``dev``."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.fvm import assemble_convection_diffusion
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import build_mesh
    from stormx_torch.parallel import partition_sliced
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import SlicedELL, auto_operator

    f32 = torch.float32
    pts, tris = cs.delaunay_mesh(cs.GRID_SIDE, cs.JITTER, seed=0)
    mesh = build_mesh(pts, tris).optimize_ordering()
    centers = mesh.cell_centers
    ops = {"ch": make_assembled_step(mesh, dtype=f32, device=dev).operator}
    lap = assemble_laplacian(mesh).to_csr()
    ops["laplacian"], _ = auto_operator(CSR(data=lap.data.to(f32), indices=lap.indices,
                                            row_ptr=lap.row_ptr, shape=lap.shape),
                                        coords=centers, device=dev)
    cd = assemble_convection_diffusion(mesh, cs.rotating_velocity, cs.CONVDIFF_EPS).to_csr()
    ops["convdiff"], _ = auto_operator(CSR(data=cd.data.to(f32), indices=cd.indices,
                                           row_ptr=cd.row_ptr, shape=cd.shape),
                                       coords=centers, device=dev)
    h32 = cs.host_csr(cs.diffusion_csr(mesh, lap), np.float32)
    ops["diffusion"], _ = auto_operator(h32, coords=centers, device=dev)
    ps = partition_sliced(h32, cs.PAR_PARTS, mode="pallas", device="cpu")
    R, C, rank = ps.block_rows, ps.window, 1
    slab = SlicedELL(data=ps.ell_data[rank].to(dev), local_cols=ps.ell_cols[rank].to(dev),
                     shape=(ps.n_loc, ps.n_loc + C - R), window=C, pad_lo=0, mode="cuda",
                     dense_blocks=None)
    ops["slab"] = slab
    bl_lo, bl_hi = -(-ps.h_lo // R), (ps.n_loc - C + ps.h_lo) // R + 1
    ops.update(slab_ranges(slab, bl_lo, slab.data.shape[0] - bl_hi))
    return ops


def blocks_per_sm(lib, g, K, R) -> int:
    from stormx_torch.ops import _cuda

    blocks = lib.stormx_sell_staged_blocks_per_sm(g.tile_blocks, g.stages, K, R, g.consumers)
    _cuda.check(lib, max(-blocks, 0), "blocks_per_sm")
    return blocks


def time_all(torch, dev) -> int:
    from stormx_torch.ops import _cuda, banded_gather, sell_spmv

    _cuda.build(["banded_gather"])
    libs = build_variants()
    sms, optin = sell_spmv.card_numbers(dev)
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=torch.float32, device=dev)
    read_flush = torch.ones_like(flush)
    empty = lambda: banded_gather.empty_launch(1, dev)  # noqa: E731
    floor = dict(ms=time_ms(torch, empty), ms_l2_flushed=time_ms(torch, empty, flush=flush),
                 ms_clean_flushed=time_ms(torch, empty, read_flush=read_flush))
    print(json.dumps(dict(timer_floor=floor, sms=sms, smem_optin=optin)), flush=True)
    gen = torch.Generator(device="cpu").manual_seed(12)
    for name, op in smoke_ops(torch, dev).items():
        nb, K, R = op.data.shape
        x = torch.randn(op.shape[1], generator=gen, dtype=torch.float32).to(dev)
        y_rows = sell_spmv.sell_spmv_cuda(op, x, branch="rows")
        chosen = sell_spmv.branch_of(op)
        fns, geoms = {"rows": lambda: sell_spmv.sell_spmv_cuda(op, x, branch="rows")}, {}
        for v, kw in VARIANTS.items():
            lib = libs[variant_key(kw)]
            g = variant_geometry(nb, K, R, sms, kw)
            if g.smem_bytes > optin or R % 4:
                continue
            grid = min(g.tiles, sms * blocks_per_sm(lib, g, K, R))

            def fn(g=g, grid=grid, lib=lib):
                y = torch.empty(op.shape[0], dtype=torch.float32, device=dev)
                rc = lib.stormx_sell_spmv_staged(
                    op.data.data_ptr(), op.local_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                    op.shape[0], op.shape[1], nb, R, K, op.pad_lo, g.tile_blocks, g.stages,
                    g.consumers, grid, torch.cuda.current_stream().cuda_stream)
                _cuda.check(lib, rc, "staged variant")
                return y

            if not bit_equal(torch, fn(), y_rows):
                raise RuntimeError(f"variant {v} differs from 'rows' on {name}")
            fns[v] = fn
            geoms[v] = dict(g.__dict__, grid=grid)
        order = list(fns) + list(reversed(fns))
        times = {v: [] for v in fns}
        for v in order:
            pair = lambda f=fns[v]: (f(), f())  # noqa: E731
            times[v].append((time_ms(torch, fns[v]), time_ms(torch, fns[v], flush=flush),
                             time_ms(torch, fns[v], read_flush=read_flush),
                             time_ms(torch, pair)))
        csr = cs.sell_to_csr(op)
        a_csr, nnz = cs.torch_csr(torch, csr, dev), int(csr.nnz)
        b_ms, b_by = cs.bound_ms(8.0 * nnz + 4.0 * (op.shape[0] + op.shape[1]), 2.0 * nnz)
        print(json.dumps(dict(
            operator=name, rows=op.shape[0], cols=op.shape[1], nnz=nnz, nb=nb, K=K, R=R,
            pad_lo=op.pad_lo, window=op.window, branch=chosen, bound_ms=b_ms, bound_by=b_by,
            variants={v: dict(ms=[t[0] for t in ts], ms_l2_flushed=[t[1] for t in ts],
                              ms_clean_flushed=[t[2] for t in ts],
                              ms_two_launches=[t[3] for t in ts], geometry=geoms.get(v))
                      for v, ts in times.items()},
            library_ms=time_ms(torch, lambda: a_csr @ x))), flush=True)
        del a_csr
    print(cs.nvidia_smi(), flush=True)
    return 0


def sweep(torch, dev) -> int:
    """Both branches over K at the Cahn–Hilliard operator's 2,488 row
    blocks (``SWEEP_K``), warm and flushed, in turns."""
    from stormx_torch.ops import _cuda, banded_gather, sell_spmv
    from stormx_torch.sparse.windowed import sell_from_csr

    _cuda.build(["sell_spmv", "banded_gather"])
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=torch.float32, device=dev)
    empty = lambda: banded_gather.empty_launch(1, dev)  # noqa: E731
    print(json.dumps(dict(timer_floor=dict(ms=time_ms(torch, empty),
                                           ms_l2_flushed=time_ms(torch, empty, flush=flush)))),
          flush=True)
    gen = torch.Generator(device="cpu").manual_seed(7)
    for K in SWEEP_K:
        csr = banded_csr(318_402, K, 600, seed=K)
        op = sell_from_csr(csr, block_rows=128, mode="cuda", reorder=False, device=dev)[0]
        x = torch.randn(op.shape[1], generator=gen, dtype=torch.float32).to(dev)
        fns = {b: (lambda b=b: sell_spmv.sell_spmv_cuda(op, x, branch=b))
               for b in sell_spmv.BRANCHES}
        if not bit_equal(torch, fns["staged"](), fns["rows"]()):
            raise RuntimeError(f"'staged' differs from 'rows' at K = {K}")
        times = {b: dict(ms=[], ms_l2_flushed=[]) for b in fns}
        for b in ("rows", "staged", "staged", "rows"):
            times[b]["ms"].append(time_ms(torch, fns[b]))
            times[b]["ms_l2_flushed"].append(time_ms(torch, fns[b], flush=flush))
        nb, K_op, R = op.data.shape
        nnz = int(csr.row_ptr[-1])
        b_ms, b_by = cs.bound_ms(8.0 * nnz + 4.0 * (op.shape[0] + op.shape[1]), 2.0 * nnz)
        print(json.dumps(dict(K=K_op, nb=nb, R=R, nnz=nnz, branch=sell_spmv.branch_of(op),
                              bound_ms=b_ms, bound_by=b_by, **times)), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="build, print ptxas, check both branches on synthetic operators")
    parser.add_argument("--sweep", action="store_true",
                        help="time both branches over K at 2,488 row blocks")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.check:
        return check(torch, dev)
    return sweep(torch, dev) if args.sweep else time_all(torch, dev)


if __name__ == "__main__":
    sys.exit(main())
