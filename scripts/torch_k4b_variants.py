#!/usr/bin/env python3
"""Time variants of K4b's staged branch on one CUDA card.

    python3 scripts/torch_k4b_variants.py

Builds the operators of ``chip_smoke.py``'s packed phases (the Cahn–Hilliard
operator and the Laplacian of the 318,402-cell jittered Delaunay mesh,
repacked at R = 512), compiles ``stormx_torch/csrc/sell_packed.cu`` once per
variant of its staged-branch constants (threads a block, blocks an SM must
hold, tile rows of a warp in flight) or of its code (``VARIANTS``) into
``build/k4b_variants/``, and times each
variant's staged branch beside the per-row branch and
``torch.sparse_csr_tensor @ x`` in one process: CUDA-event medians, L2 warm
and flushed, the variants in turns (forward, then backward).  Each variant
is first held to the plain version within 1e-5·max|y|.  Prints one JSON line
per operator and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# name -> staged-branch constants of sell_packed.cu, and edits of its code.
# The probe "all_groups" reads every four-lane group of the tile rows below
# rows_used (live4 ignored).
READ_ALL_GROUPS = ("live[u] = m < staged && ((bits[m] >> t) & 1u);", "live[u] = m < staged;")
VARIANTS = {
    "as_built": dict(),
    "t512": dict(kStagedThreadsSmallM=512),
    "t256": dict(kStagedThreads=256, kStagedMinBlocks=6),
    "u4_b2": dict(kStageUnroll=4, kStagedMinBlocks=2),
    "all_groups": dict(edits=[READ_ALL_GROUPS]),
}


def build_variants(torch) -> dict:
    from stormx_torch.ops import _cuda

    out_dir = os.path.join(REPO, "build", "k4b_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(REPO, "stormx_torch", "csrc", "sell_packed.cu")) as f:
        text = f.read()
    procs = {}
    for name, consts in VARIANTS.items():
        src = text
        for old, new in consts.get("edits", ()):
            if src.count(old) != 1:
                raise RuntimeError(f"{old!r} not found once in sell_packed.cu")
            src = src.replace(old, new)
        for const, value in consts.items():
            if const == "edits":
                continue
            src, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;", rf"\g<1>{value};", src)
            if n != 1:
                raise RuntimeError(f"{const} not found once in sell_packed.cu")
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", os.path.join(REPO, "stormx_torch", "csrc"),
             "-o", lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name], entry = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln
            elif "registers" in ln and "staged" in entry:
                ptxas[name].append(ln.split(":", 1)[1].strip())
        lib = ctypes.CDLL(path)
        for entry, argtypes in _cuda.ENTRIES["sell_packed"].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        lib.stormx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.stormx_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, ptxas


def launch(torch, lib, packed, x, staged: int):
    from stormx_torch.ops import _cuda

    y = torch.empty(packed.shape[0], dtype=torch.float32, device=x.device)
    nb, M, _ = packed.vals.shape
    rc = lib.stormx_packed_spmv_gather(
        packed.idx.data_ptr(), packed.vals.data_ptr(), packed.src.data_ptr(),
        packed.live4.data_ptr(), packed.rows_used.data_ptr(), packed.xlane.data_ptr(),
        packed.xchunk.data_ptr(), x.data_ptr(), y.data_ptr(),
        packed.shape[0], packed.shape[1], nb, M, packed.block_rows, packed.ell_k,
        packed.pad_lo, staged, torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, rc, "variant launch")
    return y


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k4b_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import build_mesh
    from stormx_torch.ops import sell_packed as k4
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import auto_operator, sell_from_csr

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs, ptxas = build_variants(torch)
    pts, tris = cs.delaunay_mesh(cs.GRID_SIDE, cs.JITTER, seed=0)
    mesh = build_mesh(pts, tris).optimize_ordering()
    ch = make_assembled_step(mesh, dtype=torch.float32, device=dev).operator
    lc = assemble_laplacian(mesh).to_csr()
    lap, _ = auto_operator(CSR(data=lc.data.float(), indices=lc.indices, row_ptr=lc.row_ptr,
                               shape=lc.shape), coords=mesh.cell_centers, device=dev)
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(3)
    for name, op in (("ch", ch), ("laplacian", lap)):
        csr = cs.sell_to_csr(op)
        sell, _ = sell_from_csr(csr, block_rows=cs.PACKED_BLOCK_ROWS, mode="cuda",
                                reorder=False, device=dev)
        packed = k4.pack_sell(sell, "gather")
        x = torch.randn(csr.shape[0], generator=gen, dtype=torch.float32).to(dev)
        y_p = k4.packed_spmv_plain(packed, x)
        scale = float(y_p.abs().max())
        errs = {}
        for v, lib in libs.items():
            errs[v] = float((launch(torch, lib, packed, x, 1) - y_p).abs().max())
            if errs[v] > 1e-5 * scale:
                raise RuntimeError(f"{v} differs from the plain version on {name}: {errs[v]}")
        a_csr = cs.torch_csr(torch, csr, dev)
        order = list(libs) + list(reversed(libs))
        times: dict[str, list] = {v: [] for v in libs}
        for v in order:
            fn = (lambda lib=libs[v]: launch(torch, lib, packed, x, 1))
            times[v].append((cs.time_ms(torch, fn), cs.time_ms(torch, fn, flush=flush)))
        rows_fn = lambda: launch(torch, libs[next(iter(libs))], packed, x, 0)  # noqa: E731
        print(json.dumps(dict(
            operator=name, M=packed.vals.shape[1], K=packed.ell_k, nb=packed.vals.shape[0],
            variants={v: dict(ms=[t[0] for t in ts], ms_l2_flushed=[t[1] for t in ts],
                              max_abs_err=errs[v], ptxas=ptxas[v],
                              constants=VARIANTS[v]) for v, ts in times.items()},
            rows_branch_ms=cs.time_ms(torch, rows_fn),
            rows_branch_ms_l2_flushed=cs.time_ms(torch, rows_fn, flush=flush),
            library_ms=cs.time_ms(torch, lambda: a_csr @ x),
            read_bytes=cs.k4b_read_bytes(torch, packed)["total"])), flush=True)
        del a_csr, packed, sell
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
