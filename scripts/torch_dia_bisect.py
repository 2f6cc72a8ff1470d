#!/usr/bin/env python3
"""Split the banded SpMV's (K2a's) bandwidth by stream on one CUDA card.

    python3 scripts/torch_dia_bisect.py

The port's counterpart of ``scripts/perf_pallas_bisect.py``.  It times the
four modes of the stream probe P2 (``stormx_torch.ops.probes``):
``full`` (five diagonals, x and z: the whole SpMV), ``diag`` (the diagonals
and z), ``win`` (x and z) and ``zonly`` (z alone), each against its plain
version, and K2a (``dia_spmv``) on the 5-point Poisson operator of the same
length, warm and with the 50 MB L2 flushed.  It prints one JSON line per
mode with its ms and GB/s (the bytes the mode must move over its time),
then the card's ``nvidia-smi`` name and power limit.  The length is
4,194,304 rows, the 2048² operator of ``chip_smoke.py``'s banded path.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dia_bisect: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import NX, P2_ROWS, nvidia_smi, poisson5_diags, time_ms
    from stormx_torch.ops import dia, probes
    from stormx_torch.sparse.formats import DIA

    dev = torch.device("cuda", 0)
    n = P2_ROWS
    gen = torch.Generator(device="cpu").manual_seed(0)
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=torch.float32, device=dev)  # 128 MB > L2
    diag = torch.randn((probes.N_DIAGS, n), generator=gen).to(dev)
    xs = torch.randn(n + probes.X_HALO, generator=gen).to(dev)
    for mode in probes.STREAM_MODES:
        z = probes.dia_stream_probe_cuda(mode, 0.3125, xs, diag)
        exact = bool(torch.equal(z, probes.dia_stream_probe_plain(mode, 0.3125, xs, diag)))
        nbytes = probes.stream_bytes(mode, n)
        ms = time_ms(torch, lambda: probes.dia_stream_probe_cuda(mode, 0.3125, xs, diag))
        ms_fl = time_ms(torch, lambda: probes.dia_stream_probe_cuda(mode, 0.3125, xs, diag),
                        flush=flush)
        print(json.dumps(dict(kernel="P2", mode=mode, rows=n, bytes=nbytes, bit_exact=exact,
                              ms=ms, ms_l2_flushed=ms_fl, gb_per_s=nbytes / ms / 1e6,
                              gb_per_s_l2_flushed=nbytes / ms_fl / 1e6)), flush=True)
    offsets, data = poisson5_diags(NX)
    op = DIA(data=torch.as_tensor(data, device=dev), offsets=offsets, shape=(n, n))
    x = xs[:n].contiguous()
    nbytes = 4 * (len(offsets) + 2) * n
    ms = time_ms(torch, lambda: dia.dia_spmv_cuda(op, x))
    ms_fl = time_ms(torch, lambda: dia.dia_spmv_cuda(op, x), flush=flush)
    print(json.dumps(dict(kernel="K2a", offsets=list(offsets), rows=n, bytes=nbytes, ms=ms,
                          ms_l2_flushed=ms_fl, gb_per_s=nbytes / ms / 1e6,
                          gb_per_s_l2_flushed=nbytes / ms_fl / 1e6)), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
