#!/usr/bin/env python3
"""Host time of one K1 launch through ``sell_spmv_cuda`` on one CUDA card.

    python3 scripts/torch_k1_host.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``stormx_torch`` is imported (this one
by default), so two commits can be compared in one run on one card: unpack
the other with ``git archive`` into a directory ``.gitignore`` lists and run
this script once with each root, in turns.

For each of K1's shapes on the smoke's main path (the Cahn–Hilliard
operator's 2,488 row blocks of K = 10 slots and R = 128 rows, the
Laplacian's 2,488 × 4 × 128, a slab's 156 × 4 × 512), with random values
and window-local columns, it times ``CALLS`` calls back to back with no
synchronisation between them: the card queues them faster than it runs
them, so the wall time over ``CALLS`` is the host's time a call (the
argument checks, the branch and geometry lookups, the allocation of y, the
launch).  Median of ``REPEATS`` runs; one JSON line per shape, then the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 400  # under the card's queue of pending launches
REPEATS = 15
# name -> (nb, K, R, window C, pad_lo)
SHAPES = {"ch": (2488, 10, 128, 2816, 1334),
          "laplacian": (2488, 4, 128, 1408, 640),
          "slab": (156, 4, 512, 2048, 0)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="the checkout to import stormx_torch from")
    parser.add_argument("--label", default="", help="a name printed with each line")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_host: no CUDA device is available", file=sys.stderr)
        return 2
    from stormx_torch.ops import _cuda, sell_spmv
    from stormx_torch.sparse.windowed import SlicedELL

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _cuda.build(["sell_spmv"])
    gen = torch.Generator(device="cpu").manual_seed(0)
    for name, (nb, K, R, C, pad_lo) in SHAPES.items():
        n_rows, n_cols = nb * R, (nb - 1) * R + C - pad_lo
        op = SlicedELL(data=torch.randn(nb, K, R, generator=gen).to(dev),
                       local_cols=torch.randint(0, C, (nb, K, R), generator=gen,
                                                dtype=torch.int32).to(dev),
                       shape=(n_rows, n_cols), window=C, pad_lo=pad_lo, mode="cuda",
                       dense_blocks=None)
        x = torch.randn(n_cols, generator=gen).to(dev)
        for _ in range(20):
            sell_spmv.sell_spmv_cuda(op, x)
        runs = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                sell_spmv.sell_spmv_cuda(op, x)
            runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
        branch = sell_spmv.branch_of(op) if hasattr(sell_spmv, "branch_of") else "rows"
        print(json.dumps(dict(label=args.label, root=os.path.abspath(args.root), shape=name,
                              nb=nb, K=K, R=R, branch=branch, calls=CALLS,
                              host_us_per_call=statistics.median(runs),
                              host_us_min=min(runs), host_us_max=max(runs))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
