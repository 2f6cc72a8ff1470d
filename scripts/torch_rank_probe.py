#!/usr/bin/env python3
"""Time what ranks that share one CUDA card pay per step, as threads of one
process (``run_thread_ranks``) and as processes (``RankPool``).

    python3 scripts/torch_rank_probe.py

On a CUDA card, from the root of a checkout.  For P = 1 and 4 it times,
per step and per rank (the slowest rank's mean over ``STEPS`` steps): a
gloo all-reduce of one float on the card (staged through the host), the
same on the host, one host read of a value on the card, twenty elementwise
launches on 80,000 floats, and those twenty with a host read.  Prints one
JSON line per arrangement.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 300
CASES = ("all_reduce_card", "all_reduce_host", "read", "launches", "launches_read")


def probe(mesh, case: str) -> float:
    """ms per step of ``case`` on this rank (module level: the rank pool
    pickles it)."""
    import torch

    x = torch.ones(1, device=mesh.device)
    host = torch.ones(1)
    v = torch.ones(80_000, device=mesh.device)
    mesh.all_reduce_sum(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        if case == "all_reduce_card":
            mesh.all_reduce_sum(x)
        elif case == "all_reduce_host":
            mesh.group.allreduce([host]).wait()
        elif case == "read":
            float(x)
        else:
            for _ in range(20):
                v = v * 1.0000001
            if case == "launches_read":
                float(v[0])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / STEPS


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_rank_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stormx_torch.parallel.comm import RankPool, run_thread_ranks

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for parts in (1, 4):
        out = {c: max(run_thread_ranks(parts, lambda m, c=c: probe(m, c), device=dev))
               for c in CASES}
        print(json.dumps({"ranks": "threads", "parts": parts, "ms_per_step": out}), flush=True)
    with RankPool(4, device=dev) as pool:
        out = {c: max(pool.run(probe, c)) for c in CASES}
    print(json.dumps({"ranks": "processes", "parts": 4, "ms_per_step": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
