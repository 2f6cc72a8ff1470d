"""CG's loop as replays of a captured CUDA graph against the eager loop, on
the card, in cells of the port's benchmark.

    python3 scripts/torch_cg_graphs.py [--cells ch_march,dia_cg] \
        [--blocks 8,16,32,64] [--rounds 2] [--seed 2718281828] \
        [--out build/cg_graphs.jsonl]

Each cell is built and warmed as ``portbench/harness.py`` builds it.  Then,
in ``--rounds`` rounds, the eager loop (``solvers/base._engages`` patched
off) and the graph path at each block size of ``--blocks``
(``base.BLOCK_ITERATIONS`` patched) each run cycle 0 of the cell's traffic,
the same work every time: host ms a unit (a step or a solve, each ending in a
synchronise), iterations, frozen iterations, replays, the host ms of the
captures, and whether every unit's answer equals the eager loop's bit for
bit.  Last, one traced cycle at the module's own block size through the
benchmark's tracing: the launch counters against the kernels of the trace
(``harness.lost_records``), the card's busy share, device operations and
reads a Krylov iteration.  One JSON line per measurement, to stdout and to
``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(out, **entry) -> None:
    line = json.dumps(entry)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def run_cycle(system, torch):
    """Cycle 0 of the traffic: (host seconds of each unit, iterations of
    each, the answers)."""
    system.begin_cycle(0)
    times, its, answers = [], [], []
    for _ in range(system.cycle_len):
        t0 = time.perf_counter()
        _, answer, n, converged = system.solve_next()
        times.append(time.perf_counter() - t0)
        its.append(n)
        answers.append(answer[-1].clone())
        if not converged:
            raise RuntimeError("a unit did not converge")
    torch.cuda.synchronize()
    return times, its, answers


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="ch_march,dia_cg")
    p.add_argument("--blocks", default="8,16,32,64")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--out", default="build/cg_graphs.jsonl")
    args = p.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness
    from portbench import trace as tracing
    from stormx_torch.solvers import base

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dev = torch.device("cuda:0")
    bench = harness.Bench(ROOT)
    blocks = [int(k) for k in args.blocks.split(",")]
    own_block, engages = base.BLOCK_ITERATIONS, base._engages
    capture = base._capture
    capture_s = []

    def timed_capture(*a, **kw):
        t0 = time.perf_counter()
        try:
            return capture(*a, **kw)
        finally:
            capture_s.append(time.perf_counter() - t0)

    base._capture = timed_capture
    with open(args.out, "a") as out:
        emit(out, card=torch.cuda.get_device_name(dev), power_limit=harness.power_limit(),
             torch=torch.__version__, cuda=torch.version.cuda, blocks=blocks,
             own_block=own_block)
        for workload in args.cells.split(","):
            cell = harness.Cell(bench, workload, dev)
            system = cell.program()
            system.load(cell.inputs(args.seed))
            harness.warm(system)
            reference = None
            variants = ["eager"] + blocks
            for rnd in range(args.rounds):
                for variant in variants if rnd % 2 == 0 else variants[::-1]:
                    base.BLOCK_ITERATIONS = own_block if variant == "eager" else variant
                    base._engages = (lambda x0: False) if variant == "eager" else engages
                    stats = dict(base.graph_stats)
                    capture_s.clear()
                    times, its, answers = run_cycle(system, torch)
                    if reference is None:
                        reference = answers
                    same = all(torch.equal(a.flatten().view(torch.uint8),
                                           b.flatten().view(torch.uint8))
                               for a, b in zip(answers, reference))
                    emit(out, cell=workload, round=rnd, variant=variant,
                         unit_ms=[1e3 * t for t in times], mean_unit_ms=1e3 * sum(times)
                         / len(times), iterations=its,
                         ms_per_iteration=1e3 * sum(times) / sum(its),
                         capture_ms=[1e3 * t for t in capture_s],
                         graph=dict((k, base.graph_stats[k] - stats[k]) for k in stats),
                         bit_identical_to_first=same)
            base.BLOCK_ITERATIONS = own_block
            base._engages = engages
            # One traced cycle as the benchmark traces it.
            system.traced = True
            tracing.profile(lambda: run_cycle(system, torch), dev)  # a first session loses records
            for attempt in range(3):
                before = system.counters()
                stats = dict(base.graph_stats)
                (times, its, _), events = tracing.profile(lambda: run_cycle(system, torch), dev)
                after = system.counters()
                reduced = tracing.reduce(events)
                lost = harness.lost_records(reduced, bench.kernels(), before, after)
                emit(out, cell=workload, traced_attempt=attempt, lost=lost,
                     counted={k: after[k] - before[k] for k in after},
                     iterations=sum(its), window_s=reduced.window_s, busy_s=reduced.busy_s(),
                     idle_share=1.0 - reduced.busy_s() / reduced.window_s,
                     ops_per_iteration=len(reduced.ops) / sum(its),
                     dtoh_per_iteration=sum(1 for o in reduced.ops if "DtoH" in o.name)
                     / sum(its),
                     graph=dict((k, base.graph_stats[k] - stats[k]) for k in stats),
                     top_ops=reduced.device_ops()[:6], idle_gaps=reduced.idle_gaps()[:4])
                if not lost:
                    break
            system.traced = False
            system.free()
            del system
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
