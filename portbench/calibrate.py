"""The readings that a cell's limits are set from, in one process on the card:

    python3 portbench/calibrate.py --workload W --seeds 101,102,... \
        [--control-seeds 201,202,203] [--seconds 5] [--out FILE]

For each program seed: the cell's inputs, one warm-up unit, a window of
``--seconds`` in whole cycles and the reference's check of all its
answers, as a run does (the cell is built once).  For each control seed:
the control, the reference in the program's place one precision below the
configuration's, for one cycle, judged the same way.  One JSON line per seed, on standard output and in ``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out")
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness

    out = open(args.out, "a") if args.out else None

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    t0 = time.perf_counter()
    cell = harness.Cell(harness.Bench(ROOT), args.workload, args.device)
    emit(workload=args.workload, fixed_s=time.perf_counter() - t0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        if not seed_list:
            continue
        t0 = time.perf_counter()
        system = cell.program() if side == "program" else cell.control()
        emit(side=side, build_s=time.perf_counter() - t0)
        for seed in seed_list:
            inputs = cell.inputs(seed)
            system.load(inputs)
            harness.warm(system)
            keeper = harness.Keeper(seed, 1)
            keeper.cap = 1 << 30
            records, window_s = harness.measure(
                system, args.seconds if side == "program" else 0.0, keeper)
            samples = [(key, tuple(system.to_input(t) for t in answer))
                       for key, answer in keeper.kept]
            keeper.kept.clear()
            t0 = time.perf_counter()
            compared, correct = cell.judge(inputs, records, samples)
            emit(side=side, seed=seed, correct=correct,
                 numbers={n: v for n, v, _ in compared}, units=len(records),
                 iterations=[r[1] for r in records[:system.cycle_len]],
                 solve_ms=1e3 * window_s / len(records), check_s=time.perf_counter() - t0,
                 device=torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu")
        system.free()
        del system
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
