"""Run one cell of the benchmark of ``stormx_torch`` once, on the card:

    python3 portbench/run.py --workload W --seed S --seconds T --trace 0|1

Prints the numbers that ``correct`` compared, each with its limit, as the
last lines of standard error, and the result as one JSON object on the last
line of standard output.  Exits non-zero, with no result, where there is no
CUDA card (or fewer than the cell asks for), where the profiler lost kernel
records, or where JAX or the JAX package is loaded once the window closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Every build and kernel cache at a fixed path inside the checkout (the
    # port's own nvcc builds go to build/stormx_torch/ and its host library
    # next to its source).
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness

    try:
        bench = harness.Bench(ROOT)
        chips = bench.cell(args.workload)["chips"]
    except (OSError, ValueError, harness.RunError) as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def age() -> float:
        a = harness.process_age()
        return a if a is not None else time.perf_counter() - _T0

    try:
        result, compared = harness.run_cell(args.workload, args.seed, args.seconds,
                                            bool(args.trace), device="cuda:0", bench=bench,
                                            age=age)
    except harness.RunError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
