"""Run one cell of the benchmark once:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the check's numbers beside their limits as the last lines of
standard error and the result as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the device's busy time and top operations. Exits
with a nonzero code and prints no result without the card(s), or where
JAX or the JAX package was loaded."""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The bytecode of every module this process imports, torch's too, is kept
# in the checkout: where the installed packages come without theirs, each
# process would compile torch anew, some 8 s of its set-up
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402

sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    marks = [("torch", time.perf_counter())]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    marks.append(("card", time.perf_counter()))
    from benchmark import harness

    marks.append(("harness", time.perf_counter()))
    cell = harness.Cell(args.workload)
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda"), T_START, marks=marks)
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(harness.FORBIDDEN))
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
