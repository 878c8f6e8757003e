"""Run one cell of the port's benchmark once.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the numbers compared and their limits are also the last lines of
standard error. Without CUDA, or with fewer cards than the cell asks for,
it exits with 2 and prints no result; with a module of the JAX package or
of JAX itself loaded once the window has closed, with 3.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import harness

    started = time.perf_counter() - harness.process_age_s()
    cells = {c["name"]: c for c in harness.spec()["workloads"]}
    if args.workload not in cells:
        print(f"perfbench: unknown workload {args.workload!r}; known: "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.run_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace), process_start=started)
    return 0


if __name__ == "__main__":
    sys.exit(main())
