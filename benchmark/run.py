"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
the numbers compared with their limits); the last lines of standard error
repeat those numbers.  Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded in this process once the
run is over, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# JAX and the JAX package, by whole top-level module name (the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "joint_tensorf_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    import torch

    # one host thread for PyTorch's CPU ops: the program's host work is one
    # Python thread, and idle worker threads only take cores from it
    torch.set_num_threads(1)
    from . import spec
    cell = spec.cell(root, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from . import harness
    result = harness.run(root, args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded in the measured process: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
