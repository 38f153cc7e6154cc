"""Run one cell of the port's benchmark on the card and print its result.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic, limits
and per-layer metrics are found by name from ``BENCHMARK.json`` (see
``benchmarks/harness.py``).  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(and traced, ``breakdown``), and last ``checks``, each compared number with
its limit.  Set-up parts come first, one ``# setup`` line each.

Exits non-zero and prints no result without as many CUDA devices as the
cell asks for, when a part of the run fails, or when the process holds
JAX, its libraries or the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmarks import harness

    t_start = harness.process_start_perf()
    # every build and kernel cache of the program stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    cell = harness.Cell(harness.manifest(ROOT), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    line = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start)
    found = harness.forbidden_loaded()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
