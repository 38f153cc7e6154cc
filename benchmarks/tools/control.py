"""Run a cell's control: the plain reference computed one precision step
below the configuration's, put in the program's place, and compared as the
program's outputs are.  A sound limit fails it.  With ``--fault``, the f32
reference with that fault planted stands in the program's place instead.

    python3 benchmarks/tools/control.py --workload <cell> --seeds 1 2 3 \
        [--out chiprun_out/<file>.jsonl]

One process for every seed; each seed's compared numbers are printed (and
appended to ``--out``) with the cell's limits beside them.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_control(workload: str, seed: int, device: str = "cuda",
                cell=None, fault: str | None = None) -> dict:
    sys.path.insert(0, str(ROOT))
    from benchmarks import harness
    from benchmarks.tools.sweep_online import with_online_cell

    spec = with_online_cell(harness.manifest(ROOT))
    cell = cell or harness.Cell(spec, workload)
    ctx = harness.Ctx(cell, seed, spec["run_seconds"], False, device,
                      time.perf_counter(), out=sys.stderr)
    driver = harness.load_driver(cell.driver, cell.bench)
    if fault is None:
        driver.control(ctx)
    else:
        driver.control(ctx, fault=fault)
    return {"workload": cell.name, "seed": seed, "fault": fault,
            "checks": ctx.checks,
            "fails": not all(c["ok"] for c in ctx.checks.values())}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--fault", default=None,
                   help="a fault planted in the reference put in the "
                        "program's place (train: half_batch, token_altered)")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    for s in args.seeds:
        rec = run_control(args.workload, s, fault=args.fault)
        print(json.dumps(rec), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
