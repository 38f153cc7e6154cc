"""Run one cell several times, one process a run, and summarize: each run's
result line, and for each end-to-end metric the median and the quartile
spread ((Q3 - Q1) / median, ``statistics.quantiles``) of every set.

    python3 benchmarks/tools/runs.py --workload <cell> --seconds 10 \
        --set 11 12 13 14 15 16 --set 11 12 13 14 15 16 [--trace 21 22 23] \
        [--out chiprun_out/<file>.jsonl]

Runs go in order: each ``--set`` in turn, then the traced seeds.  A run that
fails or prints no result is recorded with its exit code and the end of its
standard error.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(workload: str, seed: int, seconds: float, trace: int,
        timeout: float) -> dict:
    cmd = [sys.executable, str(ROOT / "benchmarks" / "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        err = err if isinstance(err, str) else err.decode(errors="replace")
    rec = {"seed": seed, "trace": trace, "rc": rc,
           "wall_s": time.perf_counter() - t0,
           "notes": [ln for ln in out.splitlines() if ln.startswith("# ")]}
    lines = out.strip().splitlines()
    if rc == 0 and lines:
        try:
            rec["result"] = json.loads(lines[-1])
        except json.JSONDecodeError:
            pass
    if "result" not in rec:
        rec["stderr_tail"] = err[-4000:]
        rec["stdout_tail"] = out[-2000:]
    return rec


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--set", nargs="+", type=int, action="append",
                   default=[])
    p.add_argument("--trace", nargs="*", type=int, default=[])
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    recs, sets = [], []
    for i, seeds in enumerate(args.set):
        this = []
        for s in seeds:
            r = one(args.workload, s, args.seconds, 0, args.timeout)
            r["set"] = i
            recs.append(r)
            this.append(r)
            print(json.dumps(r), flush=True)
        sets.append(this)
    for s in args.trace:
        r = one(args.workload, s, args.seconds, 1, args.timeout)
        recs.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seconds": args.seconds, "sets": []}
    for this in sets:
        ok = [r["result"] for r in this if "result" in r]
        metrics = {}
        for name in (ok[0]["metrics"] if ok else {}):
            vals = [r["metrics"][name]["value"] for r in ok]
            metrics[name] = {"median": statistics.median(vals),
                             "spread": spread(vals), "values": vals}
        summary["sets"].append({
            "runs": len(this), "ok": len(ok),
            "correct": sum(bool(r["correct"]) for r in ok),
            "metrics": metrics})
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
