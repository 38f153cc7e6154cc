"""Find the highest request rate the online text service sustains: one
process and one set-up (the ``online_text`` driver's), then the load
generator at each rate in turn, ascending.

    python3 benchmarks/tools/sweep_online.py --workload msmarco-online-text \
        --seed 1 --seconds 10 --rates 10 20 30 40 50 60 80 100

For each rate: requests sent, answered, failed; p50 and p95 from when each
was due; the answered rate; how late the generator ran; and the backlog's
trend, the mean latency of the last quarter of the requests over that of
the first.  A rate is sustained while nothing fails, the answered rate keeps
up with the offered one and the trend stays under 1.5.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the online cell, not in BENCHMARK.json yet (PERF.md, Open questions): its
# manifest entries, which this sweep, the control and the tests add
ONLINE_WORKLOAD = {
    "name": "msmarco-online-text", "config": "dhr-distilbert-msmarco",
    "traffic": "online-text", "chips": 1,
    "why": "one-query /search_text requests, top 1000, Poisson at 0.8 of "
           "the knee over the 8.8M-row index: HTTP, JSON, the encoder lock "
           "and micro-batches of a few queries"}
ONLINE_END_TO_END = [
    {"name": "query_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": ["msmarco-online-text"]}]
ONLINE_PER_LAYER = [
    {"name": "online.batch_queries", "unit": "queries", "better": "higher",
     "source": "program_counter", "layer": "micro-batcher",
     "moves": "query_p95_ms", "workloads": ["msmarco-online-text"]},
    {"name": "idle_pct.online", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device", "moves": "query_p95_ms",
     "workloads": ["msmarco-online-text"]}]


def with_online_cell(spec: dict) -> dict:
    """A copy of the manifest ``spec`` with the online cell's entries."""
    out = json.loads(json.dumps(spec))
    if ONLINE_WORKLOAD["name"] not in {w["name"] for w in out["workloads"]}:
        out["workloads"].append(dict(ONLINE_WORKLOAD))
        out["end_to_end"] = ONLINE_END_TO_END + out["end_to_end"]
        out["per_layer"] += ONLINE_PER_LAYER
    return out


def summarize(rate: float, report: dict) -> dict:
    from benchmarks.drivers.online_text import latencies_ms, p95

    lat = latencies_ms(report)
    ok = [x for x in lat if x != float("inf")]
    reqs = report["requests"]
    done = [r[2] for r in reqs if r[2] is not None]
    span = max(done) - min(r[0] for r in reqs) if done else 0.0
    q = max(len(ok) // 4, 1)
    trend = (statistics.mean(ok[-q:]) / statistics.mean(ok[:q])
             if len(ok) >= 8 else float("inf"))
    late = [(r[1] - r[0]) * 1e3 for r in reqs if r[1] is not None]
    return {"rate": rate, "sent": len(reqs), "answered": len(ok),
            "failed": len(lat) - len(ok),
            "p50_ms": statistics.median(ok) if ok else None,
            "p95_ms": p95(lat), "answered_per_s": len(ok) / span if span
            else 0.0, "late_ms_p95": p95(late) if late else None,
            "late_ms_max": max(late, default=None), "trend": trend,
            "sustained": bool(ok) and len(ok) == len(lat) and trend < 1.5}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="msmarco-online-text")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", nargs="+", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmarks import harness

    cell = harness.Cell(with_online_cell(harness.manifest(ROOT)),
                        args.workload)
    ctx = harness.Ctx(cell, args.seed, args.seconds, False, "cuda",
                      harness.process_start_perf(), out=sys.stderr)
    on = harness.load_driver(cell.driver, cell.bench).Online(ctx)
    rows = []
    try:
        for k, rate in enumerate(args.rates):
            t0 = time.perf_counter()
            rep = on.drive(rate, args.seconds, args.seed + k, warmup_s=1.0)
            row = summarize(rate, rep)
            row["wall_s"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        on.close()
    knee = max((r["rate"] for r in rows if r["sustained"]), default=None)
    print("KNEE " + json.dumps({"knee_per_s": knee, "at_0.8": knee and
                                0.8 * knee}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
