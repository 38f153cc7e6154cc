"""An open-loop HTTP load generator (standard library only): one-query
``/search_text`` requests at Poisson arrivals, each timed from when it was
due to be sent.  Every seed sends the same number of requests with the
same gaps between them, in its own order (``schedule``).

It reads one JSON plan on standard input::

    {"port": 8080, "rate": 40.0, "seconds": 10, "seed": 1,
     "texts": ["..."], "checked": [3, 17], "warmup_s": 2.0,
     "drain_s": 60}

runs a warm-up at the same rate (not recorded), prints ``READY``, waits
for a line on standard input, then runs the measured schedule and prints
one JSON line: every request's ``[due, sent, done, status]`` in seconds
from the schedule's start (``done`` null and status 0 where the request
never completed), and the returned rows and scores of the ``checked``
request numbers.  Request ``i`` sends ``texts[i % len(texts)]``.
"""

from __future__ import annotations

import http.client
import json
import random
import sys
import threading
import time


def schedule(rate: float, seconds: float, seed: int) -> list[float]:
    """Due times of Poisson arrivals at ``rate`` over ``seconds``: one set
    of exponential gaps for the rate and length (drawn from a fixed
    stream), put in an order drawn from ``seed``, so that every seed offers
    the same number of requests with the same gaps."""
    r = random.Random(f"gaps {rate!r} {seconds!r}")
    gaps, total = [], 0.0
    while True:
        g = r.expovariate(rate)
        if total + g >= seconds:
            break
        gaps.append(g)
        total += g
    random.Random(seed).shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g
        out.append(t)
    return out


def one(port: int, text: str, i: int, keep: bool, rec: list, hits: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        body = json.dumps({"queries": [text], "qids": [str(i)]})
        conn.request("POST", "/search_text", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        rec[3] = resp.status
        if resp.status == 200 and keep:
            got = json.loads(data)
            hits[i] = {"rows": got["results"][str(i)],
                       "scores": got["scores"][str(i)]}
    except (OSError, http.client.HTTPException, ValueError, KeyError):
        rec[3] = 0
    finally:
        conn.close()


def run(plan: dict, dues: list[float], keep: set, drain_s: float):
    texts, port = plan["texts"], plan["port"]
    recs = [[d, None, None, 0] for d in dues]
    hits: dict = {}
    threads = []
    t0 = time.perf_counter()

    def task(i):
        rec = recs[i]
        rec[1] = time.perf_counter() - t0
        one(port, texts[i % len(texts)], i, i in keep, rec, hits)
        rec[2] = time.perf_counter() - t0 if rec[3] else None

    for i, due in enumerate(dues):
        wait = due - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=task, args=(i,), daemon=True)
        th.start()
        threads.append(th)
    end = time.perf_counter() + drain_s
    for th in threads:
        th.join(timeout=max(end - time.perf_counter(), 0.0))
    for rec in recs:   # a request still open past the drain never came
        if rec[2] is None:
            rec[3] = 0
    return recs, hits


def main() -> int:
    plan = json.loads(sys.stdin.readline())
    rate, seed = float(plan["rate"]), int(plan["seed"])
    if plan.get("warmup_s", 0) > 0:
        run(plan, schedule(rate, plan["warmup_s"], seed + 1), set(), 60.0)
    print("READY", flush=True)
    sys.stdin.readline()
    recs, hits = run(plan, schedule(rate, plan["seconds"], seed),
                     set(plan.get("checked", [])), plan.get("drain_s", 60))
    print(json.dumps({"requests": recs, "hits": hits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
