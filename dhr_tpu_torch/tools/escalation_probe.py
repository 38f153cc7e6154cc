"""Does two-tier escalation's margin separate good queries from bad ones?

Port of ``tools/escalation_probe.py`` on the port's ``Searcher``, over the
bench generator (``retrieval/synth.py``, trained-rep statistics), scaled
like the original probe: 204,800 rows, top ``k = 1000 * rows / 1.6384M``
(125), a full pool of 10k (1,250) and small pools of 4k (500) and 2k
(250).  For each small pool, ``Searcher.calibrate_escalation`` runs both
tiers on every query and finds the margin that escalates the queries
holding 95% of the rows the small pool misses.

The margins separate when the calibrated margin escalates a small share
of the queries while recovering nearly all the missing-row mass.

Runs on the GPU; ``--device cpu`` runs the plain path.  Prints one JSON
object (the JAX tool's keys).

Usage: python -m dhr_tpu_torch.tools.escalation_probe [--rows N]
           [--queries Q] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_ROWS = 204_800
N_QUERIES = 256
LEX_DIM = 768
REF_ROWS = 1_638_400  # the corpus a top-1000 was scaled down from


def probe(n_rows=N_ROWS, n_queries=N_QUERIES, device=None) -> dict:
    from dhr_tpu_torch.retrieval import DeviceIndex
    from dhr_tpu_torch.retrieval.searcher import SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import (
        SynthConfig, synth_index_planes, synth_reps)

    topk = max(round(1000 * n_rows / REF_ROWS), 1)
    full_pool = 10 * topk
    t0 = time.time()
    v_i8, folds, scales, _ = synth_index_planes(0, n_rows, SynthConfig(),
                                                device=device)
    docids = np.arange(n_rows).astype(str).astype(object)
    idx = DeviceIndex.from_arrays(v_i8, folds, docids, lex_dim=LEX_DIM,
                                  value_scales=scales, device=device)
    del v_i8, folds
    qv, qf, _ = synth_reps(0, n_queries, SynthConfig(), "query", stream=1,
                           device=device)
    print(f"index+queries built in {time.time() - t0:.1f}s", file=sys.stderr)

    report = {"n_rows": n_rows, "topk": topk, "full_pool": full_pool,
              "n_queries": n_queries,
              "distribution": "trained-rep (synth.py)"}
    for pool in (4 * topk, 2 * topk):
        cfg = SearchConfig(
            topk=topk, theta=0.3, rerank=True, agip_topk=full_pool,
            max_important_dims=48, query_batch=64,
            escalate_pool=pool, escalate_margin=0.0,
        )
        s = Searcher(idx, cfg, device=device)
        t0 = time.time()
        cal = s.calibrate_escalation(qv, qf, miss_mass_target=0.95)
        cal["calibrate_s"] = round(time.time() - t0, 1)
        report[f"pool_{pool}"] = cal
        print(f"pool={pool}: {json.dumps(cal)}", file=sys.stderr)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=N_ROWS)
    ap.add_argument("--queries", type=int, default=N_QUERIES)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain path; default the GPU")
    args = ap.parse_args(argv)
    report = probe(args.rows, args.queries, args.device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
