"""Recall@k of the index compression modes against exact GIP.

Port of ``tools/recall_table.py`` on the port's ``Searcher``: the int8 /
PQ64 / bf16 comparison table over a clustered synthetic corpus (each
query's exact top-k is its cluster, a ranking a good approximation should
recover), candidates from each compressed representation, exact-GIP
rerank on top, recall measured against the exact f32 GIP top-k.

Runs on the GPU; ``--device cpu`` runs the plain path.  Prints one JSON
object (the JAX tool's keys).

Usage: python -m dhr_tpu_torch.tools.recall_table [--rows N]
           [--queries Q] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def clustered_world(rows, queries, lex, cls, seed=0):
    """``(packed f16 index, query values, query folds)``: rows are noisy
    copies of ``max(rows // 100, 8)`` cluster prototypes (10% of folds
    flipped), queries the prototypes of distinct clusters."""
    from dhr_tpu_torch.retrieval import PackedIndex

    rng = np.random.default_rng(seed)
    n_clusters = max(rows // 100, 8)
    proto_lex = np.exp(-3.0 * rng.random((n_clusters, lex), np.float32))
    proto_cls = (rng.standard_normal((n_clusters, cls)) * 0.5).astype(
        np.float32)
    proto_idx = rng.integers(0, 39, (n_clusters, lex))
    member = rng.integers(0, n_clusters, rows)
    lex_v = proto_lex[member] * rng.uniform(0.7, 1.3, (rows, lex))
    cls_v = proto_cls[member] + rng.standard_normal(
        (rows, cls)).astype(np.float32) * 0.1
    indices = proto_idx[member]
    flip = rng.random((rows, lex)) < 0.1
    indices = np.where(flip, rng.integers(0, 39, indices.shape),
                       indices).astype(np.uint8)
    values = np.concatenate([lex_v, cls_v], axis=1).astype(np.float16)
    docids = np.asarray([str(i) for i in range(rows)], dtype=object)
    packed = PackedIndex(values, indices, docids, lex_dim=lex)

    q_cluster = rng.choice(n_clusters, queries, replace=False)
    qlex = proto_lex[q_cluster] * rng.uniform(0.8, 1.2, (queries, lex))
    qcls = proto_cls[q_cluster] + rng.standard_normal((queries, cls)) * 0.05
    qv = np.concatenate([qlex, qcls], axis=1).astype(np.float32)
    qi = proto_idx[q_cluster].astype(np.int32)
    return packed, qv, qi


def recall_table(args) -> dict:
    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher

    packed, qv, qi = clustered_world(args.rows, args.queries, args.lex,
                                     args.cls)

    def run(packed_idx, mode, value_dtype=None, theta=0.0,
            approx=False, slices=1):
        searcher = Searcher(
            DeviceIndex.from_packed(packed_idx, value_dtype=value_dtype,
                                    device=args.device),
            SearchConfig(
                topk=args.topk, mode=mode, theta=theta, rerank=True,
                agip_topk=min(args.agip_topk, args.rows),
                max_important_dims=48,
                query_batch=args.queries, approx_candidates=approx,
                candidate_slices=slices,
            ),
            device=args.device,
        )
        _, rows = searcher.search(qv, qi)
        return np.asarray(rows)

    # exact baseline: brute-force GIP in f32
    exact_rows = run(packed, "gip", value_dtype=torch.float32, theta=0.0)

    pq_name = f"PQ{args.pq_m} codes (stage 1)"
    bytes_per_row = {
        "f16/bf16 planes": args.lex + args.cls * 2 + args.lex,  # v + i u8
        "int8 planes": args.lex + args.cls + args.lex,
        pq_name: args.pq_m,
    }
    # stratified rows: the selection is exact per slice, so these isolate
    # the slice-edge effect of the serving default
    bytes_per_row["int8 + stratified S=8 candidates"] = (
        bytes_per_row["int8 planes"])
    configs = {
        "f16/bf16 planes": lambda: run(packed, "gip", theta=0.3),
        "int8 planes": lambda: run(packed.quantize(), "gip", theta=0.3),
        "int8 + stratified S=8 candidates": lambda: run(
            packed.quantize(), "gip", theta=0.3, approx=True, slices=8),
        pq_name: lambda: run(
            packed.quantize_pq(m=args.pq_m, iters=15, device=args.device),
            "pq"),
    }
    table = {}
    for name, fn in configs.items():
        rows = fn()
        recall = np.mean([
            len(set(rows[b]) & set(exact_rows[b])) / args.topk
            for b in range(args.queries)
        ])
        table[name] = {
            "recall_at_k_vs_exact": round(float(recall), 4),
            "candidate_bytes_per_row": bytes_per_row[name],
        }
        print(f"{name:28s} recall@{args.topk} = {recall:.4f}  "
              f"({bytes_per_row[name]} B/row stage-1 reads)", file=sys.stderr)
    return {
        "rows": args.rows, "queries": args.queries, "topk": args.topk,
        "operating_point": "theta=0.3+rerank (gip) / ADC+rerank (pq)",
        "modes": table,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--lex", type=int, default=768)
    ap.add_argument("--cls", type=int, default=128)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--agip-topk", type=int, default=1000)
    ap.add_argument("--pq-m", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain path; default the GPU")
    report = recall_table(ap.parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
