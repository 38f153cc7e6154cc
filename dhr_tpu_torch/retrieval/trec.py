"""TREC run-file and qrels I/O.

Port of ``dhr_tpu/retrieval/trec.py`` (the same formats, byte for byte):
- 6-column run lines ``qid Q0 docid rank score run_name``;
- qrels ``qid 0 docid rel`` (or ``qid docid rel``);
- shard-run merge: re-sort the union per query and cut to top-k.

The self-hit filter (drop docid == qid rows) is an option: it matters for
BEIR corpora where queries are drawn from the collection.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict


def write_run(
    path: str,
    results: dict[str, list[str]],
    scores: dict[str, list[float]],
    run_name: str = "dhr_tpu",
    filter_self_hit: bool = True,
) -> None:
    """Write a TREC run file from per-query ranked docid + score lists."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for qid, docids in results.items():
            rank = 0
            for docid, score in zip(docids, scores[qid]):
                if filter_self_hit and str(docid) == str(qid):
                    continue
                rank += 1
                f.write(f"{qid} Q0 {docid} {rank} {score} {run_name}\n")


def read_run(path: str) -> dict[str, dict[str, float]]:
    """Read a TREC run into {qid: {docid: score}}."""
    run: dict[str, dict[str, float]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _, docid, _, score = parts[:5]
            run[qid][docid] = float(score)
    return dict(run)


def read_qrels(path: str) -> dict[str, dict[str, int]]:
    """Read a qrels file (``qid 0 docid rel`` or ``qid docid rel``)."""
    qrels: dict[str, dict[str, int]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                qid, _, docid, rel = parts
            elif len(parts) == 3:
                qid, docid, rel = parts
            else:
                continue
            qrels[qid][docid] = int(float(rel))
    return dict(qrels)


def merge_runs(
    shard_paths: list[str] | str,
    out_path: str,
    topk: int = 1000,
    run_name: str = "dhr_tpu",
) -> None:
    """Merge per-shard TREC runs: union per query, re-sort, cut to top-k."""
    if isinstance(shard_paths, str):
        shard_paths = sorted(glob.glob(shard_paths))
    merged: dict[str, dict[str, float]] = defaultdict(dict)
    for p in shard_paths:
        for qid, docs in read_run(p).items():
            merged[qid].update(docs)
    with open(out_path, "w") as f:
        for qid in merged:
            ranked = sorted(merged[qid].items(), key=lambda kv: (-kv[1], kv[0]))
            for rank, (docid, score) in enumerate(ranked[:topk], start=1):
                f.write(f"{qid} Q0 {docid} {rank} {score} {run_name}\n")
