"""Ranking metrics.

The port's own copy of ``dhr_tpu/eval/metrics.py`` (same functions, same
numbers; the port imports nothing of ``dhr_tpu``).  Two families, matching
the reference's two evaluators:

- Run-based (dict of qid -> ranked docids with scores): MRR@k, recall@k,
  R_cap@k, hole@k, top-k accuracy, nDCG@k — semantics parity with
  ``retrieval/evaluation/custom_metrics.py:5-118`` (BEIR-style) and
  ``pyserini.eval.trec_eval`` operating points used in the docs.
- Array-based (per-query candidate relevance lists): MAP, R-Precision,
  nDCG, MRR, MRR@10 — parity with ``tevatron/utils/metrics.py:4-92``
  (used by the rerank evaluator).

All functions are pure NumPy: evaluation is a host-side post-process, never
on the device hot path.
"""

from __future__ import annotations

import math
from collections.abc import Mapping, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Run-based metrics.  qrels: {qid: {docid: rel}}, run: {qid: {docid: score}}.
# --------------------------------------------------------------------------


def _ranked_docs(run: Mapping[str, Mapping[str, float]], qid: str, k: int):
    docs = run.get(qid, {})
    return sorted(docs.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def mrr_at_k(qrels, run, k: int = 10) -> float:
    """Mean reciprocal rank at cutoff k over queries present in qrels."""
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        n += 1
        relevant = {d for d, r in rels.items() if r > 0}
        for rank, (docid, _) in enumerate(_ranked_docs(run, qid, k), start=1):
            if docid in relevant:
                total += 1.0 / rank
                break
    return total / max(n, 1)


def zero_positive_queries(qrels) -> int:
    """Count qrels entries with no positive judgment.  On such queries our
    recall metrics contribute 0 where the reference (and BEIR's published
    convention) raise ZeroDivisionError — report this count next to
    recall numbers so cross-paper comparisons are checkable."""
    return sum(
        1 for rels in qrels.values()
        if not any(r > 0 for r in rels.values())
    )


def _check_strict(qrels, strict: bool, what: str):
    if strict:
        n = zero_positive_queries(qrels)
        if n:
            raise ValueError(
                f"{what}: {n} qrels queries have no positive judgment; "
                "the reference's convention (custom_metrics.py:53-58) is "
                "undefined there (ZeroDivisionError). Pass strict=False "
                "to count them as 0 (our documented deviation)."
            )


def recall_at_k(qrels, run, k: int = 1000, strict: bool = False) -> float:
    """Macro-averaged recall at k (fraction of relevant docs retrieved).

    Averaged over ``len(qrels)`` queries, matching the reference's
    ``custom_metrics.py:53-56`` denominator convention; queries with no
    positive qrels contribute 0 (the reference's recall_cap would divide by
    zero there — deliberate deviation).  ``strict=True`` raises instead
    when such queries exist, making BEIR-convention comparisons safe;
    :func:`zero_positive_queries` reports the affected count.
    """
    _check_strict(qrels, strict, "recall_at_k")
    total = 0.0
    for qid, rels in qrels.items():
        relevant = {d for d, r in rels.items() if r > 0}
        if not relevant:
            continue
        got = {d for d, _ in _ranked_docs(run, qid, k)}
        total += len(got & relevant) / len(relevant)
    return total / max(len(qrels), 1)


def recall_cap_at_k(qrels, run, k: int = 100, strict: bool = False) -> float:
    """Capped recall: denominator is min(k, #relevant) per query.

    Parity: reference ``retrieval/evaluation/custom_metrics.py:34-58``
    recall_cap — sum over queries divided by ``len(qrels)``.  Queries with
    no positive qrels contribute 0 (the reference raises ZeroDivisionError
    on those — deliberate deviation); ``strict=True`` raises like the
    reference's convention instead.
    """
    _check_strict(qrels, strict, "recall_cap_at_k")
    total = 0.0
    for qid, rels in qrels.items():
        relevant = {d for d, r in rels.items() if r > 0}
        if not relevant:
            continue
        got = {d for d, _ in _ranked_docs(run, qid, k)}
        total += len(got & relevant) / min(k, len(relevant))
    return total / max(len(qrels), 1)


def hole_at_k(qrels, run, k: int = 100) -> float:
    """Fraction of the top-k that is unjudged across the WHOLE collection.

    Parity: reference ``custom_metrics.py:62-89`` — a doc is a hole when it
    is absent from the union of annotated docids over ALL queries' qrels,
    each query contributes ``len(holes)/k`` (k, not the retrieved count),
    and the sum is divided by ``len(qrels)``.
    """
    annotated = {d for rels in qrels.values() for d in rels}
    total = 0.0
    for qid in run:
        got = [d for d, _ in _ranked_docs(run, qid, k)]
        total += sum(1 for d in got if d not in annotated) / k
    return total / max(len(qrels), 1)


def top_k_accuracy(qrels, run, k: int = 100) -> float:
    """Fraction of queries with >= 1 relevant doc in the top k."""
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        n += 1
        relevant = {d for d, r in rels.items() if r > 0}
        got = {d for d, _ in _ranked_docs(run, qid, k)}
        if got & relevant:
            total += 1.0
    return total / max(n, 1)


def ndcg_at_k(qrels, run, k: int = 10) -> float:
    """nDCG@k with graded relevance and log2(rank+1) discount."""
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        n += 1
        dcg = 0.0
        for rank, (docid, _) in enumerate(_ranked_docs(run, qid, k), start=1):
            rel = rels.get(docid, 0)
            if rel > 0:
                dcg += (2**rel - 1) / math.log2(rank + 1)
        ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
        idcg = sum(
            (2**rel - 1) / math.log2(rank + 1)
            for rank, rel in enumerate(ideal, start=1)
        )
        if idcg > 0:
            total += dcg / idcg
    return total / max(n, 1)


def evaluate_run(qrels, run, k_values: Sequence[int] = (10, 100, 1000)) -> dict:
    """One-call evaluation bundle over several cutoffs."""
    out = {}
    for k in k_values:
        out[f"MRR@{k}"] = mrr_at_k(qrels, run, k)
        out[f"nDCG@{k}"] = ndcg_at_k(qrels, run, k)
        out[f"Recall@{k}"] = recall_at_k(qrels, run, k)
        out[f"R_cap@{k}"] = recall_cap_at_k(qrels, run, k)
    return out


# --------------------------------------------------------------------------
# Array-based metrics over a single query's candidate list (rerank eval).
# rels: binary/graded relevance in *ranked order* (downstream of a sort).
# --------------------------------------------------------------------------


def average_precision(rels: np.ndarray) -> float:
    rels = np.asarray(rels) > 0
    if rels.sum() == 0:
        return 0.0
    hits = np.cumsum(rels)
    precisions = hits / (np.arange(len(rels)) + 1)
    return float((precisions * rels).sum() / rels.sum())


def r_precision(rels: np.ndarray) -> float:
    rels = np.asarray(rels) > 0
    r = int(rels.sum())
    if r == 0:
        return 0.0
    return float(rels[:r].sum() / r)


def reciprocal_rank(rels: np.ndarray, k: int | None = None) -> float:
    rels = np.asarray(rels) > 0
    if k is not None:
        rels = rels[:k]
    nz = np.flatnonzero(rels)
    return float(1.0 / (nz[0] + 1)) if len(nz) else 0.0


def ndcg_from_ranked(rels: np.ndarray, k: int | None = None) -> float:
    """Standard graded nDCG with (2^rel - 1) gains over the candidate list."""
    rels = np.asarray(rels, dtype=np.float64)
    if k is not None:
        rels = rels[:k]
    discounts = 1.0 / np.log2(np.arange(len(rels)) + 2)
    dcg = float(((2**rels - 1) * discounts).sum())
    ideal = np.sort(rels)[::-1]
    idcg = float(((2**ideal - 1) * discounts).sum())
    return dcg / idcg if idcg > 0 else 0.0


def ndcg_reference(rels: np.ndarray) -> float:
    """Reference-exact rerank NDCG (``tevatron/utils/metrics.py:36-53``).

    Semantics of ``NDCG(gt, pred)`` with the default binary grading as used
    by tevatron's rerank evaluator (``eval.py:161-163``): every positive
    candidate contributes gain 1 regardless of its graded relevance, no
    rank cutoff, the ideal DCG is
    over the first ``len(gt)`` ranks, and the normalizer is floored at 0.3
    (``score / max(0.3, norm)`` — so a query with zero positives scores 0
    rather than being undefined).
    """
    rels = np.asarray(rels) > 0
    ranks = np.flatnonzero(rels)
    score = float((1.0 / np.log2(ranks + 2)).sum())
    n_gt = int(rels.sum())
    norm = float((1.0 / np.log2(np.arange(n_gt) + 2)).sum())
    return score / max(0.3, norm)


def rerank_metrics(
    ranked_rels: Sequence[np.ndarray], reference_compat: bool = False
) -> dict:
    """MAP / RPrec / nDCG / MRR / MRR@10 macro-averaged over queries.

    Parity: the accumulator loop of tevatron's rerank evaluator +
    ``tevatron/utils/metrics.py:57-92``.  With ``reference_compat=True`` the
    NDCG column uses the reference's exact binary-graded, floor-normalized
    formula (:func:`ndcg_reference`); the default is standard graded nDCG
    (identical for binary relevance with >= 1 positive).
    """
    agg = {"MAP": 0.0, "RPrec": 0.0, "NDCG": 0.0, "MRR": 0.0, "MRR@10": 0.0}
    n = 0
    for rels in ranked_rels:
        n += 1
        agg["MAP"] += average_precision(rels)
        agg["RPrec"] += r_precision(rels)
        agg["NDCG"] += (
            ndcg_reference(rels) if reference_compat else ndcg_from_ranked(rels)
        )
        agg["MRR"] += reciprocal_rank(rels)
        agg["MRR@10"] += reciprocal_rank(rels, k=10)
    return {k: v / max(n, 1) for k, v in agg.items()}
