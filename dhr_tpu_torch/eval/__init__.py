"""Evaluation: ranking metrics (NumPy, host side)."""

from dhr_tpu_torch.eval.metrics import (
    average_precision,
    evaluate_run,
    hole_at_k,
    mrr_at_k,
    ndcg_at_k,
    ndcg_from_ranked,
    ndcg_reference,
    r_precision,
    recall_at_k,
    recall_cap_at_k,
    reciprocal_rank,
    rerank_metrics,
    top_k_accuracy,
    zero_positive_queries,
)

__all__ = [
    "average_precision", "evaluate_run", "hole_at_k", "mrr_at_k",
    "ndcg_at_k", "ndcg_from_ranked", "ndcg_reference", "r_precision",
    "recall_at_k", "recall_cap_at_k", "reciprocal_rank", "rerank_metrics",
    "top_k_accuracy", "zero_positive_queries",
]
