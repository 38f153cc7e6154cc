"""Evaluation: ranking metrics (NumPy, host side), rerank evaluation of
candidate lists and the BEIR harness."""

from dhr_tpu_torch.eval.beir import (
    BEIR_13,
    BEIR_URL,
    download_beir_dataset,
    evaluate_beir,
    load_beir_dir,
)
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
from dhr_tpu_torch.eval.rerank import evaluate_rerank, make_pair_scorer

__all__ = [
    "BEIR_13", "BEIR_URL", "average_precision", "download_beir_dataset",
    "evaluate_beir", "evaluate_rerank", "evaluate_run", "hole_at_k",
    "load_beir_dir", "make_pair_scorer", "mrr_at_k", "ndcg_at_k",
    "ndcg_from_ranked", "ndcg_reference", "r_precision", "recall_at_k",
    "recall_cap_at_k", "reciprocal_rank", "rerank_metrics", "top_k_accuracy",
    "zero_positive_queries",
]
