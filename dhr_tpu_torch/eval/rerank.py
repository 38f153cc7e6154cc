"""Rerank-style evaluation: score (query, passage, rel) candidate lists.

Port of ``dhr_tpu/eval/rerank.py`` (the reference's ``driver/eval.py``
role: an EvalDataset of ~1,000 candidates a query, per-pair scores, then
MAP / RPrec / NDCG / MRR / MRR@10).  The reference stops at 200 queries
(eval.py:173-174), a quirk not copied: ``max_queries`` reproduces it.
Batches are not padded to ``batch_size`` (each row scores alone).
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Callable, Iterable

import numpy as np
import torch

from dhr_tpu_torch.data.collate import pad_token_batch
from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.eval.metrics import rerank_metrics
from dhr_tpu_torch.models.decoder import check_card_dtype
from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig
from dhr_tpu_torch.models.transformer import compute_copy
from dhr_tpu_torch.ops.aggregate import aggregate
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.ops.gip import gip_scores_pairwise
from dhr_tpu_torch.train.loss import pairwise_maxsim


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() * b.float()).sum(-1)


def make_pair_scorer(model: BiEncoder, cfg: RetrieverConfig,
                     remove_dims: int = 570,
                     device: str | torch.device | None = None) -> Callable:
    """``score(query_batch, passage_batch) -> (B,)`` f32 fused scores on
    ``device`` (default: the GPU), for batches of ``input_ids`` /
    ``attention_mask`` arrays.  The scorer keeps its own copy of ``model``
    there, in the compute dtype.

    Per family, the reference's inference branches (DHR/modeling.py:
    210-227, Aggretriever/modeling.py:222-241, ColBERT/modeling.py:
    187-190, the dense dot product)."""
    dev = resolve_device(device)
    if cfg.causal:
        check_card_dtype(cfg.encoder, dev)
    model = compute_copy(model, cfg.encoder.dtype, dev).eval()
    mt = cfg.model_type

    def to_device(batch):
        return {k: torch.as_tensor(np.asarray(batch[k])).to(dev)
                for k in ("input_ids", "attention_mask")}

    @torch.inference_mode()
    def score(q, p):
        q_reps, p_reps = model(query=to_device(q), passage=to_device(p))
        if mt == "dense":
            return _dot(q_reps.dense, p_reps.dense)
        if mt in ("dhr", "dlr"):
            qv, qi = densify(q_reps.lexical, cfg.dlr_out_dim, remove_dims)
            pv, pi = densify(p_reps.lexical, cfg.dlr_out_dim, remove_dims)
            lam = 1.0 if cfg.combine_cls else 0.0
            return gip_scores_pairwise(qv, qi, pv, pi) + lam * _dot(
                q_reps.semantic, p_reps.semantic)
        if mt == "agg":
            full = not cfg.semi_aggregate
            s = _dot(aggregate(q_reps.lexical, cfg.agg_dim, full=full),
                     aggregate(p_reps.lexical, cfg.agg_dim, full=full))
            if q_reps.semantic is not None:
                s = s + _dot(q_reps.semantic, p_reps.semantic)
            return s
        return (pairwise_maxsim(q_reps.token, p_reps.token)
                + pairwise_maxsim(q_reps.token_cls, p_reps.token_cls))

    return score


def evaluate_rerank(
    scorer: Callable,
    examples: Iterable[tuple[str, list[int], str, list[int], int]],
    q_max_len: int = 32,
    p_max_len: int = 128,
    batch_size: int = 64,
    max_queries: int | None = None,
    cls_id: int | None = None,
    sep_id: int | None = None,
    reference_compat: bool = False,
) -> dict:
    """Score ``(qid, q_tokens, pid, p_tokens, rel)`` rows and aggregate the
    metrics over queries.

    ``reference_compat=True`` switches NDCG to the reference's binary
    graded formula (``tevatron/utils/metrics.py:36-53``)."""
    per_query: dict[str, list[tuple[float, int]]] = defaultdict(list)
    buf: list[tuple[str, list[int], list[int], int]] = []
    seen: set[str] = set()

    def flush():
        if not buf:
            return
        q = pad_token_batch([b[1] for b in buf], q_max_len, cls_id=cls_id,
                            sep_id=sep_id)
        p = pad_token_batch([b[2] for b in buf], p_max_len, cls_id=cls_id,
                            sep_id=sep_id)
        scores = scorer(q, p).float().cpu().numpy()
        for (qid, _, _, rel), s in zip(buf, scores):
            per_query[qid].append((float(s), int(rel)))
        buf.clear()

    for qid, q_tokens, _pid, p_tokens, rel in examples:
        # queries are counted as their rows are read, so the cut never
        # lands inside a query: a new qid past the cap stops the loop
        # before any of its rows are buffered
        if max_queries is not None and qid not in seen and (
                len(seen) >= max_queries):
            break
        seen.add(qid)
        buf.append((qid, q_tokens, p_tokens or [0], rel))
        if len(buf) == batch_size:
            flush()
    flush()

    ranked = []
    for rows in per_query.values():
        rows.sort(key=lambda x: -x[0])
        ranked.append(np.asarray([rel for _, rel in rows]))
    out = rerank_metrics(ranked, reference_compat=reference_compat)
    out["num_queries"] = len(ranked)
    return out
