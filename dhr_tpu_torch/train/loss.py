"""Training losses for the retriever family.

Port of ``dhr_tpu/train/loss.py``.  Every function works on the whole
batch: the listwise score matrix ``(B, B*n)`` pairs every query with every
passage of the step, and query b's positive sits at column ``b * n``.
Scores, softmaxes and reductions are f32 (matmuls without TF32).

- listwise scores: inner product, densified gated inner product (GIP), and
  ColBERT MaxSim;
- one-hot KL (the softmax cross-entropy on the positives), KL against a
  teacher's softmax at a temperature;
- DHR: the fused lexical + semantic scores, or, with teacher scores (TCT
  distillation, or margin-KD margins placed on the block diagonal), KL at
  temperature splits 1 / 3/4 / 1/4 for fused / semantic / lexical;
- Aggretriever: fused + 0.5 lexical + 0.5 semantic;
- ColBERT: MaxSim(tokens) + MaxSim(CLS), CE or margin-KD with -20-padded
  teacher rows.

The ``_packed`` forms take the per-slot reps of the packed passage tower.
"""

from __future__ import annotations

import torch

from dhr_tpu_torch.ops.aggregate import aggregate
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.ops.gip import gip_scores_masked

# --------------------------------------------------------------------------
# score matrices (global listwise)
# --------------------------------------------------------------------------


def listwise_ip(q_reps: torch.Tensor, p_reps: torch.Tensor) -> torch.Tensor:
    """(B, D) x (B*n, D) -> (B, B*n) inner-product scores, f32."""
    return q_reps.float() @ p_reps.float().T


def listwise_gip(q_lexical: torch.Tensor, p_lexical: torch.Tensor,
                 dlr_out_dim: int, remove_dims: int = 570) -> torch.Tensor:
    """Densified gated-inner-product listwise scores, differentiable
    through the fold-max values (the argmax gate carries no gradient)."""
    qv, qi = densify(q_lexical, dlr_out_dim, remove_dims)
    pv, pi = densify(p_lexical, dlr_out_dim, remove_dims)
    return gip_scores_masked(qv, qi, pv, pi)


def listwise_maxsim(q_tokens: torch.Tensor,
                    p_tokens: torch.Tensor) -> torch.Tensor:
    """ColBERT MaxSim: (B, Lq, D) x (M, Lp, D) -> (B, M).  Padded passage
    rows are zero vectors; padded query rows add 0."""
    sim = torch.einsum("aik,bjk->abij", q_tokens.float(), p_tokens.float())
    return sim.amax(-1).sum(-1)


def pairwise_maxsim(q_tokens: torch.Tensor,
                    p_tokens: torch.Tensor) -> torch.Tensor:
    """Row-aligned MaxSim: (B, Lq, D) x (B, Lp, D) -> (B,)."""
    sim = torch.einsum("bik,bjk->bij", q_tokens.float(), p_tokens.float())
    return sim.amax(-1).sum(-1)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def positive_columns(num_queries: int, n_passages: int,
                     device=None) -> torch.Tensor:
    """Column of each query's positive in the listwise score matrix."""
    return torch.arange(num_queries, device=device) * n_passages


def kl_onehot(scores: torch.Tensor, n_passages: int) -> torch.Tensor:
    """Mean KL(log_softmax(scores) || one_hot) == softmax CE on positives."""
    labels = positive_columns(scores.shape[0], n_passages, scores.device)
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def kl_vs_teacher(scores: torch.Tensor, teacher_scores: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """Batch-mean KL(log_softmax(student) || softmax(teacher * T))."""
    logp = torch.log_softmax(scores, dim=-1)
    t = torch.softmax(teacher_scores * temperature, dim=-1)
    return (t * (torch.log(torch.clamp(t, min=1e-30)) - logp)).sum(-1).mean()


def expand_teacher_margins(teacher_scores: torch.Tensor,
                           num_total_passages: int,
                           fill_value: float = -20.0) -> torch.Tensor:
    """Place per-query teacher scores (B, n) on their listwise block
    diagonal: row b holds ``teacher_scores[b]`` at columns ``b*n ..
    b*n + n - 1`` and ``fill_value`` elsewhere."""
    B, n = teacher_scores.shape
    dev = teacher_scores.device
    cols = torch.arange(num_total_passages, device=dev)[None, :]
    offset = cols - (torch.arange(B, device=dev) * n)[:, None]
    in_block = (offset >= 0) & (offset < n)
    gathered = teacher_scores.gather(-1, offset.clamp(0, n - 1))
    return torch.where(in_block, gathered, fill_value)


def dense_contrastive_loss(q_reps, p_reps, n_passages: int,
                           loss_scale: float = 1.0) -> torch.Tensor:
    """In-batch-negative CE for the dense family."""
    return kl_onehot(listwise_ip(q_reps, p_reps), n_passages) * loss_scale


def _teacher_kl(scores: torch.Tensor, teacher_scores: torch.Tensor,
                temperature: float) -> torch.Tensor:
    """:func:`kl_vs_teacher` against listwise teacher scores ``(B, B*n)``
    (the in-graph TCT teacher's), or against margin-KD scores ``(B, n)``
    from the data, which first go onto their block diagonal at the
    temperature (:func:`expand_teacher_margins`, as the ColBERT loss
    places them).  The reference broadcasts ``(B, n)`` margins against
    ``(B, B*n)`` scores and fails for every batch of more than one query."""
    if teacher_scores.shape[-1] == scores.shape[-1]:
        return kl_vs_teacher(scores, teacher_scores, temperature)
    return kl_vs_teacher(scores, expand_teacher_margins(
        teacher_scores * temperature, scores.shape[-1]), 1.0)


def _dhr_kl(scores, lexical_scores, semantic_scores, n_passages,
            teacher_scores, temperature):
    """The DHR KL combination (one-hot, or the teacher's temperature
    splits)."""
    if teacher_scores is None:
        return kl_onehot(scores, n_passages)
    return (_teacher_kl(scores, teacher_scores, temperature)
            + 0.5 * _teacher_kl(semantic_scores, teacher_scores,
                                temperature * 3 / 4)
            + 0.5 * _teacher_kl(lexical_scores, teacher_scores,
                                temperature * 1 / 4))


def dhr_loss(q_reps, p_reps, n_passages: int,
             dlr_out_dim: int | None = 768, combine_cls: bool = True,
             remove_dims: int = 570,
             teacher_scores: torch.Tensor | None = None,
             temperature: float = 1.0, loss_scale: float = 1.0):
    """DHR/DLR loss: fused lexical + semantic listwise KL (one-hot or
    TCT-KD).  Returns ``(loss, scores)``."""
    if dlr_out_dim is not None:
        lexical_scores = listwise_gip(q_reps.lexical, p_reps.lexical,
                                      dlr_out_dim, remove_dims)
    else:
        lexical_scores = listwise_ip(q_reps.lexical, p_reps.lexical)
    semantic_scores = listwise_ip(q_reps.semantic, p_reps.semantic)
    lamb = 1.0 if combine_cls else 0.0
    scores = lexical_scores + lamb * semantic_scores
    loss = _dhr_kl(scores, lexical_scores, semantic_scores, n_passages,
                   teacher_scores, temperature)
    return loss * loss_scale, scores


def dhr_loss_packed(q_reps, p_values, p_indices, p_semantic,
                    n_passages: int, combine_cls: bool = True,
                    dlr_out_dim: int = 768, remove_dims: int = 570,
                    teacher_scores: torch.Tensor | None = None,
                    temperature: float = 1.0, loss_scale: float = 1.0):
    """DHR/DLR loss over a packed passage tower, whose forward already gave
    per-passage densified planes (the GIP variant only)."""
    qv, qi = densify(q_reps.lexical, dlr_out_dim, remove_dims)
    lexical_scores = gip_scores_masked(qv, qi, p_values, p_indices)
    semantic_scores = listwise_ip(q_reps.semantic, p_semantic)
    lamb = 1.0 if combine_cls else 0.0
    scores = lexical_scores + lamb * semantic_scores
    loss = _dhr_kl(scores, lexical_scores, semantic_scores, n_passages,
                   teacher_scores, temperature)
    return loss * loss_scale, scores


def agg_loss(q_reps, p_reps, n_passages: int, agg_dim: int = 640,
             semi_aggregate: bool = False,
             teacher_scores: torch.Tensor | None = None,
             temperature: float = 1.0, loss_scale: float = 1.0):
    """Aggretriever loss: fused KL + 0.5 lexical KL + 0.5 semantic KL."""
    q_tok = aggregate(q_reps.lexical, agg_dim, full=not semi_aggregate)
    p_tok = aggregate(p_reps.lexical, agg_dim, full=not semi_aggregate)
    return _agg_kl(
        listwise_ip(q_tok, p_tok),
        listwise_ip(q_reps.semantic, p_reps.semantic)
        if q_reps.semantic is not None else None,
        n_passages, teacher_scores, temperature, loss_scale)


def agg_loss_packed(q_reps, p_tok, p_semantic, n_passages: int,
                    agg_dim: int = 640, semi_aggregate: bool = False,
                    teacher_scores: torch.Tensor | None = None,
                    temperature: float = 1.0, loss_scale: float = 1.0):
    """Aggretriever loss over a packed passage tower: ``p_tok`` is already
    aggregated; only the query side aggregates here."""
    q_tok = aggregate(q_reps.lexical, agg_dim, full=not semi_aggregate)
    return _agg_kl(
        listwise_ip(q_tok, p_tok),
        listwise_ip(q_reps.semantic, p_semantic)
        if q_reps.semantic is not None and p_semantic is not None else None,
        n_passages, teacher_scores, temperature, loss_scale)


def _agg_kl(lexical_scores, semantic_scores, n_passages, teacher_scores,
            temperature, loss_scale):
    has_semantic = semantic_scores is not None
    scores = (lexical_scores + semantic_scores if has_semantic
              else lexical_scores)
    if teacher_scores is not None:
        loss = _teacher_kl(scores, teacher_scores, temperature)
        if has_semantic:
            loss = loss + 0.5 * _teacher_kl(
                semantic_scores, teacher_scores, temperature * 3 / 4)
        loss = loss + 0.5 * _teacher_kl(
            lexical_scores, teacher_scores, temperature * 1 / 4)
    else:
        loss = kl_onehot(scores, n_passages)
        if has_semantic:
            loss = loss + 0.5 * kl_onehot(lexical_scores, n_passages)
            loss = loss + 0.5 * kl_onehot(semantic_scores, n_passages)
    return loss * loss_scale, scores


def _colbert_kl(scores, n_passages, teacher_scores, temperature,
                loss_scale):
    if teacher_scores is not None:
        expanded = expand_teacher_margins(teacher_scores * temperature,
                                          scores.shape[1])
        loss = kl_vs_teacher(scores, expanded, 1.0)
    else:
        loss = kl_onehot(scores, n_passages)
    return loss * loss_scale, scores


def colbert_loss(q_reps, p_reps, n_passages: int,
                 teacher_scores: torch.Tensor | None = None,
                 temperature: float = 1.0, loss_scale: float = 1.0):
    """ColBERT loss: MaxSim(token) + MaxSim(cls) scores, CE or margin-KD."""
    scores = (listwise_maxsim(q_reps.token, p_reps.token)
              + listwise_maxsim(q_reps.token_cls, p_reps.token_cls))
    return _colbert_kl(scores, n_passages, teacher_scores, temperature,
                       loss_scale)


def colbert_loss_packed(q_reps, packed_tok, segment_ids, position_ids,
                        seg_start, slot_pos, n_passages: int, p_len: int,
                        teacher_scores: torch.Tensor | None = None,
                        temperature: float = 1.0, loss_scale: float = 1.0):
    """Packed-passage twin of :func:`colbert_loss`.

    ``packed_tok`` is the packed row plane ``(B, L, D)`` of
    ``encode_tokens_packed``.  MaxSim runs on the packed layout: one
    ``(Q, B, Lq, L)`` similarity plane, then a masked max per slot.  The
    plain path's padded positions are zero vectors, so its max has a 0
    candidate whenever the passage is shorter than ``p_len``; the packed max
    floors at 0 for exactly those slots (token count < ``p_len - 1``).
    """
    Q = q_reps.token.shape[0]
    B, S = seg_start.shape
    ptok = packed_tok.float()
    sim = torch.einsum("qik,blk->qbil", q_reps.token.float(), ptok)
    tok_ok = (segment_ids > 0) & (position_ids > 0)  # (B, L)
    slot_max, slot_cnt = [], []
    for s in range(S):
        m = (segment_ids == s + 1) & tok_ok
        slot_max.append(torch.where(m[None, :, None, :], sim,
                                    float("-inf")).amax(-1))  # (Q, B, Lq)
        slot_cnt.append(m.sum(-1))  # (B,)
    mx = torch.stack(slot_max, 2)  # (Q, B, S, Lq)
    cnt = torch.stack(slot_cnt, 1)  # (B, S)
    has_pad = (cnt < p_len - 1)[None, :, :, None]
    mx = torch.where(has_pad, mx.clamp(min=0.0), mx)
    # empty slots are all -inf; zero them (slot_pos never selects them,
    # this only keeps the sum finite)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    slot_pos = slot_pos.long()
    tok_scores = mx.sum(-1).reshape(Q, B * S)[:, slot_pos]
    idx = seg_start.long()[:, :, None].expand(-1, -1, ptok.shape[-1])
    cls_p = torch.gather(ptok, 1, idx).reshape(B * S, -1)[slot_pos]
    cls_scores = q_reps.token_cls[:, 0].float() @ cls_p.T
    return _colbert_kl(tok_scores + cls_scores, n_passages, teacher_scores,
                       temperature, loss_scale)


def colbert_teacher_scores(q_reps, p_reps) -> torch.Tensor:
    """Listwise teacher scores for TCT distillation (no gradient)."""
    with torch.no_grad():
        return (listwise_maxsim(q_reps.token, p_reps.token)
                + listwise_maxsim(q_reps.token_cls, p_reps.token_cls))
