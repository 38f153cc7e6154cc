"""The retriever model family: Dense, DHR/DLR, Aggretriever, ColBERT.

Port of ``dhr_tpu/models/retrievers.py``.  One shared transformer encoder
with pluggable heads, selected by ``RetrieverConfig.model_type``:

- ``dense``: CLS or mean pooling, optional linear projector;
- ``dhr`` / ``dlr``: the lexical vocabulary-space rep
  ``max_seq(softmax(logits) * term_weight * mask)`` over positions 1..L-1,
  plus a CLS semantic rep; ``dlr`` is ``dhr`` with the CLS fusion off;
- ``agg``: the same lexical rep (or, with ``skip_mlm``, a scatter-max of
  raw term weights at the input token ids) plus a projected CLS;
- ``colbert``: projected token reps, query rows divided by the query length
  and scaled by 32, split into (CLS, rest).

Encoders return :class:`Reps`; the planes an index stores are made from
them by ``dhr_tpu_torch.encode``.  Packed rows (several documents per row,
block-diagonal attention) go through :meth:`RetrieverEncoder.encode_packed`
and :meth:`RetrieverEncoder.encode_tokens_packed`, which return per-slot
reduced reps.  Every forward takes ``gen``, the generator of its dropout
masks (dropout is active in training mode only; the modules start in
eval mode, as the reference's ``deterministic=True`` default).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dhr_tpu_torch.models.heads import Projector, TermWeightTrans
from dhr_tpu_torch.ops.aggregate import aggregate
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.ops.lexical_pool import lexical_pool, weighted_softmax
from dhr_tpu_torch.models.transformer import (
    EncoderConfig,
    EncoderWithMLM,
    TransformerEncoder,
)

MODEL_TYPES = ("dense", "dhr", "dlr", "agg", "colbert")


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    model_type: str = "dhr"
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    untie_encoder: bool = False
    # pooling / projection
    add_pooler: bool = False
    projection_dim: int = 128
    pooling: str = "cls"  # dense family: 'cls' | 'mean'
    # DHR / DLR
    combine_cls: bool = True  # dlr forces False
    dlr_out_dim: int = 768
    # Aggretriever
    agg_dim: int = 640
    semi_aggregate: bool = False
    skip_mlm: bool = False
    # dhr/dlr packed head order: False = per-token densify, then a segment
    # max over tokens; True = segment max over the (B, L, V) weighted plane
    # first, then one densify.  Values are the same either way; fold
    # indices differ only on exact cross-token ties.
    packed_segfirst: bool = False

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {self.model_type}")
        if self.model_type == "dlr":
            object.__setattr__(self, "combine_cls", False)

    @property
    def needs_mlm(self) -> bool:
        if self.model_type in ("dhr", "dlr"):
            return True
        return self.model_type == "agg" and not self.skip_mlm


@dataclasses.dataclass
class Reps:
    """Encoder output bundle; unused fields are None per model family."""

    dense: Optional[torch.Tensor] = None      # (B, D)        dense
    lexical: Optional[torch.Tensor] = None    # (B, V)        dhr / agg vocab rep
    semantic: Optional[torch.Tensor] = None   # (B, Dp)       dhr / agg CLS rep
    token: Optional[torch.Tensor] = None      # (B, L-1, Dp)  colbert tokens
    token_cls: Optional[torch.Tensor] = None  # (B, 1, Dp)    colbert CLS row


# a pytree node, so that FSDP2 finds the tensors of a forward's Reps and
# hooks its pre-backward all-gather onto them: versions of torch that look
# for them with tree_flatten (2.11) see an unregistered dataclass as one
# leaf, and the backward then reads parameters already resharded
torch.utils._pytree.register_dataclass(Reps)


class RetrieverEncoder(nn.Module):
    """Role-agnostic encoder: the same module embeds queries and passages."""

    def __init__(self, cfg: RetrieverConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.encoder.hidden_size
        if cfg.needs_mlm:
            self.backbone = EncoderWithMLM(cfg.encoder)
        else:
            self.backbone = TransformerEncoder(cfg.encoder)
        if cfg.model_type in ("dhr", "dlr", "agg"):
            self.term_weight = TermWeightTrans(H)
        if self.use_pooler:
            self.pooler = Projector(H, cfg.projection_dim)
        self.eval()  # deterministic until a train step asks for training

    @property
    def use_pooler(self) -> bool:
        # colbert always projects to its rep dim
        return self.cfg.model_type == "colbert" or self.cfg.add_pooler

    def hidden_states(self, input_ids, attention_mask, gen=None,
                      position_ids=None, segment_ids=None) -> torch.Tensor:
        """The transformer stack alone: ``(B, L, H)`` in the compute dtype."""
        enc = self.backbone.encoder if self.cfg.needs_mlm else self.backbone
        return enc(input_ids, attention_mask, position_ids, segment_ids, gen)

    def reps(self, hidden, input_ids, attention_mask,
             is_query: bool = False) -> Reps:
        """The family's head over the hidden states."""
        mt = self.cfg.model_type
        if mt == "dense":
            return self._dense_reps(hidden, attention_mask)
        if mt in ("dhr", "dlr", "agg"):
            return self._lexical_reps(hidden, input_ids, attention_mask)
        return self._colbert_reps(hidden, attention_mask, is_query)

    def forward(self, input_ids, attention_mask, is_query: bool = False,
                gen: torch.Generator | None = None):
        hidden = self.hidden_states(input_ids, attention_mask, gen)
        return self.reps(hidden, input_ids, attention_mask, is_query)

    # ---- dense -----------------------------------------------------------
    def _dense_reps(self, hidden, attention_mask) -> Reps:
        if self.cfg.pooling == "mean":
            m = attention_mask[..., None].to(hidden.dtype)
            pooled = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        else:
            pooled = hidden[:, 0]
        if self.use_pooler:
            pooled = self.pooler(pooled)
        return Reps(dense=pooled.float())

    # ---- dhr / dlr / agg lexical -----------------------------------------
    def _lexical_reps(self, hidden, input_ids, attention_mask) -> Reps:
        cfg = self.cfg
        tw = self.term_weight(hidden[:, 1:])  # (B, L-1, 1)
        if cfg.needs_mlm:
            # softmax over the vocabulary in f32, weighted by the term
            # weight and the attention mask, max over positions 1..L-1.
            # The MLM head runs on those positions only: position 0's
            # logits are never read.  In inference (eval mode, autograd
            # off), one pool (K4 on the card) over the projection;
            # otherwise the passes autograd differentiates.  A train
            # step's no-grad encode (the gradient cache's pass 1) keeps
            # the passes, so that its pass 2 recomputes the same reps.
            if self.training or torch.is_grad_enabled():
                weighted = _weighted(self.backbone.logits(hidden[:, 1:]),
                                     tw, attention_mask[:, 1:, None])
                lexical = weighted.amax(dim=-2)
            else:
                w = tw[..., 0].float() * attention_mask[:, 1:].float()
                lexical = lexical_pool(self.backbone.projection(hidden[:, 1:]),
                                       self.backbone.mlm.bias, w)
        else:
            # skip-MLM: scatter-max raw term weights at the input token ids
            # over a zero floor; pad positions scatter into their id too
            B, V = input_ids.shape[0], cfg.encoder.vocab_size
            lexical = torch.zeros(B, V, dtype=torch.float32,
                                  device=hidden.device)
            lexical.scatter_reduce_(1, input_ids[:, 1:].long(),
                                    tw[..., 0].float(), reduce="amax")
        semantic = None
        cls_hidden = hidden[:, 0]
        if cfg.model_type in ("dhr", "dlr"):
            semantic = self.pooler(cls_hidden) if self.use_pooler \
                else cls_hidden
            semantic = semantic.float()
        elif self.use_pooler:  # agg with CLS projection
            semantic = self.pooler(cls_hidden).float()
        return Reps(lexical=lexical, semantic=semantic)

    # ---- packed rows (several documents per row) --------------------------
    def encode_packed(self, input_ids, segment_ids, position_ids, seg_start,
                      out_dim: int = 768, remove_dims: int = 570, gen=None):
        """Encode rows that pack several documents each.

        ``segment_ids`` (B, L) labels each token with its slot in 1..S (0 =
        pad), ``position_ids`` restart at 0 per segment, ``seg_start`` (B, S)
        holds each slot's first token position (the layout of
        ``dhr_tpu_torch.encode.collate_packed``).  Attention is
        block-diagonal, so every document sees the context it would see in
        a row of its own.  Per-slot results with leading shape (B, S):

        - dense: ``(pooled, None, None)``;
        - dhr / dlr: ``(values, fold indices, semantic)``, densified per
          token, then maxed per segment over tokens.  Values equal the plain
          path's (the max over tokens commutes with the fold max); a fold
          index differs only on exact float ties across tokens.
          Out-of-segment positions count as zeros, the plain path's floor
          from masked pad positions;
        - agg (MLM): ``(lexical, None, semantic or None)``, see
          :meth:`_agg_packed`.

        agg with ``skip_mlm`` raises: the plain path scatters pad-position
        term weights into vocabulary bucket 0, and a packed row has no such
        pads.  colbert raises: it packs through :meth:`encode_tokens_packed`.
        """
        cfg = self.cfg
        if cfg.model_type not in ("dense", "dhr", "dlr", "agg"):
            raise ValueError(f"packed encode supports dense/dhr/dlr/agg, not "
                             f"{cfg.model_type}")
        if cfg.model_type == "agg" and cfg.skip_mlm:
            raise ValueError(
                "packed encode does not support agg skip_mlm (the plain "
                "path's pad-position scatter into vocab bucket 0 cannot be "
                "reproduced without the pad rows) — use --length-bucketing")
        hidden = self.hidden_states(input_ids, None, gen, position_ids,
                                    segment_ids)
        S = seg_start.shape[1]
        if cfg.model_type == "dense":
            if cfg.pooling == "mean":
                slots = torch.arange(1, S + 1, device=hidden.device)
                onehot = (segment_ids[:, None, :] == slots[None, :, None]
                          ).to(hidden.dtype)  # (B, S, L)
                pooled = torch.einsum("bsl,blh->bsh", onehot, hidden)
                pooled = pooled / torch.clamp(onehot.sum(-1)[..., None],
                                              min=1.0)
            else:
                pooled = _take_slots(hidden, seg_start)
            if self.use_pooler:
                pooled = self.pooler(pooled)
            return pooled.float(), None, None
        logits = self.backbone.logits(hidden)
        if cfg.model_type == "agg":
            return self._agg_packed(hidden, logits, segment_ids,
                                    position_ids, seg_start)
        # dhr / dlr: per-token softmax x term weight, each segment's own
        # [CLS] row and the pads excluded
        tw = self.term_weight(hidden)  # (B, L, 1)
        token_ok = ((segment_ids > 0) & (position_ids > 0))[..., None]
        weighted = _weighted(logits, tw, token_ok)
        masks = [((segment_ids == s + 1) & (position_ids > 0))[..., None]
                 for s in range(S)]
        if cfg.packed_segfirst:
            seg_plane = torch.stack([torch.where(m, weighted, 0.0).amax(1)
                                     for m in masks], 1)  # (B, S, V)
            vals, idxs = densify(seg_plane, out_dim, remove_dims)
        else:
            tok_vals, tok_idx = densify(weighted, out_dim, remove_dims)
            vals_list, idx_list = [], []
            for m in masks:
                win = torch.where(m, tok_vals, 0.0).amax(1)  # (B, out_dim)
                # the winner's fold by compare + max (the reference's form:
                # on exact ties across tokens the largest fold is kept)
                mi = torch.where(m & (tok_vals == win[:, None]), tok_idx, 0)
                vals_list.append(win)
                idx_list.append(mi.amax(1))
            vals = torch.stack(vals_list, 1)  # (B, S, out_dim)
            idxs = torch.stack(idx_list, 1)
        cls_h = _take_slots(hidden, seg_start)
        semantic = self.pooler(cls_h) if self.use_pooler else cls_h
        return vals, idxs, semantic.float()

    def encode_tokens_packed(self, input_ids, segment_ids, position_ids,
                             gen=None):
        """ColBERT token reps of packed rows: ``(B, L, Dp)`` f32, pads
        zeroed.  The head is per token, so packing changes only the
        transformer call; each segment is laid out ``[CLS], t1, ...``."""
        if self.cfg.model_type != "colbert":
            raise ValueError(f"encode_tokens_packed is colbert-only, not "
                             f"{self.cfg.model_type}")
        hidden = self.hidden_states(input_ids, None, gen, position_ids,
                                    segment_ids)
        reps = self.pooler(hidden)
        reps = reps * (segment_ids > 0)[..., None].to(reps.dtype)
        return reps.float()

    def _agg_packed(self, hidden, logits, segment_ids, position_ids,
                    seg_start):
        """Aggretriever on packed rows: each token's weighted vocabulary
        distribution folds to the aggregation width first (the fold max
        commutes with the max over a segment's tokens), then a masked max
        per segment; the sign competition (full mode) runs after it, where
        the plain path runs it after its token max."""
        cfg = self.cfg
        S = seg_start.shape[1]
        width = cfg.agg_dim if cfg.semi_aggregate else 2 * cfg.agg_dim
        token_ok = ((segment_ids > 0) & (position_ids > 0))[..., None]
        weighted = _weighted(logits, self.term_weight(hidden), token_ok)
        folded = aggregate(weighted, width, full=False)  # (B, L, W)
        tok = torch.stack([
            torch.where((segment_ids == s + 1)[..., None] & token_ok, folded,
                        0.0).amax(1) for s in range(S)], 1)  # (B, S, W)
        if not cfg.semi_aggregate:
            pos, neg = tok[..., 0::2], tok[..., 1::2]
            tok = torch.where(pos > neg, pos, -neg)
        semantic = None
        if self.use_pooler:
            semantic = self.pooler(_take_slots(hidden, seg_start)).float()
        return tok, None, semantic

    # ---- colbert -----------------------------------------------------------
    def _colbert_reps(self, hidden, attention_mask, is_query) -> Reps:
        reps = self.pooler(hidden)
        reps = reps * attention_mask[..., None].to(reps.dtype)
        if is_query:
            q_len = attention_mask.sum(-1)[:, None, None].to(reps.dtype)
            reps = reps / q_len * 32.0
        reps = reps.float()
        return Reps(token_cls=reps[:, :1], token=reps[:, 1:])


def _weighted(logits, tw, token_ok):
    """f32 ``softmax(logits) * tw * token_ok`` over the vocabulary, in
    place outside autograd (``tw * token_ok`` first: the same values,
    signed zeros included, for a 0/1 mask)."""
    return weighted_softmax(logits, tw.float() * token_ok.float())


def _take_slots(hidden: torch.Tensor, seg_start: torch.Tensor):
    """``hidden[b, seg_start[b, s]]``: (B, L, H) -> (B, S, H)."""
    idx = seg_start.long()[:, :, None].expand(-1, -1, hidden.shape[-1])
    return torch.gather(hidden, 1, idx)


class BiEncoder(nn.Module):
    """Query/passage bi-encoder; tied by default (``encoder_p`` exists only
    when ``untie_encoder``)."""

    def __init__(self, cfg: RetrieverConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder_q = RetrieverEncoder(cfg)
        if cfg.untie_encoder:
            self.encoder_p = RetrieverEncoder(cfg)
        self.eval()

    def encoder(self, role: str) -> RetrieverEncoder:
        """The encoder of ``role`` ('query' or 'passage')."""
        if role == "passage" and self.cfg.untie_encoder:
            return self.encoder_p
        return self.encoder_q

    def forward(self, query=None, passage=None, gen=None):
        """Encode query and/or passage batches (dicts with ``input_ids``
        and ``attention_mask``); ``(q_reps, p_reps)``, None for absent
        sides.  ``gen`` draws the dropout masks, queries first."""
        q_reps = p_reps = None
        if query is not None:
            q_reps = self.encoder("query")(
                query["input_ids"], query["attention_mask"], is_query=True,
                gen=gen)
        if passage is not None:
            p_reps = self.encoder("passage")(
                passage["input_ids"], passage["attention_mask"], gen=gen)
        return q_reps, p_reps

    def encode_passages_packed(self, input_ids, segment_ids, position_ids,
                               seg_start, out_dim: int = 768,
                               remove_dims: int = 570, gen=None):
        """Packed-row passage encode (see RetrieverEncoder.encode_packed)."""
        return self.encoder("passage").encode_packed(
            input_ids, segment_ids, position_ids, seg_start, out_dim,
            remove_dims, gen)

    def encode_tokens_packed(self, input_ids, segment_ids, position_ids,
                             gen=None):
        """Packed-row colbert passage token reps (see RetrieverEncoder)."""
        return self.encoder("passage").encode_tokens_packed(
            input_ids, segment_ids, position_ids, gen)
