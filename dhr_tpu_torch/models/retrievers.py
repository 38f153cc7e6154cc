"""The retriever model family: Dense, DHR/DLR, Aggretriever, ColBERT.

Port of ``dhr_tpu/models/retrievers.py`` for plain rows (packed-row
encoding is not ported yet).  One shared transformer encoder with
pluggable heads, selected by ``RetrieverConfig.model_type``:

- ``dense``: CLS or mean pooling, optional linear projector;
- ``dhr`` / ``dlr``: the lexical vocabulary-space rep
  ``max_seq(softmax(logits) * term_weight * mask)`` over positions 1..L-1,
  plus a CLS semantic rep; ``dlr`` is ``dhr`` with the CLS fusion off;
- ``agg``: the same lexical rep (or, with ``skip_mlm``, a scatter-max of
  raw term weights at the input token ids) plus a projected CLS;
- ``colbert``: projected token reps, query rows divided by the query length
  and scaled by 32, split into (CLS, rest).

Encoders return :class:`Reps`; the planes an index stores are made from
them by ``dhr_tpu_torch.encode``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dhr_tpu_torch.models.heads import Projector, TermWeightTrans
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

    @property
    def use_pooler(self) -> bool:
        # colbert always projects to its rep dim
        return self.cfg.model_type == "colbert" or self.cfg.add_pooler

    def hidden_states(self, input_ids, attention_mask) -> torch.Tensor:
        """The transformer stack alone: ``(B, L, H)`` in the compute dtype."""
        enc = self.backbone.encoder if self.cfg.needs_mlm else self.backbone
        return enc(input_ids, attention_mask)

    def reps(self, hidden, input_ids, attention_mask,
             is_query: bool = False) -> Reps:
        """The family's head over the hidden states."""
        mt = self.cfg.model_type
        if mt == "dense":
            return self._dense_reps(hidden, attention_mask)
        if mt in ("dhr", "dlr", "agg"):
            return self._lexical_reps(hidden, input_ids, attention_mask)
        return self._colbert_reps(hidden, attention_mask, is_query)

    def forward(self, input_ids, attention_mask, is_query: bool = False):
        hidden = self.hidden_states(input_ids, attention_mask)
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
            # logits are never read.
            probs = torch.softmax(self.backbone.logits(hidden[:, 1:]),
                                  dim=-1, dtype=torch.float32)
            # tw * mask first: equal to (probs * tw) * mask for a 0/1 mask,
            # signed zeros included
            w = tw.float() * attention_mask[:, 1:, None].float()
            weighted = (probs * w if torch.is_grad_enabled()
                        else probs.mul_(w))
            lexical = weighted.amax(dim=-2)
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

    # ---- colbert -----------------------------------------------------------
    def _colbert_reps(self, hidden, attention_mask, is_query) -> Reps:
        reps = self.pooler(hidden)
        reps = reps * attention_mask[..., None].to(reps.dtype)
        if is_query:
            q_len = attention_mask.sum(-1)[:, None, None].to(reps.dtype)
            reps = reps / q_len * 32.0
        reps = reps.float()
        return Reps(token_cls=reps[:, :1], token=reps[:, 1:])


class BiEncoder(nn.Module):
    """Query/passage bi-encoder; tied by default (``encoder_p`` exists only
    when ``untie_encoder``)."""

    def __init__(self, cfg: RetrieverConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder_q = RetrieverEncoder(cfg)
        if cfg.untie_encoder:
            self.encoder_p = RetrieverEncoder(cfg)

    def encoder(self, role: str) -> RetrieverEncoder:
        """The encoder of ``role`` ('query' or 'passage')."""
        if role == "passage" and self.cfg.untie_encoder:
            return self.encoder_p
        return self.encoder_q

    def forward(self, query=None, passage=None):
        """Encode query and/or passage batches (dicts with ``input_ids``
        and ``attention_mask``); ``(q_reps, p_reps)``, None for absent
        sides."""
        q_reps = p_reps = None
        if query is not None:
            q_reps = self.encoder("query")(
                query["input_ids"], query["attention_mask"], is_query=True)
        if passage is not None:
            p_reps = self.encoder("passage")(
                passage["input_ids"], passage["attention_mask"])
        return q_reps, p_reps
