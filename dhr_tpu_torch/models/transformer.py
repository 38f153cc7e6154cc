"""The transformer encoder of every retriever family, in PyTorch.

Port of ``dhr_tpu/models/transformer.py``.  A post-LN BERT / DistilBERT
encoder with an optional MLM head whose vocabulary projection is tied to
the word-embedding table.  Rows hold one document each, or, given
``segment_ids`` / ``position_ids``, several (packed rows: block-diagonal
attention, positions restarting per segment).  Module and
parameter names mirror the reference's Flax tree, so
``dhr_tpu_torch.models.flax_params`` maps one onto the other by name.

Numerics follow the reference:

- parameters live in f32; activations compute in ``cfg.dtype`` (bf16 by
  default): each linear map and embedding casts its weight to that dtype
  (a no-op once :func:`compute_copy` has cast it);
- LayerNorm takes its statistics and normalizes in f32 and returns the
  compute dtype, as ``flax.linen.LayerNorm(dtype=...)`` does; eps 1e-12;
- attention scores are computed in the compute dtype, divided by
  sqrt(head_dim) taken in that dtype, biased by an additive key mask (-1e9
  cast to the dtype; pad query rows still get hidden states), softmaxed in
  f32 and cast back before ``P·V``;
- GELU is exact (erf); the MLM bias is added in the compute dtype;
- dropout sits at the reference's four sites (embeddings, attention
  probabilities, attention output, FFN output) and is active only in
  training mode (the modules start in eval mode, as the reference's
  ``deterministic=True`` default).  ``F.dropout`` takes no generator, so
  :func:`dropout` draws its masks from the ``torch.Generator`` the caller
  passes (``gen``): a train step seeds one per step, and the same seed
  gives the same masks.

Training keeps the f32 parameters and computes through the per-call casts;
:func:`compute_copy` is for inference only (a copy passes no gradient back).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Architecture config covering BERT- and DistilBERT-family encoders."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 0  # 0 => no token-type embeddings (DistilBERT)
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16  # activation / compute dtype

    @staticmethod
    def distilbert_base() -> "EncoderConfig":
        return EncoderConfig()

    @staticmethod
    def bert_base() -> "EncoderConfig":
        return EncoderConfig(num_layers=12, type_vocab_size=2)

    @staticmethod
    def tiny(vocab_size: int = 1024, **kw) -> "EncoderConfig":
        """A fast config for tests."""
        return EncoderConfig(
            vocab_size=vocab_size,
            hidden_size=32,
            num_layers=2,
            num_heads=2,
            intermediate_size=64,
            max_position_embeddings=64,
            **kw,
        )


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A dropout generator for one data-parallel rank: each mask is drawn
    at the global shape (``count`` ranks' rows of the leading batch dim)
    and this rank's block (``index``) is kept, so the ranks' masks are
    together the one-process mask of the global batch."""

    gen: torch.Generator
    index: int
    count: int


def dropout(x: torch.Tensor, p: float, training: bool,
            gen: torch.Generator | RowShard | None,
            heads: tuple[int, int] | None = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability ``1 - p``
    and scale it by ``1 / (1 - p)`` in ``x``'s dtype; the identity outside
    training or at ``p == 0``.  The mask comes from ``gen`` (the default
    generator when None).  Sharded, the global mask is drawn and this
    rank's block kept: of the batch dim for a :class:`RowShard`, of dim 1
    for ``heads=(index, count)`` (a tensor-parallel rank's heads)."""
    if not training or p == 0.0:
        return x
    shard, shape = gen, list(x.shape)
    if isinstance(shard, RowShard):
        shape[0] *= shard.count
        gen = shard.gen
    if heads is not None:
        shape[1] *= heads[1]
    draw = torch.rand(shape, generator=gen, device=x.device)
    if isinstance(shard, RowShard):
        b = x.shape[0]
        draw = draw[shard.index * b:(shard.index + 1) * b]
    if heads is not None:
        h = x.shape[1]
        draw = draw[:, heads[0] * h:(heads[0] + 1) * h]
    return torch.where(draw >= p, x / (1.0 - p), 0.0)


def attention_bias(attention_mask: torch.Tensor | None,
                   segment_ids: torch.Tensor | None,
                   dtype: torch.dtype) -> torch.Tensor:
    """The additive attention bias, -1e9 cast to ``dtype`` where masked.

    Plain rows: ``(B, 1, 1, L)``, a key mask.  Packed rows: ``(B, 1, L, L)``,
    block-diagonal: token q attends to k iff both lie in the same nonzero
    segment.  Pad rows (segment 0) see only -1e9, which the max-subtracted
    softmax turns into uniform junk that downstream masks drop.
    """
    if segment_ids is not None:
        allowed = ((segment_ids[:, :, None] == segment_ids[:, None, :])
                   & (segment_ids[:, None, :] > 0))[:, None]
    else:
        allowed = attention_mask[:, None, None, :] > 0
    return torch.where(allowed, 0.0, -1e9).to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm in f32 returning its input's dtype (f32 scale and bias)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = nn.Embedding(cfg.max_position_embeddings,
                                     cfg.hidden_size)
        if cfg.type_vocab_size > 0:
            self.token_type = nn.Embedding(cfg.type_vocab_size,
                                           cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                position_ids: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
        dt = self.cfg.dtype
        L = input_ids.shape[-1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(f"rows of {L} tokens exceed the model's "
                             f"{self.cfg.max_position_embeddings} positions")
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device)[None]
        x = (F.embedding(input_ids, self.word.weight.to(dt))
             + F.embedding(position_ids, self.position.weight.to(dt)))
        if self.cfg.type_vocab_size > 0:  # token type 0 everywhere
            x = x + self.token_type.weight[0].to(dt)
        return dropout(self.layer_norm(x), self.cfg.hidden_dropout,
                       self.training, gen)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        H = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = H // cfg.num_heads
        self.attention_dropout = cfg.attention_dropout
        self.query, self.key, self.value, self.out = (
            Dense(H, H) for _ in range(4))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                gen: torch.Generator | None = None):
        B, L, H = x.shape

        def heads(t):  # (B, L, H) -> (B, heads, L, head_dim); under tensor
            # parallelism t holds this rank's heads only
            return t.view(B, L, -1, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scale = float(torch.tensor(float(self.head_dim), dtype=x.dtype).sqrt())
        scores = torch.matmul(q, k.transpose(-1, -2)) / scale + mask_bias
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(x.dtype)
        heads = None
        if q.shape[1] != self.num_heads:  # tensor parallel: this rank's heads
            heads = (self.query.weight.device_mesh.get_local_rank(),
                     self.num_heads // q.shape[1])
        probs = dropout(probs, self.attention_dropout, self.training, gen,
                        heads)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, -1)
        return self.out(ctx)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = SelfAttention(cfg)
        self.attn_layer_norm = LayerNorm(H, eps)
        self.ffn_in = Dense(H, cfg.intermediate_size)
        self.ffn_out = Dense(cfg.intermediate_size, H)
        self.ffn_layer_norm = LayerNorm(H, eps)
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                gen: torch.Generator | None = None):
        p, on = self.hidden_dropout, self.training
        attn = dropout(self.attention(x, mask_bias, gen), p, on, gen)
        x = self.attn_layer_norm(x + attn)
        h = dropout(self.ffn_out(F.gelu(self.ffn_in(x))), p, on, gen)
        return self.ffn_layer_norm(x + h)


class TransformerEncoder(nn.Module):
    """Post-LN transformer encoder (BERT / DistilBERT family)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.eval()  # deterministic until a train step asks for training

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None,
                position_ids: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """``segment_ids`` (1..S, 0 = pad) with ``position_ids`` restarting
        per segment encode packed rows; ``attention_mask`` is then unused."""
        x = self.embeddings(input_ids, position_ids, gen)
        bias = attention_bias(attention_mask, segment_ids, self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, bias, gen)
        return x

    @property
    def word_embedding_table(self) -> torch.Tensor:
        return self.embeddings.word.weight


class MLMHead(nn.Module):
    """Masked-LM head: transform -> gelu -> LayerNorm -> vocab projection
    (tied to ``shared_embedding`` when given) + a per-vocab bias."""

    def __init__(self, cfg: EncoderConfig, tied: bool = True):
        super().__init__()
        H = cfg.hidden_size
        self.transform = Dense(H, H)
        self.layer_norm = LayerNorm(H, cfg.layer_norm_eps)
        if not tied:
            self.decoder = Dense(H, cfg.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def projection(self, hidden: torch.Tensor,
                   shared_embedding: torch.Tensor | None = None):
        """The vocabulary projection before the bias, in the compute
        dtype: the logits are ``projection + bias`` (``forward``)."""
        h = self.layer_norm(F.gelu(self.transform(hidden)))
        if shared_embedding is not None:
            return F.linear(h, shared_embedding.to(h.dtype))
        return self.decoder(h)

    def forward(self, hidden: torch.Tensor,
                shared_embedding: torch.Tensor | None = None):
        proj = self.projection(hidden, shared_embedding)
        return proj + self.bias.to(proj.dtype)


class EncoderWithMLM(nn.Module):
    """Encoder + MLM head; ``tie_word_embeddings`` reuses the word-embedding
    table as the vocabulary projection (HF DistilBERT / BERT default)."""

    def __init__(self, cfg: EncoderConfig, tie_word_embeddings: bool = True):
        super().__init__()
        self.tie_word_embeddings = tie_word_embeddings
        self.encoder = TransformerEncoder(cfg)
        self.mlm = MLMHead(cfg, tied=tie_word_embeddings)
        self.eval()

    def _shared(self) -> torch.Tensor | None:
        return (self.encoder.word_embedding_table
                if self.tie_word_embeddings else None)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.mlm(hidden, self._shared())

    def projection(self, hidden: torch.Tensor) -> torch.Tensor:
        """The logits before the MLM bias (``MLMHead.projection``)."""
        return self.mlm.projection(hidden, self._shared())

    @property
    def vocab_bias(self) -> torch.Tensor:
        """The MLM bias: the logits are ``projection + vocab_bias``."""
        return self.mlm.bias

    def forward(self, input_ids, attention_mask, position_ids=None,
                segment_ids=None, gen=None):
        hidden = self.encoder(input_ids, attention_mask, position_ids,
                              segment_ids, gen)
        return hidden, self.logits(hidden)


def compute_copy(module: nn.Module, dtype: torch.dtype,
                 device: torch.device) -> nn.Module:
    """A copy of ``module`` on ``device`` whose linear, embedding and MLM
    bias parameters are stored in ``dtype``, so the per-call casts of the
    forward pass become no-ops.  The results are the same: the reference
    casts these parameters to the compute dtype before use; LayerNorm keeps
    its f32 parameters.  For inference: training goes through the f32
    parameters themselves, which a copy would not update."""
    out = copy.deepcopy(module).to(device)
    if dtype == torch.float32:
        return out
    for m in out.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.to(dtype)
        elif isinstance(m, MLMHead):
            m.bias.data = m.bias.data.to(dtype)
    return out
