"""The transformer encoder of every retriever family, in PyTorch.

Port of ``dhr_tpu/models/transformer.py`` for plain rows (one document per
row; the packed-row branch with block-diagonal attention is not ported
yet).  A post-LN BERT / DistilBERT encoder with an optional MLM head whose
vocabulary projection is tied to the word-embedding table.  Module and
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
- GELU is exact (erf); the MLM bias is added in the compute dtype.

The port runs inference only, so dropout is never applied.
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

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        L = input_ids.shape[-1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(f"rows of {L} tokens exceed the model's "
                             f"{self.cfg.max_position_embeddings} positions")
        pos = torch.arange(L, device=input_ids.device)
        x = (F.embedding(input_ids, self.word.weight.to(dt))
             + F.embedding(pos, self.position.weight.to(dt))[None])
        if self.cfg.type_vocab_size > 0:  # token type 0 everywhere
            x = x + self.token_type.weight[0].to(dt)
        return self.layer_norm(x)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        H = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = H // cfg.num_heads
        self.query, self.key, self.value, self.out = (
            Dense(H, H) for _ in range(4))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor):
        B, L, H = x.shape

        def heads(t):  # (B, L, H) -> (B, heads, L, head_dim)
            return t.view(B, L, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scale = float(torch.tensor(float(self.head_dim), dtype=x.dtype).sqrt())
        scores = torch.matmul(q, k.transpose(-1, -2)) / scale + mask_bias
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(x.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, H)
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

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor):
        x = self.attn_layer_norm(x + self.attention(x, mask_bias))
        h = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ffn_layer_norm(x + h)


class TransformerEncoder(nn.Module):
    """Post-LN transformer encoder (BERT / DistilBERT family)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        # additive key bias: 0 where attended, -1e9 where masked
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           -1e9).to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, bias)
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

    def forward(self, hidden: torch.Tensor,
                shared_embedding: torch.Tensor | None = None):
        h = self.layer_norm(F.gelu(self.transform(hidden)))
        if shared_embedding is not None:
            logits = F.linear(h, shared_embedding.to(h.dtype))
        else:
            logits = self.decoder(h)
        return logits + self.bias.to(h.dtype)


class EncoderWithMLM(nn.Module):
    """Encoder + MLM head; ``tie_word_embeddings`` reuses the word-embedding
    table as the vocabulary projection (HF DistilBERT / BERT default)."""

    def __init__(self, cfg: EncoderConfig, tie_word_embeddings: bool = True):
        super().__init__()
        self.tie_word_embeddings = tie_word_embeddings
        self.encoder = TransformerEncoder(cfg)
        self.mlm = MLMHead(cfg, tied=tie_word_embeddings)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        shared = (self.encoder.word_embedding_table
                  if self.tie_word_embeddings else None)
        return self.mlm(hidden, shared)

    def forward(self, input_ids, attention_mask):
        hidden = self.encoder(input_ids, attention_mask)
        return hidden, self.logits(hidden)


def compute_copy(module: nn.Module, dtype: torch.dtype,
                 device: torch.device) -> nn.Module:
    """A copy of ``module`` on ``device`` whose linear, embedding and MLM
    bias parameters are stored in ``dtype``, so the per-call casts of the
    forward pass become no-ops.  The results are the same: the reference
    casts these parameters to the compute dtype before use; LayerNorm keeps
    its f32 parameters."""
    out = copy.deepcopy(module).to(device)
    if dtype == torch.float32:
        return out
    for m in out.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.to(dtype)
        elif isinstance(m, MLMHead):
            m.bias.data = m.bias.data.to(dtype)
    return out
