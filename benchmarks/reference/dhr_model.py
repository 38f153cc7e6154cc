"""A DHR bi-encoder tower in plain PyTorch: a post-LN BERT / DistilBERT
encoder, the DHR lexical head and the CLS projection, and densification.

Reads the weights of ``benchmarks.gen.weights`` by their names.  The maths
is the published model's (Devlin et al. 2019; Sanh et al. 2019) with the
DHR head of Lin et al. 2022 (castorini/dhr):

- embeddings: word + position (+ token type 0) -> LayerNorm;
- each layer: multi-head self-attention with an additive -1e9 key mask,
  output projection, residual, LayerNorm; GELU (erf) FFN, residual,
  LayerNorm;
- lexical rep: ``max over positions 1..L-1 of softmax(MLM logits) *
  term_weight * mask``, the MLM logits from transform -> GELU -> LayerNorm
  -> the word embedding table (tied) + bias;
- semantic rep: a linear projection of the [CLS] hidden state;
- densify: drop the first ``remove_dims`` vocabulary slots, view the rest
  as ``(k, out_dim)`` and take the max over ``k`` and its first argmax;
- dropout (train steps only, :class:`Dropout`) at BERT's four sites: the
  embeddings, the attention probabilities, the attention output and the
  FFN output.

``precision="fp8"`` is the control: every matrix product takes its two
operands rounded to float8 e4m3 (each scaled by its own absolute maximum
to the format's range) and multiplies them in f32; gradients pass the
rounding straight through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Dropout:
    """A train step's dropout: at each site, in the order the model meets
    them, one uniform draw of the activation's shape from ``gen`` (float32,
    on the activation's device); an element is kept where its draw reaches
    ``p`` and is then scaled by ``1 / (1 - p)``.  ``hidden`` and
    ``attention`` are the configuration's two rates."""

    def __init__(self, hidden: float, attention: float, gen):
        self.hidden, self.attention, self.gen = hidden, attention, gen

    def __call__(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if p == 0.0:
            return x
        draw = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(draw >= p, x / (1.0 - p), 0.0)


def _no_dropout(x: torch.Tensor, _p: float) -> torch.Tensor:
    return x


class Math:
    """The matrix product and its precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = _fp8 if precision == "fp8" else (lambda t: t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))

    def linear(self, x, w, b):
        return self.mm(x, w.T) + b


def encoder(W: dict, d: dict, ids: torch.Tensor, mask: torch.Tensor,
            m: Math, drop: Dropout | None = None) -> torch.Tensor:
    """Hidden states ``(B, L, H)`` f32 (``drop``: a train step's
    dropout)."""
    dr = drop or _no_dropout
    ph = drop.hidden if drop else 0.0
    pa = drop.attention if drop else 0.0
    B, L = ids.shape
    H, nh = d["hidden"], d["heads"]
    dh = H // nh
    eps = d["eps"]
    x = W["emb.word"][ids.long()] + W["emb.pos"][:L][None]
    if d["types"]:
        x = x + W["emb.type"][0]
    x = dr(F.layer_norm(x, (H,), W["emb.ln.w"], W["emb.ln.b"], eps), ph)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    for i in range(d["layers"]):
        p = f"l{i}."

        def heads(t):
            return t.view(B, L, nh, dh).transpose(1, 2)

        q = heads(m.linear(x, W[p + "q.w"], W[p + "q.b"]))
        k = heads(m.linear(x, W[p + "k.w"], W[p + "k.b"]))
        v = heads(m.linear(x, W[p + "v.w"], W[p + "v.b"]))
        s = m.mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
        ctx = m.mm(dr(torch.softmax(s, dim=-1), pa), v)
        ctx = ctx.transpose(1, 2).reshape(B, L, H)
        attn = dr(m.linear(ctx, W[p + "o.w"], W[p + "o.b"]), ph)
        x = F.layer_norm(x + attn, (H,), W[p + "ln1.w"], W[p + "ln1.b"], eps)
        h = F.gelu(m.linear(x, W[p + "ffn1.w"], W[p + "ffn1.b"]))
        h = dr(m.linear(h, W[p + "ffn2.w"], W[p + "ffn2.b"]), ph)
        x = F.layer_norm(x + h, (H,), W[p + "ln2.w"], W[p + "ln2.b"], eps)
    return x


def dhr_reps(W: dict, d: dict, ids: torch.Tensor, mask: torch.Tensor,
             m: Math, drop: Dropout | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lexical (B, V), semantic (B, proj))`` f32."""
    h = encoder(W, d, ids, mask, m, drop)
    hh = h[:, 1:]
    t = F.layer_norm(F.gelu(m.linear(hh, W["mlm.t.w"], W["mlm.t.b"])),
                     (d["hidden"],), W["mlm.ln.w"], W["mlm.ln.b"], d["eps"])
    logits = m.mm(t, W["emb.word"].T) + W["mlm.bias"]
    tw = m.linear(hh, W["tw.w"], W["tw.b"])                      # (B, L-1, 1)
    weighted = torch.softmax(logits, dim=-1) * (tw * mask[:, 1:, None])
    lexical = weighted.amax(dim=1)
    semantic = m.linear(h[:, 0], W["pool.w"], W["pool.b"])
    return lexical, semantic


def densify(lexical: torch.Tensor, out_dim: int, remove_dims: int):
    """``(values (B, out_dim), folds (B, out_dim) int64)``: the max over
    the ``k`` folds of each slot and the first fold that reaches it."""
    B, V = lexical.shape
    k = (V - remove_dims) // out_dim
    folded = lexical[:, remove_dims:remove_dims + k * out_dim].reshape(
        B, k, out_dim)
    values = folded.amax(dim=1)
    first = (folded == values[:, None, :]).int().argmax(dim=1)
    return values, first


def fold_lanes(lexical: torch.Tensor, out_dim: int, remove_dims: int):
    """``(B, k, out_dim)``: every fold's value of every slot."""
    B, V = lexical.shape
    k = (V - remove_dims) // out_dim
    return lexical[:, remove_dims:remove_dims + k * out_dim].reshape(
        B, k, out_dim)
