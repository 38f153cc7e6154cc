"""A DHR bi-encoder tower on a DeepSeek-V2-family decoder in plain PyTorch,
f32, run layer by layer.

Reads the weights of ``benchmarks.gen.weights_decoder`` by their names,
drawing one layer's at a time (``layer_weights``), so that the reference
of a model of 15.7B parameters needs one layer's f32 weights and the
checked passages' hidden states, not the model.  The maths is Hugging
Face's ``modeling_deepseek.py`` (DeepSeek-V2) with the DHR head of Lin et
al. 2022 (castorini/dhr):

- embeddings, then per layer (pre-norm): ``x += MLA(RMSNorm(x))``, ``x +=
  FFN(RMSNorm(x))``; a final RMSNorm;
- MLA: ``q_proj`` to ``n`` heads of ``[q_nope | q_pe]``;
  ``kv_a_proj_with_mqa`` to ``[c | k_pe]``; ``kv_b_proj(RMSNorm(c))`` to
  ``[k_nope | v]``; the rope half de-interleaved and rotated by YaRN's
  frequencies; causal softmax attention with the pads' keys masked, at
  ``(d_nope + d_rope) ** -0.5 * m^2``, ``m = 0.1 * mscale_all_dim *
  ln(factor) + 1``; ``o_proj``;
- FFN: SwiGLU on the first ``first_k_dense_replace`` layers, then a
  softmax gate over the experts, the greedy top ``k`` scores as weights
  (times ``routed_scaling_factor``), each token's ``k`` experts' SwiGLU
  weighted and summed, plus the shared experts' SwiGLU;
- lexical rep: ``max over positions 1..L-1 of softmax(lm_head(h)) *
  term_weight(h) * mask`` of the final-normed ``h``; semantic rep: the
  pooler of ``h`` at each passage's last real token.

Everything in f32 with TF32 off (the driver calls ``no_tf32``), the
passages right-padded (pads touch no real position: causal order and the
key mask keep them out).  ``Math("fp8")`` is the control, as in
``reference.dhr_model``: every matrix product, the gate's, attention's and
the LM head's included, takes its operands rounded to float8 e4m3.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.gen.weights_decoder import is_moe, layer_weights, \
    outer_weights
from benchmarks.reference.dhr_model import Math


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_inv_freq(d: dict, device) -> torch.Tensor:
    dim, base = d["d_rope"], d["theta"]
    i2 = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / base ** (i2 / dim)
    inter = extra / d["rope_factor"]

    def corr(r):
        return dim * math.log(d["rope_orig"] / (2 * math.pi * r)) \
            / (2 * math.log(base))

    low = max(math.floor(corr(d["beta_fast"])), 0)
    high = min(math.ceil(corr(d["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / max(high - low, 0.001)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope(t, cos, sin):
    dim = t.shape[-1]
    t = t.view(*t.shape[:-1], dim // 2, 2).transpose(-1, -2).reshape(t.shape)
    rot = torch.cat([-t[..., dim // 2:], t[..., :dim // 2]], dim=-1)
    return t * cos + rot * sin


def swiglu(x, wg, wu, wd, m: Math):
    return m.mm(F.silu(m.mm(x, wg.T)) * m.mm(x, wu.T), wd.T)


def mla(W, p, d, x, mask, cos, sin, m: Math):
    B, L, _ = x.shape
    n, dn, dr, dv = d["heads"], d["d_nope"], d["d_rope"], d["d_v"]
    a = p + "self_attn."
    q = m.mm(x, W[a + "q_proj.weight"].T).view(B, L, n, dn + dr) \
        .transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = m.mm(x, W[a + "kv_a_proj_with_mqa.weight"].T)
    c, k_pe = ckv[..., :d["kv_rank"]], ckv[..., d["kv_rank"]:]
    kv = m.mm(rms(c, W[a + "kv_a_layernorm.weight"], d["eps"]),
              W[a + "kv_b_proj.weight"].T).view(B, L, n, dn + dv) \
        .transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, rope(q_pe, cos, sin)], dim=-1)
    k_pe = rope(k_pe[:, None], cos, sin).expand(B, n, L, dr)
    k = torch.cat([k_nope, k_pe], dim=-1)
    ms = mscale(d["rope_factor"], d["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * ms * ms
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    allowed = causal[None, None] & (mask[:, None, None, :] > 0)
    s = m.mm(q, k.transpose(-1, -2)) * scale
    s = torch.where(allowed, s, -1e30)
    ctx = m.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, L, -1)
    return m.mm(ctx, W[a + "o_proj.weight"].T)


def moe(W, p, d, x, m: Math, real=None, ties=None):
    """``ties``: a list to which ``[near ties, token-layers]`` of the real
    tokens is appended (6th and 7th gate scores within 1% of the 6th)."""
    shape = x.shape
    t = x.reshape(-1, shape[-1])
    q = p + "mlp."
    scores = torch.softmax(m.mm(t, W[q + "gate.weight"].T), dim=-1)
    k = d["top_k"]
    top, idx = torch.topk(scores, min(k + 1, scores.shape[-1]), dim=-1)
    if ties is not None and top.shape[-1] > k:
        near = (top[:, k - 1] - top[:, k]) < 0.01 * top[:, k - 1]
        keep = real.reshape(-1) > 0
        ties.append([int((near & keep).sum()), int(keep.sum())])
    w, idx = top[:, :k], idx[:, :k]
    if d["norm_topk"] and k > 1:
        w = w / w.sum(dim=-1, keepdim=True)
    else:
        w = w * d["routed_scale"]
    y = torch.zeros_like(t)
    e = q + "experts."
    for ex in range(d["experts"]):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)
        if tok.numel():
            out = swiglu(t[tok], W[e + "gate_proj"][ex], W[e + "up_proj"][ex],
                         W[e + "down_proj"][ex], m)
            y.index_add_(0, tok, out * w[tok, slot, None])
    if d["shared"]:
        s = q + "shared_experts."
        y = y + swiglu(t, W[s + "gate_proj.weight"], W[s + "up_proj.weight"],
                       W[s + "down_proj.weight"], m)
    return y.view(shape)


def dense_ffn(W, p, d, x, m: Math):
    q = p + "mlp."
    return swiglu(x, W[q + "gate_proj.weight"], W[q + "up_proj.weight"],
                  W[q + "down_proj.weight"], m)


def dhr_reps(d: dict, seed: int, ids: torch.Tensor, mask: torch.Tensor,
             m: Math, block: int = 16, ties=None, weights=None):
    """``(lexical (n, V), semantic (n, proj))`` f32 of right-padded
    passages ``ids`` (n, L), each layer's weights drawn once (or read
    from ``weights``, a dict of every tensor in f32) and applied to
    ``block`` passages at a time."""
    dev = ids.device
    get = (lambda i: weights) if weights is not None else (
        lambda i: layer_weights(d, seed, i, dev))
    outer = weights if weights is not None else outer_weights(d, seed, dev)
    n, L = ids.shape
    x = outer["model.embed_tokens.weight"][ids.long()]
    freqs = torch.outer(torch.arange(L, dtype=torch.float32, device=dev),
                        yarn_inv_freq(d, dev))
    emb = torch.cat([freqs, freqs], dim=-1)
    sc = mscale(d["rope_factor"], d["mscale"]) \
        / mscale(d["rope_factor"], d["mscale_all_dim"])
    cos, sin = emb.cos() * sc, emb.sin() * sc
    for i in range(d["layers"]):
        W = get(i)
        p = f"model.layers.{i}."
        for s in range(0, n, block):
            xb, mb = x[s:s + block], mask[s:s + block]
            xb = xb + mla(W, p, d, rms(xb, W[p + "input_layernorm.weight"],
                                       d["eps"]), mb, cos, sin, m)
            h = rms(xb, W[p + "post_attention_layernorm.weight"], d["eps"])
            h = moe(W, p, d, h, m, mb, ties) if is_moe(d, i) \
                else dense_ffn(W, p, d, h, m)
            x[s:s + block] = xb + h
        del W
    lex, sem = [], []
    last = mask.sum(dim=1).long() - 1
    for s in range(0, n, block):
        h = rms(x[s:s + block], outer["model.norm.weight"], d["eps"])
        mb = mask[s:s + block]
        logits = m.mm(h[:, 1:], outer["lm_head.weight"].T)
        tw = m.mm(h[:, 1:], outer["term_weight.linear.weight"].T) \
            + outer["term_weight.linear.bias"]
        weighted = torch.softmax(logits, dim=-1) * (tw * mb[:, 1:, None])
        lex.append(weighted.amax(dim=1))
        hl = h[torch.arange(h.shape[0], device=dev), last[s:s + block]]
        sem.append(m.mm(hl, outer["pooler.linear.weight"].T)
                   + outer["pooler.linear.bias"])
    return torch.cat(lex), torch.cat(sem)
