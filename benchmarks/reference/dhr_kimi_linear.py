"""A DHR bi-encoder tower on a Kimi Linear decoder in plain PyTorch, f32,
run layer by layer.

Reads the weights of ``benchmarks.gen.weights_kimi`` by their names,
drawing one layer's at a time (``layer_weights``), so that the reference
of a model of 25.6B parameters needs one layer's f32 weights and the
checked documents' hidden states, not the model.  The maths is Hugging
Face's ``modeling_kimi.py`` (Kimi-Linear-48B-A3B; the Kimi Linear report,
arXiv:2510.26692) with the DHR head of Lin et al. 2022 (castorini/dhr):

- embeddings, then per layer (pre-norm): ``x += ATTN(RMSNorm(x))``, ``x +=
  FFN(RMSNorm(x))``; a final RMSNorm;
- KDA on the layers ``kda_layers`` names (1-based): ``q, k, v =
  SiLU(causal depthwise conv(x W_c))``, ``q, k`` L2-normed per head (eps
  1e-6), ``q`` scaled by ``d ** -0.5``; ``g = -exp(A_log) * softplus(f_b(
  f_a(x)) + dt_bias)``; ``beta = sigmoid(b_proj(x))``; the recurrence
  token by token, ``S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} +
  beta_t k_t v_t^T``, ``o_t = S_t^T q_t`` from ``S_0 = 0``;
  ``o_proj(RMSNorm_head(o) * sigmoid(g_b(g_a(x))))``;
- MLA on the others, without positions: ``[q_nope | q_pe]`` against
  ``[k_nope | k_pe]`` unrotated, causal softmax over the real keys at
  ``(d_nope + d_rope) ** -0.5``, a document at a time;
- FFN: SwiGLU on the first ``first_k_dense_replace`` layers, then a
  sigmoid router over all the published experts, the top ``k`` of score +
  ``e_score_correction_bias``, the chosen scores renormalised (+1e-20) x
  ``routed_scaling_factor``; the terms of the experts this chip holds
  (a loop over them), plus the shared expert.  Given the experts a
  program chose for each real token (``routes``), it takes those instead
  and logs how far each choice falls below its own top ``k``: the
  random router's near ties would otherwise turn rounding into another
  expert, so the reps compare arithmetic and the route gap compares the
  choice;
- lexical rep: ``max over positions 1..L-1 of softmax(lm_head(h)) *
  term_weight(h) * mask`` of the final-normed ``h``, a document at a
  time; semantic rep: the pooler of ``h`` at each document's last real
  token.

Everything in f32 with TF32 off (``drivers/encode_docs_kimi.py`` calls
``no_tf32``), the documents right-padded (pads touch no real position:
causal order, the causal convolutions and recurrence, and the key mask
keep them out).
``Math("fp8")`` is the control, as in ``reference.dhr_model``: every
matrix product, the router's, attention's, the recurrence's and the LM
head's included, takes its operands rounded to float8 e4m3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmarks.gen.weights_kimi import is_kda, is_moe, layer_weights, \
    outer_weights
from benchmarks.reference.dhr_decoder import rms
from benchmarks.reference.dhr_model import Math


def l2norm(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def short_conv(x, w):
    """Causal depthwise convolution of ``x`` (B, L, D) by ``w`` (D, 1, K),
    tap by tap, then SiLU."""
    K, L = w.shape[-1], x.shape[1]
    y = torch.zeros_like(x)
    for j in range(K):
        lag = K - 1 - j
        y[:, lag:] += x[:, :L - lag] * w[:, 0, j]
    return F.silu(y)


def swiglu(x, wg, wu, wd, m: Math):
    return m.mm(F.silu(m.mm(x, wg.T)) * m.mm(x, wu.T), wd.T)


def kda(W, a, d, x, m: Math):
    B, L, _ = x.shape
    h, k = d["kda_heads"], d["kda_dim"]
    heads = (B, L, h, k)
    q, kk, v = (short_conv(m.mm(x, W[f"{a}{c}_proj.weight"].T),
                           W[f"{a}{c}_conv1d.weight"]).view(heads)
                for c in "qkv")
    q, kk = l2norm(q) * k ** -0.5, l2norm(kk)
    g = m.mm(m.mm(x, W[a + "f_a_proj.weight"].T),
             W[a + "f_b_proj.weight"].T).view(heads)
    g = -W[a + "A_log"].view(h, 1).exp() \
        * F.softplus(g + W[a + "dt_bias"].view(h, k))
    beta = torch.sigmoid(m.mm(x, W[a + "b_proj.weight"].T))
    S = torch.zeros(B, h, k, k, dtype=x.dtype, device=x.device)
    o = torch.empty(B, L, h, k, dtype=x.dtype, device=x.device)
    for t in range(L):
        kt, bt = kk[:, t, :, :, None], beta[:, t, :, None, None]
        S = S * g[:, t].exp()[..., None]
        S = S + bt * kt * (v[:, t, :, None, :] - m.mm(kt.transpose(-1, -2),
                                                      S))
        o[:, t] = m.mm(q[:, t, :, None, :], S)[..., 0, :]
    gate = torch.sigmoid(m.mm(m.mm(x, W[a + "g_a_proj.weight"].T),
                              W[a + "g_b_proj.weight"].T)
                         + W[a + "g_b_proj.bias"]).view(heads)
    o = rms(o, W[a + "o_norm.weight"], d["eps"]) * gate
    return m.mm(o.reshape(B, L, h * k), W[a + "o_proj.weight"].T)


def mla_nope(W, a, d, x, mask, m: Math):
    B, L, _ = x.shape
    n, dn, dr, dv = d["heads"], d["d_nope"], d["d_rope"], d["d_v"]
    q = m.mm(x, W[a + "q_proj.weight"].T).view(B, L, n, dn + dr) \
        .transpose(1, 2)
    ckv = m.mm(x, W[a + "kv_a_proj_with_mqa.weight"].T)
    kv = m.mm(rms(ckv[..., :d["kv_rank"]], W[a + "kv_a_layernorm.weight"],
                  d["eps"]), W[a + "kv_b_proj.weight"].T) \
        .view(B, L, n, dn + dv).transpose(1, 2)
    k = torch.cat([kv[..., :dn],
                   ckv[:, None, :, d["kv_rank"]:].expand(B, n, L, dr)], -1)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    out = []
    for b in range(B):      # a document at a time: (n, L, L) scores
        s = m.mm(q[b], k[b].transpose(-1, -2)) * (dn + dr) ** -0.5
        s = torch.where(causal & (mask[b, None, :] > 0), s, -1e30)
        out.append(m.mm(torch.softmax(s, dim=-1), kv[b, ..., dn:]))
    ctx = torch.stack(out).transpose(1, 2).reshape(B, L, n * dv)
    return m.mm(ctx, W[a + "o_proj.weight"].T)


def moe(W, p, d, x, mask, m: Math, ties=None, routes=None, log=None,
        no_bias: bool = False):
    """The real tokens' FFN (pads get 0).  ``ties``: a list to which
    ``[near ties, real tokens]`` is appended (the 8th and 9th choice
    scores within 1% of the 8th).  ``routes``: the ``(real tokens, k)``
    experts to take instead of its own top ``k`` (a program's, the real
    tokens in row-major order); the weights are still its own scores'.
    ``log``: a dict whose ``"routes"`` list gets the experts taken and
    whose ``"gaps"`` list gets ``[the largest choice score gap, tokens
    whose experts differ from its own top k, tokens]``; a token's gap is
    its own k-th best choice score less the least choice score of the
    experts taken (0 where they are its own top k).  ``no_bias``: the
    choice leaves out the correction bias (a planted fault)."""
    shape = x.shape
    keep = mask.reshape(-1) > 0
    t = x.reshape(-1, shape[-1])[keep]
    q = p + "mlp."
    scores = torch.sigmoid(m.mm(t, W[q + "gate.weight"].T))
    choice = scores if no_bias else \
        scores + W[q + "gate.e_score_correction_bias"]
    k = d["top_k"]
    top, idx = torch.topk(choice, min(k + 1, choice.shape[-1]), dim=-1)
    if ties is not None and top.shape[-1] > k:
        near = (top[:, k - 1] - top[:, k]) < 0.01 * top[:, k - 1].abs()
        ties.append([int(near.sum()), int(t.shape[0])])
    if routes is not None:
        idx = routes.to(device=x.device, dtype=torch.long)
        if log is not None and t.shape[0]:
            gap = top[:, k - 1] - choice.gather(1, idx).amin(dim=-1)
            log["gaps"].append([float(gap.max()), int((gap > 0).sum()),
                                int(t.shape[0])])
    idx = idx[:, :k]
    if log is not None:
        log["routes"].append(idx)
    w = scores.gather(1, idx)
    if d["renormalize"] and k > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * d["routed_scale"]
    y = torch.zeros_like(t)
    e = q + "experts."
    lo, hi = d["held"]
    for ex in range(lo, hi):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)
        if tok.numel():
            j = ex - lo
            out = swiglu(t[tok], W[e + "gate_proj"][j], W[e + "up_proj"][j],
                         W[e + "down_proj"][j], m)
            y.index_add_(0, tok, out * w[tok, slot, None])
    if d["shared"]:
        s = q + "shared_experts."
        y = y + swiglu(t, W[s + "gate_proj.weight"], W[s + "up_proj.weight"],
                       W[s + "down_proj.weight"], m)
    full = torch.zeros(keep.shape[0], shape[-1], dtype=x.dtype,
                       device=x.device)
    full[keep] = y
    return full.view(shape)


def dense_ffn(W, p, d, x, m: Math):
    q = p + "mlp."
    return swiglu(x, W[q + "gate_proj.weight"], W[q + "up_proj.weight"],
                  W[q + "down_proj.weight"], m)


def dhr_reps(d: dict, seed: int, ids: torch.Tensor, mask: torch.Tensor,
             m: Math, block: int = 16, ties=None, weights=None,
             routes=None, log=None, no_bias: bool = False):
    """``(lexical (n, V), semantic (n, proj))`` f32 of right-padded
    documents ``ids`` (n, L), each layer's weights drawn once (or read
    from ``weights``, a dict of every tensor in f32) and applied to
    ``block`` documents at a time; the LM head a document at a time.

    ``routes``: per document, per MoE layer in order, the ``(real tokens,
    k)`` experts to take (:func:`moe`'s); ``log``: a dict that gets
    ``"routes"`` in that form (the experts taken) and ``"gaps"``, one
    ``[largest gap, tokens off its own top k, tokens]`` a MoE layer and
    block (:func:`moe`'s)."""
    dev = ids.device
    get = (lambda i: weights) if weights is not None else (
        lambda i: layer_weights(d, seed, i, dev))
    outer = weights if weights is not None else outer_weights(d, seed, dev)
    n = ids.shape[0]
    x = outer["model.embed_tokens.weight"][ids.long()]
    real = mask.sum(dim=1).long().tolist()
    taken = [[] for _ in range(n)]
    for i in range(d["layers"]):
        W = get(i)
        p = f"model.layers.{i}."
        j = sum(is_moe(d, a) for a in range(i))    # the MoE layer's place
        for s in range(0, n, block):
            xb, mb = x[s:s + block], mask[s:s + block]
            hb = rms(xb, W[p + "input_layernorm.weight"], d["eps"])
            a = p + "self_attn."
            xb = xb + (kda(W, a, d, hb, m) if is_kda(d, i)
                       else mla_nope(W, a, d, hb, mb, m))
            h = rms(xb, W[p + "post_attention_layernorm.weight"], d["eps"])
            if is_moe(d, i):
                given = None if routes is None else torch.cat(
                    [r[j] for r in routes[s:s + block]])
                part = None if log is None else {"routes": [],
                                                 "gaps": log["gaps"]}
                h = moe(W, p, d, h, mb, m, ties, given, part, no_bias)
                if part is not None:
                    for b, r in enumerate(part["routes"][0].split(
                            real[s:s + block])):
                        taken[s + b].append(r)
            else:
                h = dense_ffn(W, p, d, h, m)
            x[s:s + block] = xb + h
        del W
    if log is not None:
        log["routes"] = taken
    lex, sem = [], []
    last = mask.sum(dim=1).long() - 1
    for j in range(n):
        h = rms(x[j], outer["model.norm.weight"], d["eps"])
        logits = m.mm(h[1:], outer["lm_head.weight"].T)
        tw = m.mm(h[1:], outer["term_weight.linear.weight"].T) \
            + outer["term_weight.linear.bias"]
        weighted = torch.softmax(logits, dim=-1) * (tw * mask[j, 1:, None])
        lex.append(weighted.amax(dim=0))
        del logits, weighted
        sem.append(m.mm(h[last[j]], outer["pooler.linear.weight"].T)
                   + outer["pooler.linear.bias"])
    return torch.stack(lex), torch.stack(sem)
