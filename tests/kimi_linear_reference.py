"""A plain f32 reference of the Kimi Linear decoder and of the DHR head on
it, for the port's tests.

Written from Hugging Face's ``modeling_kimi.py`` (Kimi-Linear-48B-A3B)
and the Kimi Linear report (arXiv:2510.26692) in plain PyTorch; it
imports neither JAX nor anything of the port, and turns TF32 off.  KDA's
recurrence runs token by token exactly as written (not chunked)::

    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

MLA attends without positions (softmax over the causal, unmasked keys),
and the MoE loops over the experts a layer holds (``held``, a range of
the routed experts; all by default), each routed token's term weighted by
its sigmoid router's renormalised score.  Weights are a dict under the
published checkpoint's names: KDA's ``self_attn.{q,k,v}_proj``,
``{q,k,v}_conv1d`` ``(D, 1, size)``, ``A_log`` ``(1, 1, h, 1)``,
``f_a_proj``, ``f_b_proj``, ``dt_bias``, ``b_proj``, ``g_a_proj``,
``g_b_proj`` (weight and bias), ``o_norm``, ``o_proj``; the MoE's
``block_sparse_moe.gate.weight`` and ``.e_score_correction_bias``, one
expert's ``block_sparse_moe.experts.{e}.w1`` (gate), ``w3`` (up) and
``w2`` (down), ``block_sparse_moe.shared_experts.{gate,up,down}_proj``;
the dense layer's ``mlp.*``; the DHR head's ``term_weight.linear.*`` and
``pooler.linear.*``.  ``cfg`` is a dict of the ``kimi_linear``
config.json's keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def l2norm(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def short_conv(x, w):
    """Causal depthwise convolution of ``x`` (B, L, D) by ``w`` (D, 1, K),
    tap by tap, then SiLU."""
    K = w.shape[-1]
    y = torch.zeros_like(x)
    for j in range(K):          # tap j reads position t - (K - 1 - j)
        lag = K - 1 - j
        y[:, lag:] += x[:, :x.shape[1] - lag] * w[:, 0, j]
    return F.silu(y)


def kda_recurrence(q, k, v, g, beta):
    """``o`` (B, L, h, d_v): the recurrence token by token from L2-normed,
    scaled ``q``, L2-normed ``k``, ``v``, log-decays ``g`` (B, L, h, d)
    and ``beta`` (B, L, h), the state ``S`` (B, h, d, d_v) from 0, in
    ``q``'s dtype and on its device (f64 for an exact yardstick)."""
    B, L, h, d = k.shape
    S = torch.zeros(B, h, d, v.shape[-1], dtype=q.dtype, device=q.device)
    out = torch.zeros(B, L, h, v.shape[-1], dtype=q.dtype, device=q.device)
    for t in range(L):
        kt, bt = k[:, t], beta[:, t, :, None, None]
        S = S * g[:, t].exp()[..., None]
        S = S - bt * kt[..., None] * (kt[..., None, :] @ S) \
            + bt * kt[..., None] * v[:, t, :, None, :]
        out[:, t] = (q[:, t, :, None, :] @ S)[..., 0, :]
    return out


def kda(cfg, W, a, x):
    """A KDA layer's output (before the residual) of normed ``x``."""
    B, L, _ = x.shape
    lc = cfg["linear_attn_config"]
    h, d = lc["num_heads"], lc["head_dim"]
    heads = (B, L, h, d)
    q, k, v = (short_conv(F.linear(x, W[f"{a}{c}_proj.weight"]),
                          W[f"{a}{c}_conv1d.weight"]).view(heads)
               for c in "qkv")
    q = l2norm(q) * d ** -0.5
    k = l2norm(k)
    g = F.linear(F.linear(x, W[a + "f_a_proj.weight"]),
                 W[a + "f_b_proj.weight"]).view(heads)
    g = -W[a + "A_log"].view(h, 1).exp() \
        * F.softplus(g + W[a + "dt_bias"].view(h, d))
    beta = torch.sigmoid(F.linear(x, W[a + "b_proj.weight"]))
    o = kda_recurrence(q, k, v, g, beta)
    gate = torch.sigmoid(F.linear(F.linear(x, W[a + "g_a_proj.weight"]),
                                  W[a + "g_b_proj.weight"],
                                  W[a + "g_b_proj.bias"])).view(heads)
    o = rms_norm(o, W[a + "o_norm.weight"], cfg["rms_norm_eps"]) * gate
    return F.linear(o.reshape(B, L, h * d), W[a + "o_proj.weight"])


def mla_nope(cfg, W, a, x, mask):
    """MLA without positions: ``[q_nope | q_pe]`` against ``[k_nope |
    k_pe]`` unrotated, scale ``(d_nope + d_rope) ** -0.5``, a causal
    softmax over the real keys, one query at a time."""
    B, L, _ = x.shape
    n = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = F.linear(x, W[a + "q_proj.weight"]).view(B, L, n, dn + dr)
    ckv = F.linear(x, W[a + "kv_a_proj_with_mqa.weight"])
    kv = F.linear(rms_norm(ckv[..., :rank], W[a + "kv_a_layernorm.weight"],
                           cfg["rms_norm_eps"]),
                  W[a + "kv_b_proj.weight"]).view(B, L, n, dn + dv)
    k = torch.cat([kv[..., :dn], ckv[..., None, rank:].expand(B, L, n, dr)],
                  dim=-1)
    out = torch.zeros(B, L, n, dv)
    for b in range(B):
        for t in range(L):
            ok = [j for j in range(t + 1) if mask[b, j] > 0]
            if not ok:
                continue
            s = torch.einsum("nd,jnd->nj", q[b, t], k[b, ok]) \
                * (dn + dr) ** -0.5
            out[b, t] = torch.einsum("nj,jnd->nd", torch.softmax(s, -1),
                                     kv[b, ok, :, dn:])
    return F.linear(out.reshape(B, L, n * dv), W[a + "o_proj.weight"])


def _swiglu(x, wg, wu, wd):
    return F.linear(F.silu(F.linear(x, wg)) * F.linear(x, wu), wd)


def route(cfg, x, w_gate, bias):
    """One token's ``(experts, weights)``: sigmoid scores, the top k of
    scores + bias, the chosen scores renormalised x the scaling factor."""
    s = torch.sigmoid(F.linear(x, w_gate))
    _, idx = torch.topk(s + bias, cfg["num_experts_per_token"])
    w = s[idx]
    if cfg["moe_renormalize"] and len(idx) > 1:
        w = w / (w.sum() + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(cfg, W, m, x, mask, held, routes=None, layer=None):
    """A MoE layer's output: the held experts' terms, token by token, and
    the shared expert's."""
    B, L, _ = x.shape
    lo, hi = held
    y = torch.zeros_like(x)
    for b in range(B):
        for t in range(L):
            idx, w = route(cfg, x[b, t], W[m + "gate.weight"],
                           W[m + "gate.e_score_correction_bias"])
            if routes is not None and mask[b, t] > 0:
                routes.append((layer, b, t, frozenset(idx.tolist()),
                               tuple(sorted(w.tolist()))))
            for e, we in zip(idx.tolist(), w):
                if lo <= e < hi:
                    p = f"{m}experts.{e}."
                    y[b, t] += we * _swiglu(x[b, t], W[p + "w1.weight"],
                                            W[p + "w3.weight"],
                                            W[p + "w2.weight"])
    if cfg.get("num_shared_experts"):
        s = m + "shared_experts."
        y = y + _swiglu(x, W[s + "gate_proj.weight"], W[s + "up_proj.weight"],
                        W[s + "down_proj.weight"])
    return y


def decoder(cfg, W, ids, mask, held=None, routes=None):
    """Final-normed hidden states ``(B, L, H)`` f32 of right-padded
    ``ids``; ``held``: the routed experts this model holds (all when
    None); ``routes`` collects ``(layer, b, t, experts, weights)`` of the
    real tokens."""
    held = held or (0, cfg["num_experts"])
    eps = cfg["rms_norm_eps"]
    kda_layers = cfg["linear_attn_config"]["kda_layers"]
    x = W["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = rms_norm(x, W[p + "input_layernorm.weight"], eps)
        a = p + "self_attn."
        x = x + (kda(cfg, W, a, h) if i + 1 in kda_layers
                 else mla_nope(cfg, W, a, h, mask))
        h = rms_norm(x, W[p + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"] \
                or i % cfg["moe_layer_freq"]:
            m = p + "mlp."
            x = x + _swiglu(h, W[m + "gate_proj.weight"],
                            W[m + "up_proj.weight"], W[m + "down_proj.weight"])
        else:
            x = x + moe(cfg, W, p + "block_sparse_moe.", h, mask, held,
                        routes, i)
    return rms_norm(x, W["model.norm.weight"], eps)


def dhr_reps(cfg, W, ids, mask, held=None, routes=None):
    """``(hidden, lexical (B, V), semantic (B, proj))`` f32: the lexical rep
    over positions 1..L-1 of the LM head's logits, the semantic rep the
    pooler at each row's last real token."""
    h = decoder(cfg, W, ids, mask, held, routes)
    logits = F.linear(h[:, 1:], W["lm_head.weight"])
    tw = F.linear(h[:, 1:], W["term_weight.linear.weight"],
                  W["term_weight.linear.bias"])
    lexical = (torch.softmax(logits, -1) * tw * mask[:, 1:, None]).amax(1)
    last = [int(mask[b].sum()) - 1 for b in range(ids.shape[0])]
    pooled = torch.stack([h[b, t] for b, t in enumerate(last)])
    semantic = F.linear(pooled, W["pooler.linear.weight"],
                        W["pooler.linear.bias"])
    return h, lexical, semantic
