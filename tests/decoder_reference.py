"""A plain f32 reference of the DeepSeek-V2 decoder and of the DHR head on
it, for the port's tests.

Written from Hugging Face's ``modeling_deepseek.py`` (DeepSeek-V2) in
plain PyTorch, token by token where that is the plainest form (the MoE
routes and sums one token at a time); it imports neither JAX nor anything
of the port.  Weights are a dict under the HF names, experts one tensor
per expert (``model.layers.{i}.mlp.experts.{e}.{gate,up,down}_proj.
weight``); the DHR head's are ``term_weight.linear.*`` and
``pooler.linear.*``.  ``cfg`` is a dict of the HF config's keys.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_inv_freq(cfg) -> torch.Tensor:
    """YaRN's rotary frequencies, in float64 (the closed form)."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg["rope_scaling"]
    extra = torch.tensor([base ** (-(2 * i) / dim) for i in range(dim // 2)],
                         dtype=torch.float64)
    inter = extra / rs["factor"]

    def corr(r):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (2 * math.pi * r)) / (2 * math.log(base)))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = torch.tensor([min(max((i - low) / (high - low), 0.0), 1.0)
                         for i in range(dim // 2)], dtype=torch.float64)
    return inter * ramp + extra * (1.0 - ramp)


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _rope(t, cos, sin):
    d = t.shape[-1]
    t = t.view(*t.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(t.shape)
    return t * cos + torch.cat([-t[..., d // 2:], t[..., :d // 2]], -1) * sin


def _swiglu(x, W, p):
    return F.linear(F.silu(F.linear(x, W[p + "gate_proj.weight"]))
                    * F.linear(x, W[p + "up_proj.weight"]),
                    W[p + "down_proj.weight"])


def route(cfg, x, w_gate):
    """One token's ``(experts, weights)``: softmax gate, greedy top k."""
    scores = torch.softmax(F.linear(x, w_gate), dim=-1)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"])
    return idx, w * cfg["routed_scaling_factor"]


def decoder(cfg, W, ids, mask, routes=None):
    """Final-normed hidden states ``(B, L, H)`` f32; ``routes`` collects
    each MoE layer's ``(layer, b, t, set of experts)`` of real tokens."""
    B, L = ids.shape
    n = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    rank, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    rs = cfg["rope_scaling"]
    freqs = torch.outer(torch.arange(L, dtype=torch.float64),
                        yarn_inv_freq(cfg)).float()
    emb = torch.cat([freqs, freqs], -1)
    ratio = _mscale(rs["factor"], rs["mscale"]) / _mscale(
        rs["factor"], rs["mscale_all_dim"])
    cos, sin = emb.cos() * ratio, emb.sin() * ratio
    ms = _mscale(rs["factor"], rs["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * ms * ms
    x = W["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = rms_norm(x, W[p + "input_layernorm.weight"], eps)
        a = p + "self_attn."
        q = F.linear(h, W[a + "q_proj.weight"]).view(B, L, n, dn + dr)
        ckv = F.linear(h, W[a + "kv_a_proj_with_mqa.weight"])
        kv = F.linear(rms_norm(ckv[..., :rank], W[a + "kv_a_layernorm.weight"],
                               eps), W[a + "kv_b_proj.weight"]
                      ).view(B, L, n, dn + dv)
        out = torch.zeros(B, L, n, dv)
        for b in range(B):
            for hd in range(n):
                qh = torch.cat([q[b, :, hd, :dn],
                                _rope(q[b, :, hd, dn:], cos, sin)], -1)
                kh = torch.cat([kv[b, :, hd, :dn],
                                _rope(ckv[b, :, rank:], cos, sin)], -1)
                s = qh @ kh.T * scale
                for t in range(L):
                    ok = [j for j in range(t + 1) if mask[b, j] > 0]
                    pr = torch.softmax(s[t, ok], dim=-1)
                    out[b, t, hd] = pr @ kv[b, ok, hd, dn:]
        x = x + F.linear(out.reshape(B, L, n * dv), W[a + "o_proj.weight"])
        h = rms_norm(x, W[p + "post_attention_layernorm.weight"], eps)
        m = p + "mlp."
        moe = i >= cfg["first_k_dense_replace"] \
            and i % cfg["moe_layer_freq"] == 0
        if not moe:
            x = x + _swiglu(h, W, m)
            continue
        y = torch.zeros_like(h)
        for b in range(B):
            for t in range(L):
                idx, w = route(cfg, h[b, t], W[m + "gate.weight"])
                if routes is not None and mask[b, t] > 0:
                    routes.append((i, b, t, frozenset(idx.tolist())))
                for e, we in zip(idx.tolist(), w):
                    y[b, t] += we * _swiglu(h[b, t], W, f"{m}experts.{e}.")
        if cfg["n_shared_experts"]:
            y = y + _swiglu(h, W, m + "shared_experts.")
        x = x + y
    return rms_norm(x, W["model.norm.weight"], eps)


def dhr_reps(cfg, W, ids, mask, routes=None):
    """``(hidden, lexical (B, V), semantic (B, proj))`` f32: the lexical rep
    over positions 1..L-1 of the LM head's logits, the semantic rep the
    pooler at each row's last real token."""
    h = decoder(cfg, W, ids, mask, routes)
    logits = F.linear(h[:, 1:], W["lm_head.weight"])
    tw = F.linear(h[:, 1:], W["term_weight.linear.weight"],
                  W["term_weight.linear.bias"])
    lexical = (torch.softmax(logits, -1) * tw * mask[:, 1:, None]).amax(1)
    last = [int(mask[b].sum()) - 1 for b in range(ids.shape[0])]
    pooled = torch.stack([h[b, t] for b, t in enumerate(last)])
    semantic = F.linear(pooled, W["pooler.linear.weight"],
                        W["pooler.linear.bias"])
    return h, lexical, semantic
