"""A plain f32 reference of the Nemotron-H decoder and of the DHR head on
it, for the port's tests (``chip_smoke.py``'s Nemotron phase takes its
attention core, :func:`causal_gqa`).

Written from Hugging Face's ``modeling_nemotron_h.py`` (NVIDIA-Nemotron-3-
Nano-30B-A3B) and the Nemotron-H report (arXiv:2504.03624) in plain
PyTorch; it imports neither JAX nor anything of the port, and turns TF32
off.  Each block is ``x + MIXER(RMSNorm(x))``, its mixer named by the
block's letter of ``hybrid_override_pattern``:

- ``M``, Mamba-2: ``[z | xBC | dt] = in_proj(x)``, ``xBC = SiLU(causal
  depthwise conv(xBC) + bias)``, split into ``x`` (heads of
  ``mamba_head_dim``), ``B`` and ``C`` (``n_groups`` of
  ``ssm_state_size``; head ``j`` reads group ``j // (heads / groups)``);
  ``dt = clamp(softplus(dt + dt_bias), time_step_limit)``, ``A =
  -exp(A_log)``; the recurrence token by token exactly as written (not
  chunked)::

      S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t

  then ``out_proj(RMSNorm_group(y * SiLU(z)))`` over groups of
  ``heads * head_dim / n_groups`` channels;
- ``*``, attention: ``num_attention_heads`` query heads and
  ``num_key_value_heads`` key / value heads of ``head_dim``, no rotary
  positions, explicit products and a causal softmax at ``head_dim **
  -0.5``, query head ``j`` reading key / value head ``j // (n / n_kv)``;
- ``E``, the MoE: sigmoid scores, the top ``k`` of scores +
  ``e_score_correction_bias``, the chosen scores renormalised (+1e-20) x
  ``routed_scaling_factor``; the experts a loop, each ``down(relu(up(x))
  ^2)``, plus the shared expert of ``moe_shared_expert_intermediate_size``.

A final RMSNorm ``norm_f`` follows.  Departures from the HF code: none in
the maths; the recurrence is sequential where HF's ``torch_forward``
chunks it, and everything is f32 (HF's Mamba keeps ``D`` and the norm's
weight in the model's dtype).  Weights are a dict under the checkpoint's
names (``backbone.embeddings.weight``, ``backbone.layers.{i}.norm.weight``,
``backbone.layers.{i}.mixer.*``, one expert's ``mixer.experts.{j}.
up_proj / down_proj``, ``backbone.norm_f.weight``, ``lm_head.weight``) and
the DHR head's ``term_weight.linear.*`` and ``pooler.linear.*``.  ``cfg``
is a dict of the ``nemotron_h`` config.json's keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def causal_conv(x, w, b):
    """Causal depthwise convolution of ``x`` (B, L, D) by ``w`` (D, 1, K)
    plus ``b``, tap by tap, then SiLU."""
    K = w.shape[-1]
    y = torch.zeros_like(x) + b
    for j in range(K):          # tap j reads position t - (K - 1 - j)
        lag = K - 1 - j
        y[:, lag:] += x[:, :x.shape[1] - lag] * w[:, 0, j]
    return F.silu(y)


def ssd_recurrence(x, dt, A, B, C, D):
    """``y`` (B, L, h, P): the recurrence token by token from ``x`` (B, L,
    h, P), ``dt`` (B, L, h), ``A`` and ``D`` (h,), ``B`` and ``C`` (B, L,
    g, N), the state ``S`` (B, h, P, N) from 0, in ``x``'s dtype and on
    its device (f64 for an exact yardstick)."""
    Bt, L, h, P = x.shape
    r = h // B.shape[2]
    Bh, Ch = (t.repeat_interleave(r, dim=2) for t in (B, C))
    S = torch.zeros(Bt, h, P, B.shape[-1], dtype=x.dtype, device=x.device)
    y = torch.zeros_like(x)
    for t in range(L):
        S = S * torch.exp(dt[:, t] * A)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        y[:, t] = (S @ Ch[:, t, :, :, None])[..., 0] + D[:, None] * x[:, t]
    return y


def mamba(cfg, W, a, x):
    """A Mamba-2 mixer's output of normed ``x``."""
    Bt, L, _ = x.shape
    h, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, N = cfg["n_groups"], cfg["ssm_state_size"]
    D = h * P
    z, xbc, dt = F.linear(x, W[a + "in_proj.weight"]).split(
        [D, D + 2 * g * N, h], dim=-1)
    xbc = causal_conv(xbc, W[a + "conv1d.weight"], W[a + "conv1d.bias"])
    xs, B, C = xbc.split([D, g * N, g * N], dim=-1)
    lo, hi = cfg.get("time_step_limit", (0.0, float("inf")))
    dt = F.softplus(dt + W[a + "dt_bias"]).clamp(lo, hi)
    y = ssd_recurrence(xs.reshape(Bt, L, h, P), dt, -W[a + "A_log"].exp(),
                       B.reshape(Bt, L, g, N), C.reshape(Bt, L, g, N),
                       W[a + "D"]).reshape(Bt, L, D)
    t = (y * F.silu(z)).view(Bt, L, g, D // g)
    t = t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True)
                        + cfg["layer_norm_epsilon"])
    return F.linear(t.reshape(Bt, L, D) * W[a + "norm.weight"],
                    W[a + "out_proj.weight"])


def causal_gqa(q, k, v, scale):
    """The attention core in ``q``'s dtype, a head at a time: ``q`` ``(B,
    L, n, d)`` over ``k`` and ``v`` ``(B, L, n_kv, d)``, query head ``j``
    reading key / value head ``j // (n / n_kv)``; ``(B, L, n, d)``."""
    Bt, L, n, d = q.shape
    kv = k.shape[2]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    out = torch.zeros(Bt, L, n, d, dtype=q.dtype, device=q.device)
    for j in range(n):
        kh, vh = k[:, :, j // (n // kv)], v[:, :, j // (n // kv)]
        s = (q[:, :, j] @ kh.transpose(1, 2)) * scale
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out[:, :, j] = p @ vh
    return out


def attention(cfg, W, a, x):
    """Causal attention without positions."""
    Bt, L, _ = x.shape
    n, kv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    q = F.linear(x, W[a + "q_proj.weight"]).view(Bt, L, n, d)
    k = F.linear(x, W[a + "k_proj.weight"]).view(Bt, L, kv, d)
    v = F.linear(x, W[a + "v_proj.weight"]).view(Bt, L, kv, d)
    out = causal_gqa(q, k, v, d ** -0.5)
    return F.linear(out.reshape(Bt, L, n * d), W[a + "o_proj.weight"])


def relu2(x, up, down):
    return F.linear(F.relu(F.linear(x, up)).square(), down)


def route(cfg, x, w_gate, bias):
    """One token's ``(experts, weights)``: sigmoid scores, the top k of
    scores + bias, the chosen scores renormalised x the scaling factor."""
    s = torch.sigmoid(F.linear(x, w_gate))
    _, idx = torch.topk(s + bias, cfg["num_experts_per_tok"])
    w = s[idx]
    if cfg["norm_topk_prob"] and len(idx) > 1:
        w = w / (w.sum() + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(cfg, W, m, x, routes=None, layer=None):
    """A MoE block's output: the routed experts' terms, token by token,
    and the shared expert's; ``routes`` collects ``(layer, b, t, experts,
    weights)``."""
    Bt, L, _ = x.shape
    y = torch.zeros_like(x)
    for b in range(Bt):
        for t in range(L):
            idx, w = route(cfg, x[b, t], W[m + "gate.weight"],
                           W[m + "gate.e_score_correction_bias"])
            if routes is not None:
                routes.append((layer, b, t, frozenset(idx.tolist()),
                               tuple(sorted(w.tolist()))))
            for e, we in zip(idx.tolist(), w):
                p = f"{m}experts.{e}."
                y[b, t] += we * relu2(x[b, t], W[p + "up_proj.weight"],
                                      W[p + "down_proj.weight"])
    s = m + "shared_experts."
    return y + relu2(x, W[s + "up_proj.weight"], W[s + "down_proj.weight"])


def decoder(cfg, W, ids, routes=None):
    """Final-normed hidden states ``(B, L, H)`` f32 of right-padded
    ``ids`` (causal throughout, so pads touch no real position)."""
    eps = cfg["layer_norm_epsilon"]
    x = W["backbone.embeddings.weight"][ids]
    for i, kind in enumerate(cfg["hybrid_override_pattern"]):
        p = f"backbone.layers.{i}."
        h = rms_norm(x, W[p + "norm.weight"], eps)
        a = p + "mixer."
        if kind == "M":
            x = x + mamba(cfg, W, a, h)
        elif kind == "*":
            x = x + attention(cfg, W, a, h)
        else:
            x = x + moe(cfg, W, a, h, routes, i)
    return rms_norm(x, W["backbone.norm_f.weight"], eps)


def dhr_reps(cfg, W, ids, mask, routes=None):
    """``(hidden, lexical (B, V), semantic (B, proj))`` f32: the lexical rep
    over positions 1..L-1 of the LM head's logits, the semantic rep the
    pooler at each row's last real token."""
    h = decoder(cfg, W, ids, routes)
    logits = F.linear(h[:, 1:], W["lm_head.weight"])
    tw = F.linear(h[:, 1:], W["term_weight.linear.weight"],
                  W["term_weight.linear.bias"])
    lexical = (torch.softmax(logits, -1) * tw * mask[:, 1:, None]).amax(1)
    last = [int(mask[b].sum()) - 1 for b in range(ids.shape[0])]
    pooled = torch.stack([h[b, t] for b, t in enumerate(last)])
    semantic = F.linear(pooled, W["pooler.linear.weight"],
                        W["pooler.linear.bias"])
    return h, lexical, semantic
