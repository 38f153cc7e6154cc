"""A DHR bi-encoder tower on a Nemotron-H decoder in plain PyTorch, f32,
run block by block.

Reads the weights of ``benchmarks.gen.weights_nemotron`` by their names,
drawing one block's at a time (``layer_weights``), so that the reference
of a model of 31.6B parameters needs one block's f32 weights and the
checked documents' hidden states, not the model.  The maths is Hugging
Face's ``modeling_nemotron_h.py`` (NVIDIA-Nemotron-3-Nano-30B-A3B; the
Nemotron-H report, arXiv:2504.03624) with the DHR head of Lin et al. 2022
(castorini/dhr), as ``reference.dhr_model`` and
``reference.dhr_kimi_linear`` take it:

- embeddings, then per block ``x += MIXER(RMSNorm(x))``, the mixer the
  block's letter of ``hybrid_override_pattern``; a final RMSNorm;
- ``M``, Mamba-2: ``[z | xBC | dt] = in_proj(x)``, ``xBC = SiLU(causal
  depthwise conv(xBC) + bias)`` split into ``x`` (heads of
  ``mamba_head_dim``), ``B`` and ``C`` (``n_groups`` of
  ``ssm_state_size``; head ``j`` reads group ``j // (heads / groups)``),
  ``dt = clamp(softplus(dt + dt_bias), time_step_limit)``, ``A =
  -exp(A_log)``, the recurrence token by token, ``S_t = exp(dt_t A)
  S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t + D x_t`` from ``S_0 = 0``;
  ``out_proj(RMSNorm_group(y * SiLU(z)))`` over groups of ``heads *
  head_dim / n_groups``;
- ``*``, attention without positions: query head ``j`` against key /
  value head ``j // (n / n_kv)``, explicit products and a causal softmax
  over the real keys at ``head_dim ** -0.5``, a document at a time;
- ``E``: a sigmoid router over all experts, the top ``k`` of score +
  ``e_score_correction_bias``, the chosen scores renormalised (+1e-20) x
  ``routed_scaling_factor``; the routed experts a loop, each
  ``down(relu(up(x))^2)``, plus the shared expert.  Given the experts a
  program chose for each real token (``routes``), it takes those instead
  and logs how far each choice falls below its own top ``k`` (the random
  router's near ties would otherwise turn rounding into another expert);
- lexical rep: ``max over positions 1..L-1 of softmax(lm_head(h)) *
  term_weight(h) * mask`` of the final-normed ``h``, a document at a
  time; semantic rep: the pooler of ``h`` at each document's last real
  token.

Departures from the HF code, none in the maths: the recurrence runs token
by token where HF's ``torch_forward`` chunks it; the pads' routes are not
taken (HF routes every position; a pad reaches no real one); everything is
f32 with TF32 off (``drivers/encode_docs_nemotron.py`` calls ``no_tf32``).
``Math("fp8")`` is the control, as in ``reference.dhr_model``: every
matrix product, the router's, attention's, the recurrence's outer and
inner products and the LM head's included, takes its operands rounded to
float8 e4m3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmarks.gen.weights_nemotron import kind, layer_weights, \
    outer_weights
from benchmarks.reference.dhr_decoder import rms
from benchmarks.reference.dhr_model import Math


def causal_conv(x, w, b):
    """Causal depthwise convolution of ``x`` (B, L, C) by ``w`` (C, 1, K)
    plus ``b``, tap by tap, then SiLU."""
    K, L = w.shape[-1], x.shape[1]
    y = torch.zeros_like(x) + b
    for j in range(K):
        lag = K - 1 - j
        y[:, lag:] += x[:, :L - lag] * w[:, 0, j]
    return F.silu(y)


def mamba(W, a, d, x, m: Math):
    Bt, L, _ = x.shape
    h, P, g, N = d["mamba_heads"], d["mamba_dim"], d["groups"], d["state"]
    D = h * P
    z, xbc, dt = m.mm(x, W[a + "in_proj.weight"].T).split(
        [D, D + 2 * g * N, h], dim=-1)
    xbc = causal_conv(xbc, W[a + "conv1d.weight"], W[a + "conv1d.bias"])
    xs, B, C = xbc.split([D, g * N, g * N], dim=-1)
    xs = xs.reshape(Bt, L, g, h // g, P)
    B, C = B.reshape(Bt, L, g, 1, N), C.reshape(Bt, L, g, 1, N)
    dt = F.softplus(dt + W[a + "dt_bias"]).clamp(*d["dt_limit"]) \
        .view(Bt, L, g, h // g)
    decay = torch.exp(dt * -W[a + "A_log"].exp().view(g, h // g))
    S = torch.zeros(Bt, g, h // g, P, N, dtype=x.dtype, device=x.device)
    y = torch.empty_like(xs)
    for t in range(L):
        S = S * decay[:, t, ..., None, None] \
            + m.mm((dt[:, t, ..., None] * xs[:, t])[..., None],
                   B[:, t, ..., None, :])
        y[:, t] = m.mm(S, C[:, t, ..., None])[..., 0]
    y = y.reshape(Bt, L, D) + (W[a + "D"].repeat_interleave(P)
                               * xs.reshape(Bt, L, D))
    t = (y * F.silu(z)).view(Bt, L, g, D // g)
    t = t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + d["eps"])
    return m.mm(t.reshape(Bt, L, D) * W[a + "norm.weight"],
                W[a + "out_proj.weight"].T)


def attention(W, a, d, x, mask, m: Math):
    Bt, L, _ = x.shape
    n, kv, hd = d["heads"], d["kv_heads"], d["head_dim"]
    q = m.mm(x, W[a + "q_proj.weight"].T).view(Bt, L, n, hd).transpose(1, 2)
    k, v = (m.mm(x, W[a + f"{c}_proj.weight"].T).view(Bt, L, kv, hd)
            .transpose(1, 2).repeat_interleave(n // kv, dim=1) for c in "kv")
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    out = []
    for b in range(Bt):      # a document at a time: (n, L, L) scores
        s = m.mm(q[b], k[b].transpose(-1, -2)) * hd ** -0.5
        s = torch.where(causal & (mask[b, None, :] > 0), s, -1e30)
        out.append(m.mm(torch.softmax(s, dim=-1), v[b]))
    ctx = torch.stack(out).transpose(1, 2).reshape(Bt, L, n * hd)
    return m.mm(ctx, W[a + "o_proj.weight"].T)


def relu2(x, up, down, m: Math):
    return m.mm(F.relu(m.mm(x, up.T)).square(), down.T)


def route(W, a, d, t, m: Math, ties=None, routes=None, log=None,
          no_bias: bool = False):
    """``(experts (T, k), weights (T, k))`` of the real tokens ``t``.
    ``ties``: a list to which ``[near ties, real tokens]`` is appended
    (the k-th and (k+1)-th choice scores within 1% of the k-th).
    ``routes``: the ``(real tokens, k)`` experts to take instead of its own
    top ``k`` (a program's, the real tokens in row-major order); the
    weights are still its own scores'.  ``log``: a dict whose ``"routes"``
    list gets the experts taken and whose ``"gaps"`` list gets ``[the
    largest choice score gap, tokens whose experts differ from its own top
    k, tokens]``; a token's gap is its own k-th best choice score less the
    least choice score of the experts taken.  ``no_bias``: the choice
    leaves out the correction bias (a planted fault)."""
    scores = torch.sigmoid(m.mm(t, W[a + "gate.weight"].T))
    choice = scores if no_bias else \
        scores + W[a + "gate.e_score_correction_bias"]
    k = d["top_k"]
    top, idx = torch.topk(choice, min(k + 1, choice.shape[-1]), dim=-1)
    if ties is not None and top.shape[-1] > k:
        near = (top[:, k - 1] - top[:, k]) < 0.01 * top[:, k - 1].abs()
        ties.append([int(near.sum()), int(t.shape[0])])
    if routes is not None:
        idx = routes.to(device=t.device, dtype=torch.long)
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
    return idx, w * d["routed_scale"]


def moe(W, a, d, x, mask, m: Math, ties=None, routes=None, log=None,
        no_bias: bool = False):
    """The real tokens' MoE output (pads get 0), routed by :func:`route`
    (``ties``, ``routes``, ``log`` and ``no_bias`` are its)."""
    shape = x.shape
    keep = mask.reshape(-1) > 0
    t = x.reshape(-1, shape[-1])[keep]
    idx, w = route(W, a, d, t, m, ties, routes, log, no_bias)
    y = torch.zeros_like(t)
    e = a + "experts."
    for ex in range(d["experts"]):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)
        if tok.numel():
            out = relu2(t[tok], W[e + "up_proj"][ex], W[e + "down_proj"][ex],
                        m)
            y.index_add_(0, tok, out * w[tok, slot, None])
    s = a + "shared_experts."
    y = y + relu2(t, W[s + "up_proj.weight"], W[s + "down_proj.weight"], m)
    full = torch.zeros(keep.shape[0], shape[-1], dtype=x.dtype,
                       device=x.device)
    full[keep] = y
    return full.view(shape)


def dhr_reps(d: dict, seed: int, ids: torch.Tensor, mask: torch.Tensor,
             m: Math, block: int = 16, ties=None, weights=None,
             routes=None, log=None, no_bias: bool = False):
    """``(lexical (n, V), semantic (n, proj))`` f32 of right-padded
    documents ``ids`` (n, L), each block's weights drawn once (or read
    from ``weights``, a dict of every tensor in f32) and applied to
    ``block`` documents at a time; the LM head a document at a time.

    ``routes``: per document, per MoE block in order, the ``(real tokens,
    k)`` experts to take; ``log``: a dict that gets ``"routes"`` in that
    form (the experts taken) and ``"gaps"``, one ``[largest gap, tokens
    off its own top k, tokens]`` a MoE block and block of documents
    (``reference.dhr_kimi_linear``'s)."""
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
        a = p + "mixer."
        j = sum(kind(d, b) == "E" for b in range(i))   # the MoE block's place
        for s in range(0, n, block):
            xb, mb = x[s:s + block], mask[s:s + block]
            hb = rms(xb, W[p + "norm.weight"], d["eps"])
            if kind(d, i) == "M":
                x[s:s + block] = xb + mamba(W, a, d, hb, m)
            elif kind(d, i) == "*":
                x[s:s + block] = xb + attention(W, a, d, hb, mb, m)
            else:
                given = None if routes is None else torch.cat(
                    [r[j] for r in routes[s:s + block]])
                part = None if log is None else {"routes": [],
                                                 "gaps": log["gaps"]}
                x[s:s + block] = xb + moe(W, a, d, hb, mb, m, ties, given,
                                          part, no_bias)
                if part is not None:
                    for b, r in enumerate(part["routes"][0].split(
                            real[s:s + block])):
                        taken[s + b].append(r)
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
