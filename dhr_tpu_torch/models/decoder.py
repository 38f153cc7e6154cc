"""The decoder backbone: a causal pre-norm transformer of the DeepSeek-V2
family (multi-head latent attention, YaRN rotary positions, a mixture of
experts), as a retriever's backbone.

The equations are those of Hugging Face's ``modeling_deepseek.py``
(DeepSeek-V2).  ``x`` is ``(B, L, H)``.

Block (pre-norm), then a final RMSNorm after the last block::

    x = x + MLA(RMSNorm(x))
    x = x + FFN(RMSNorm(x))

RMSNorm: ``x * rsqrt(mean(x^2) + eps) * weight``.

MLA (no query LoRA; ``n`` heads of ``d_nope + d_rope`` for q and k and
``d_v`` for v)::

    [q_nope | q_pe] = q_proj(x)                  (B, L, n, d_nope + d_rope)
    [c | k_pe]      = kv_a_proj_with_mqa(x)      kv_lora_rank + d_rope
    [k_nope | v]    = kv_b_proj(RMSNorm(c))      (B, L, n, d_nope + d_v)
    q_pe, k_pe      = rope(q_pe), rope(k_pe)     (k_pe: one head, shared)
    scores          = [q_nope | q_pe] . [k_nope | k_pe] * scale
    out             = o_proj(softmax(scores + causal and key mask) . v)

with ``scale = (d_nope + d_rope) ** -0.5 * m * m``, ``m = 0.1 *
mscale_all_dim * ln(factor) + 1``.  ``rope`` de-interleaves the rope
half (``t.view(..., d/2, 2).transpose(-1, -2).reshape(..., d)``) and then
rotates it: ``t * cos + rotate_half(t) * sin``.

YaRN (rope dim ``d``, base ``b``, ``factor``, original length ``L0``)::

    freq_extra = b ** (-(2i) / d),  freq_inter = freq_extra / factor
    corr(r)    = d * ln(L0 / (2 pi r)) / (2 ln b)
    low, high  = floor(corr(beta_fast)), ceil(corr(beta_slow)), in [0, d-1]
    ramp       = clamp((i - low) / (high - low), 0, 1),  i < d/2
    inv_freq   = freq_inter * ramp + freq_extra * (1 - ramp)

and cos, sin of ``position * inv_freq`` scaled by ``mscale(factor,
mscale) / mscale(factor, mscale_all_dim)`` (1 at the published numbers).

FFN: the first ``first_k_dense_replace`` layers are SwiGLU MLPs,
``down(silu(gate(x)) * up(x))``.  The others are mixtures of experts:

    scores = softmax(x.float() @ W_gate.float().T)        (64 in f32)
    i_1..k, w_1..k = the top ``k`` scores (greedy)  x routed_scaling_factor
    y = sum_j w_j * E_{i_j}(x)   (in f32, cast to the compute dtype)
        + shared(x)              (one SwiGLU of n_shared x the expert width)

Numerics, in the port's conventions: parameters live in ``param_dtype``
(f32 to train; the compute dtype for inference, built so and never
copied) and RMSNorm weights in f32 always; linear maps compute in their
input's dtype; RMSNorm, the rotary products, the softmaxes, the gate and
the experts' combine in f32, each returning the compute dtype.  There is
no dropout (the published config has none), and the modules start in
eval mode.  Departures from the HF code, none of which changes the maths:

- RMSNorm multiplies by its f32 weight before the cast to the compute
  dtype (HF casts first, then multiplies by a weight of the model's
  dtype);
- the rotary products run in f32 on f32 cos / sin (HF casts cos and sin
  to the compute dtype);
- the masked score is -1e9 in the compute dtype (HF: the dtype's least
  value);
- the top-k slots are taken sorted by score, so a token's combine sums
  its experts in that order.

The MoE's implementation (:class:`MoE`): the router routes the rows it is
given, the real tokens of the batch where the caller names them
(``rows``, an index of the real positions of the flattened batch, made by
the caller from what it collated on the host) and every position
otherwise.  The routed rows are ordered by expert with one stable device
sort; per-expert counts come from a ``scatter_add_`` into ``E`` counters
and their ``cumsum`` (``bincount`` and boolean indexing read the device
on CUDA); each of the three expert projections is one grouped GEMM
(``torch._grouped_mm``, bf16, the group offsets kept on the device) over
the experts' row groups; the combine gathers each token's ``k`` rows
back by the inverse permutation and sums them weighted in f32: no atomics,
the same bits from run to run (on the card, where autograd records
nothing, in one kernel, K5 ``ops/moe_combine.py``).  No device-to-host
read happens inside the layer.  :func:`routed_experts_loop` is the plain
twin, a loop of matmuls over the experts that reads each expert's rows to
the host; a CPU tensor takes it, a CUDA tensor takes the grouped GEMMs or
raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from dhr_tpu_torch.models.transformer import Dense
from dhr_tpu_torch.ops.moe_combine import combine, moe_combine
from dhr_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """A DeepSeek-V2-family decoder: every key of the published config
    that the forward pass reads, under its published name."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    # YaRN (rope_scaling)
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    max_position_embeddings: int = 163840
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.006
    dtype: torch.dtype = torch.bfloat16        # activation / compute dtype
    param_dtype: torch.dtype = torch.float32   # linear and embedding weights

    def __post_init__(self):
        if self.num_experts_per_tok > self.n_routed_experts:
            raise ValueError("num_experts_per_tok exceeds n_routed_experts")

    @staticmethod
    def deepseek_v2_lite(**kw) -> "DecoderConfig":
        """DeepSeek-V2-Lite's published shape (its HF ``config.json``)."""
        return DecoderConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "DecoderConfig":
        """A fast config for tests: 1 dense + 2 MoE layers, 8 experts
        top-2 and one shared, small MLA widths, YaRN on."""
        base = dict(vocab_size=1024, hidden_size=32, num_layers=3,
                    num_heads=2, intermediate_size=48,
                    moe_intermediate_size=16, n_routed_experts=8,
                    n_shared_experts=1, num_experts_per_tok=2,
                    kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                    v_head_dim=8, rope_original_max_position=64,
                    max_position_embeddings=2560, initializer_range=0.02)
        base.update(kw)
        return DecoderConfig(**base)

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0
                and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


# -- rotary positions -------------------------------------------------------


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(cfg: DecoderConfig) -> tuple[int, int]:
    """``(low, high)``: the ramp's ends in rotary-pair index."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def corr(r):
        turns = cfg.rope_original_max_position / (r * 2 * math.pi)
        return d * math.log(turns) / (2 * math.log(base))

    low = math.floor(corr(cfg.rope_beta_fast))
    high = math.ceil(corr(cfg.rope_beta_slow))
    return max(low, 0), min(high, d - 1)


def inv_freq(cfg: DecoderConfig, device) -> torch.Tensor:
    """``(d_rope / 2,)`` f32 YaRN rotary frequencies, made on ``device``
    by its own ops (no copy from the host)."""
    d = cfg.qk_rope_head_dim
    extra = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    low, high = yarn_range(cfg)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp   # HF's inv_freq_mask
    inter = 1.0 / (cfg.rope_factor * cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    return inter * (1 - keep) + extra * keep


def rotary(cfg: DecoderConfig, length: int, device):
    """``(cos, sin)``, each ``(length, d_rope)`` f32, of positions
    ``0..length-1``."""
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq(cfg, device))
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
             / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return emb.cos() * scale, emb.sin() * scale


def apply_rope(t: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope on ``t`` (..., L, d): de-interleave, then rotate
    (in f32, returning ``t``'s dtype)."""
    d = t.shape[-1]
    x = t.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x * cos + rot * sin).to(t.dtype)


# -- layers -----------------------------------------------------------------


class RMSNorm(nn.Module):
    """RMSNorm in f32 with an f32 weight, returning its input's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return (h * self.weight.float()).to(x.dtype)


def causal_bias(attention_mask: torch.Tensor, dtype) -> torch.Tensor:
    """``(B, 1, L, L)``: 0 where query ``i`` may see key ``j`` (``j <= i``
    and ``j`` real), -1e9 in ``dtype`` elsewhere."""
    L = attention_mask.shape[-1]
    pos = torch.arange(L, device=attention_mask.device)
    allowed = (pos[None, :] <= pos[:, None])[None, None] \
        & (attention_mask[:, None, None, :] > 0)
    return torch.where(allowed, 0.0, -1e9).to(dtype)


class MLA(nn.Module):
    """Multi-head latent attention, in its prefill form (K and V expanded
    per head; encoding is one forward, so no cache)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        H, pd = cfg.hidden_size, cfg.param_dtype
        self.n = cfg.num_heads
        self.d_nope, self.d_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.d_v, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        q_dim = self.d_nope + self.d_rope
        self.q_proj = Dense(H, self.n * q_dim, bias=False, dtype=pd)
        self.kv_a_proj_with_mqa = Dense(H, self.rank + self.d_rope,
                                        bias=False, dtype=pd)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps)
        self.kv_b_proj = Dense(self.rank, self.n * (self.d_nope + self.d_v),
                               bias=False, dtype=pd)
        self.o_proj = Dense(self.n * self.d_v, H, bias=False, dtype=pd)
        m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
        self.scale = q_dim ** -0.5 * m * m

    def forward(self, x, bias, cos, sin):
        B, L, _ = x.shape
        n = self.n
        q = self.q_proj(x).view(B, L, n, -1).transpose(1, 2)
        q_nope, q_pe = q.split([self.d_nope, self.d_rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.d_rope],
                                                   dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(B, L, n, -1) \
            .transpose(1, 2)
        k_nope, v = kv.split([self.d_nope, self.d_v], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, None], cos, sin)          # (B, 1, L, d)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, n, L, self.d_rope)], dim=-1)
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.scale + bias
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, -1)
        return self.o_proj(out)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, hidden: int, width: int, dtype):
        super().__init__()
        self.gate_proj = Dense(hidden, width, bias=False, dtype=dtype)
        self.up_proj = Dense(hidden, width, bias=False, dtype=dtype)
        self.down_proj = Dense(width, hidden, bias=False, dtype=dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """The routed experts' SwiGLU weights, stacked: ``gate_proj`` and
    ``up_proj`` ``(E, width, H)``, ``down_proj`` ``(E, H, width)`` (each
    expert's ``nn.Linear`` layout)."""

    def __init__(self, n: int, hidden: int, width: int, dtype):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(n, width, hidden,
                                                  dtype=dtype))
        self.up_proj = nn.Parameter(torch.empty(n, width, hidden,
                                                dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, width,
                                                  dtype=dtype))

    def weights(self, dtype):
        """The three stacks in ``dtype`` (a no-op where they are)."""
        return tuple(w.to(dtype) for w in
                     (self.gate_proj, self.up_proj, self.down_proj))


def route(x: torch.Tensor, gate_weight: torch.Tensor, k: int,
          scaling: float = 1.0, norm_topk: bool = False):
    """``(experts (N, k) int64, weights (N, k) f32)``: the softmax gate in
    f32 and its top ``k`` by score (greedy), highest first."""
    logits = F.linear(x.float(), gate_weight.float())
    scores = torch.softmax(logits, dim=-1, dtype=torch.float32)
    w, idx = torch.topk(scores, k, dim=-1, sorted=True)
    if k > 1 and norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        w = w * scaling
    return idx, w


@dataclasses.dataclass
class Dispatch:
    """Routed rows ordered by expert, all on the device: ``token`` (N*k,)
    the source token of each ordered row, ``offs`` (E,) int32 the groups'
    cumulative ends, ``slot`` (N, k) each (token, slot)'s ordered row."""

    token: torch.Tensor
    offs: torch.Tensor
    slot: torch.Tensor


def dispatch(idx: torch.Tensor, n_experts: int) -> Dispatch:
    """Order the ``(N, k)`` routed rows by expert with fixed-size device
    ops: one stable sort, the counts by ``scatter_add_`` into
    ``n_experts`` counters, their ``cumsum``, and the inverse
    permutation."""
    N, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(N * k, device=idx.device)
    return Dispatch(token=order // k, offs=offs, slot=slot.view(N, k))


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """``x`` (M, K) rows in groups ending at ``offs``, times each group's
    ``w[g].T`` (``w`` (G, N, K)): one ``torch._grouped_mm``.  Counted as
    ``launches.moe_grouped_mm``."""
    out = torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    profiling.count("launches.moe_grouped_mm")
    return out


def routed_experts_grouped(x, idx, weights, experts: Experts):
    """The routed part of an MoE layer on ``x`` (N, H): dispatch, three
    grouped GEMMs, combine.  No device-to-host read.  Where autograd
    records nothing the combine is :func:`moe_combine` (K5 on the card,
    :func:`combine` on the CPU); otherwise the eager :func:`combine`,
    which autograd differentiates."""
    d = dispatch(idx, experts.gate_proj.shape[0])
    wg, wu, wd = experts.weights(x.dtype)
    xs = x[d.token]
    h = F.silu(grouped_mm(xs, wg, d.offs)) * grouped_mm(xs, wu, d.offs)
    rows = grouped_mm(h, wd, d.offs)
    if torch.is_grad_enabled() and (rows.requires_grad
                                    or weights.requires_grad):
        return combine(rows, d.slot, weights)
    return moe_combine(rows, d.slot, weights)


def routed_experts_loop(x, idx, weights, experts: Experts):
    """The plain twin of :func:`routed_experts_grouped`: each expert's
    rows found on the host (one read an expert, counted as
    ``moe.host_reads`` once for the layer), a matmul chain per expert,
    the same combine."""
    N, k = idx.shape
    wg, wu, wd = experts.weights(x.dtype)
    rows = torch.zeros(N * k, x.shape[-1], dtype=x.dtype, device=x.device)
    flat = idx.reshape(-1)
    profiling.count("moe.host_reads", wg.shape[0])
    for e in range(wg.shape[0]):
        at = torch.nonzero(flat == e)[:, 0]
        if at.numel() == 0:
            continue
        t = x[at // k]
        h = F.silu(t @ wg[e].T) * (t @ wu[e].T)
        rows[at] = h @ wd[e].T
    slot = torch.arange(N * k, device=x.device).view(N, k)
    return combine(rows, slot, weights)


class MoEGate(nn.Module):
    def __init__(self, n: int, hidden: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, hidden, dtype=dtype))


class MoE(nn.Module):
    """Router, routed experts and shared experts.  ``rows``: the flattened
    positions to route (the batch's real tokens); the others get an FFN
    output of 0.  Device spans ``moe.route`` (gate, softmax, top-k) and
    ``moe.experts`` (dispatch, the three grouped GEMMs, combine); the
    counter ``moe.host_reads`` counts the layer's device reads (0 on the
    grouped path)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        H, pd = cfg.hidden_size, cfg.param_dtype
        self.k = cfg.num_experts_per_tok
        self.scaling = cfg.routed_scaling_factor
        self.norm_topk = cfg.norm_topk_prob
        self.gate = MoEGate(cfg.n_routed_experts, H, pd)
        self.experts = Experts(cfg.n_routed_experts, H,
                               cfg.moe_intermediate_size, pd)
        self.shared_experts = MLP(
            H, cfg.moe_intermediate_size * cfg.n_shared_experts, pd) \
            if cfg.n_shared_experts else None

    def forward(self, x: torch.Tensor, rows: torch.Tensor | None = None):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        t = flat if rows is None else flat.index_select(0, rows)
        with profiling.span("moe.route", device=True):
            idx, w = route(t, self.gate.weight, self.k, self.scaling,
                           self.norm_topk)
        with profiling.span("moe.experts", device=True):
            if t.is_cuda:
                y = routed_experts_grouped(t, idx, w, self.experts)
                profiling.count("moe.host_reads", 0)
            elif t.device.type == "cpu":
                y = routed_experts_loop(t, idx, w, self.experts)
            else:
                raise ValueError(f"the MoE layer runs on cuda or cpu, not "
                                 f"{t.device}")
        if self.shared_experts is not None:
            y = y + self.shared_experts(t)
        if rows is not None:
            y = torch.zeros_like(flat).index_copy_(0, rows, y)
        return y.view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, layer: int):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(H, eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(H, eps)
        self.mlp = MoE(cfg) if cfg.is_moe(layer) else MLP(
            H, cfg.intermediate_size, cfg.param_dtype)

    def forward(self, x, bias, cos, sin, rows=None):
        with profiling.span("mla.attention", device=True):
            x = x + self.self_attn(self.input_layernorm(x), bias, cos, sin)
        h = self.post_attention_layernorm(x)
        h = self.mlp(h, rows) if isinstance(self.mlp, MoE) else self.mlp(h)
        return x + h


class DecoderModel(nn.Module):
    """Embeddings, the decoder layers and the final RMSNorm: the
    final-normed hidden states ``(B, L, H)`` in the compute dtype."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, _weight=torch.empty(
                cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        init_weights(self, cfg.initializer_range)
        self.eval()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None, gen=None,
                rows: torch.Tensor | None = None) -> torch.Tensor:
        """Right-padded rows, positions ``0..L-1``; ``rows``: the real
        positions of the flattened batch, which alone the MoE layers
        route (every position when None).  ``gen`` is unused (no
        dropout)."""
        if segment_ids is not None or position_ids is not None:
            raise ValueError("the decoder encodes one document a row: "
                             "packed rows need block-diagonal causal "
                             "attention, which it does not implement")
        dt = self.cfg.dtype
        L = input_ids.shape[-1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(f"rows of {L} tokens exceed the model's "
                             f"{self.cfg.max_position_embeddings} positions")
        x = F.embedding(input_ids, self.embed_tokens.weight.to(dt))
        bias = causal_bias(attention_mask, dt)
        cos, sin = rotary(self.cfg, L, x.device)
        for layer in self.layers:
            x = layer(x, bias, cos, sin, rows)
        return self.norm(x)


class DecoderLM(nn.Module):
    """The decoder and its untied LM head (``model.*``, ``lm_head``: HF's
    names).  The head has no bias; ``vocab_bias`` is a zero one of ``V``
    entries in the compute dtype, so the lexical head's pool and its
    training passes run as over an MLM head's logits."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.model = DecoderModel(cfg)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=False,
                             dtype=cfg.param_dtype)
        init_weights(self.lm_head, cfg.initializer_range)
        self.eval()

    @property
    def encoder(self) -> DecoderModel:
        return self.model

    @property
    def vocab_bias(self) -> torch.Tensor:
        w = self.lm_head.weight
        return torch.zeros(self.cfg.vocab_size, dtype=self.cfg.dtype,
                           device=w.device)

    def projection(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head's logits of final-normed hidden states."""
        return self.lm_head(hidden)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.projection(hidden)


def init_weights(module: nn.Module, std: float) -> None:
    """HF's init: linear, embedding, gate and expert weights from
    ``N(0, std)`` (RMSNorm weights stay 1).  Skipped on the meta device,
    where a normal draw costs the import of ``torch._dynamo``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding, MoEGate, Experts)):
                for p in m.parameters(recurse=False):
                    if p.dim() > 1 and not p.is_meta:
                        p.normal_(0.0, std)
