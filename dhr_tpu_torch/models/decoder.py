"""The decoder backbone: a causal pre-norm transformer of the DeepSeek-V2
family (multi-head latent attention, YaRN rotary positions, a mixture of
experts), of the Kimi Linear family (Kimi Delta Attention layers beside
MLA without positions, a sigmoid-routed mixture of experts) and of the
Nemotron-H family (blocks of one mixer each: Mamba-2, attention with
grouped key / value heads and no positions, or a mixture of relu^2
experts), as a retriever's backbone.

The equations are those of Hugging Face's ``modeling_deepseek.py``
(DeepSeek-V2), ``modeling_kimi.py`` (Kimi Linear, arXiv:2510.26692) and
``modeling_nemotron_h.py`` (Nemotron-H, arXiv:2504.03624; Nemotron 3
Nano).  ``x`` is ``(B, L, H)``.

Block (pre-norm), then a final RMSNorm after the last block::

    x = x + ATTN(RMSNorm(x))        (MLA, or KDA on the layers it names)
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
rotates it: ``t * cos + rotate_half(t) * sin``.  Without positions
(``mla_use_nope``, Kimi Linear) ``q_pe`` and ``k_pe`` enter the scores
unrotated and ``scale = (d_nope + d_rope) ** -0.5``.

YaRN (rope dim ``d``, base ``b``, ``factor``, original length ``L0``)::

    freq_extra = b ** (-(2i) / d),  freq_inter = freq_extra / factor
    corr(r)    = d * ln(L0 / (2 pi r)) / (2 ln b)
    low, high  = floor(corr(beta_fast)), ceil(corr(beta_slow)), in [0, d-1]
    ramp       = clamp((i - low) / (high - low), 0, 1),  i < d/2
    inv_freq   = freq_inter * ramp + freq_extra * (1 - ramp)

and cos, sin of ``position * inv_freq`` scaled by ``mscale(factor,
mscale) / mscale(factor, mscale_all_dim)`` (1 at the published numbers).

KDA, Kimi Delta Attention (the layers ``kda_layers`` names, 1-based as
published; ``h`` heads of ``d``, ``D = h d``)::

    q, k, v = SiLU(CausalConv_c(x W_c)),  c in {q, k, v}; W_c: H -> D;
              depthwise over the last ``kda_conv_size`` positions, no bias
    q, k    = L2Norm over each head's d (x * rsqrt(sum(x^2) + 1e-6));
              q <- q * d ** -0.5
    g       = -exp(A_log[head]) * softplus(f_b(f_a(x)) + dt_bias)
              f_a: H -> d, f_b: d -> D; a log-decay per channel
    beta    = sigmoid(b_proj(x))                              b_proj: H -> h
    S_0 = 0 (d x d per passage and head)
    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t
    out = o_proj(RMSNorm_head(o) * sigmoid(g_b(g_a(x))))
          g_a: H -> d, g_b: d -> D with a bias; RMSNorm weight d, eps
          rms_norm_eps

computed by :func:`kda_scan` in its chunked form (see there).

FFN: the first ``first_k_dense_replace`` layers are SwiGLU MLPs,
``down(silu(gate(x)) * up(x))``.  The others are mixtures of experts,
with a softmax router (DeepSeek-V2)::

    scores = softmax(x.float() @ W_gate.float().T)        (E in f32)
    i_1..k, w_1..k = the top ``k`` scores (greedy)  x routed_scaling_factor

or a sigmoid one (``router == "sigmoid"``, Kimi Linear)::

    s        = sigmoid(x.float() @ W_gate.float().T)       (E in f32)
    i_1..k   = the top ``k`` of s + e_score_correction_bias
    w_j      = s_{i_j} / (sum_j s_{i_j} + 1e-20) x routed_scaling_factor

and then::

    y = sum_j w_j * E_{i_j}(x)   (in f32, cast to the compute dtype)
        + shared(x)              (one SwiGLU of n_shared x the expert width)

A layer may hold a share of the experts (``experts_held``, a contiguous
range, as one chip of an expert-parallel deployment holds): it routes
over all ``n_routed_experts`` and sums only its own experts' terms; the
shared expert is computed whole.

Nemotron-H (``hybrid_override_pattern``, one letter a block: ``M``
Mamba-2, ``*`` attention, ``E`` a mixture of experts).  Each block holds
one mixer, and a final RMSNorm (``norm_f``) follows the last::

    x = x + MIXER(RMSNorm(x))            RMSNorm eps layer_norm_epsilon

Mamba-2 (``h`` heads of ``P``, ``D = h P``; ``g`` groups of B and C of
state ``N``; head ``j`` reads group ``j // (h / g)``)::

    [z | xBC | dt] = in_proj(x)                        D + (D + 2 g N) + h
    xBC            = SiLU(CausalConv1d_K(xBC) + bias)  depthwise, K taps
    [x | B | C]    = xBC                               (h, P), (g, N), (g, N)
    dt             = softplus(dt + dt_bias)            (h,)
    A              = -exp(A_log)                       (h,)
    S_0 = 0;  S_t  = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T     (P x N a head)
    y_t            = S_t C_t + D_skip x_t
    out            = out_proj(RMSNorm_group(y * SiLU(z)))

with the gate applied before the norm (``norm_before_gate=False``) and
the norm over groups of ``D / g`` channels.  HF clamps ``dt`` to
``time_step_limit``, (0, inf) in every published config: a no-op, left
out (``hf_io`` refuses another limit).  The recurrence is the SSD
scan (:func:`ssd_scan`), chunked.

Attention: ``n`` query heads and ``n_kv`` key / value heads of
``head_dim``, query head ``j`` reading key / value head ``j // (n /
n_kv)``, no rotary positions (HF's ``NemotronHAttention`` applies none;
``rope_theta`` goes unread)::

    out = o_proj(softmax(q k^T * head_dim ** -0.5 + causal mask) v)

Its MoE routes with the sigmoid router above (``n_group`` 1) and its
experts and shared expert are not gated: ``down(relu(up(x))^2)``
(``mlp_hidden_act`` ``relu2``), the shared expert of its own width
``moe_shared_expert_intermediate_size``.

Numerics, in the port's conventions: parameters live in ``param_dtype``
(f32 to train; the compute dtype for inference, built so and never
copied) and RMSNorm weights, ``A_log``, ``dt_bias`` and the correction
bias in f32 always; linear maps and the short convolutions compute in
their input's dtype; RMSNorm, the rotary products, the softmaxes, the
gates, KDA's normalisations, decays and recurrence and the experts'
combine in f32, each returning the compute dtype.  There is no dropout
(the published configs have none), and the modules start in eval mode.
Departures from the HF code, none of which changes the maths:

- RMSNorm multiplies by its f32 weight before the cast to the compute
  dtype (HF casts first, then multiplies by a weight of the model's
  dtype);
- the rotary products run in f32 on f32 cos / sin (HF casts cos and sin
  to the compute dtype); without positions the tables are identities
  (cos 1, sin 0), which leave ``q_pe`` and ``k_pe`` exact;
- the masked score is -1e9 in the compute dtype (HF: the dtype's least
  value);
- the top-k slots are taken sorted by score (by choice score for the
  sigmoid router), so a token's combine sums its experts in that order;
- on the card, where autograd records nothing, MLA's core between its
  projections and ``o_proj`` is one kernel, K6 (``ops/mla_attention.py``):
  its scores stay f32 (the eager chain rounds them to the compute dtype),
  a masked key is left out instead of biased, and P is rounded to the
  compute dtype before its division by the row's sum;
- KDA's recurrence runs chunked in f32 (the published code's Triton
  kernels ``chunk_kda`` compute it in sub-chunks): on the card, where
  autograd records nothing, in one kernel, K7 (``ops/kda_scan.py``), whose
  products, solve and state are f32 on the CUDA cores; otherwise (on the
  CPU, or where autograd records) in plain torch ops, :func:`kda_scan`,
  K7's twin.
  Its output is rounded to the compute dtype before the gated norm, as the
  published kernel returns it; the convolutions have no cache (encoding
  is one forward);
- Mamba-2's SSD scan runs chunked in f32 (HF's ``torch_forward`` form;
  the published kernels ``mamba_chunk_scan_combined`` compute it chunked
  too), every decay exponent the sum of the ``dt A`` it spans, B and C
  read by group, never broadcast to the heads in memory: on the card,
  where autograd records nothing, in one kernel, K8 (``ops/ssd_scan.py``),
  whose products and sums are f32 on the CUDA cores and which reads x, B
  and C in place from the convolution's output; otherwise (on the CPU, or
  where autograd records) in plain torch ops, :func:`ssd_scan`, K8's twin.
  Its output is rounded to the compute dtype before the gated norm, as
  the published kernel returns it; ``A_log``, ``dt_bias`` and ``D`` are
  held in f32 and the gated norm multiplies its f32 weight before the
  cast (HF casts, then multiplies);
- Nemotron-H's attention runs, on the card where autograd records
  nothing, as ``F.scaled_dot_product_attention`` (causal, the key / value
  heads shared by their groups of query heads), otherwise as its plain
  twin :func:`gqa_attention_plain` (f32 scores and softmax); neither reads
  the key mask: pads sit after every real position;
- the router's weight is held in the compute dtype (HF holds it in
  f32); its scores are f32 either way.

The MoE's implementation (:class:`MoE`): the router routes the rows it is
given, the real tokens of the batch where the caller names them
(``rows``, an index of the real positions of the flattened batch, made by
the caller from what it collated on the host) and every position
otherwise.  The routed rows are ordered by expert with one stable device
sort; per-expert counts come from a ``scatter_add_`` into ``E`` counters
and their ``cumsum`` (``bincount`` and boolean indexing read the device
on CUDA); each expert projection (three SwiGLU, two relu^2) is one grouped
GEMM (``torch._grouped_mm``, bf16, the group offsets kept on the device) over
the experts' row groups; the combine gathers each token's ``k`` rows
back by the inverse permutation and sums them weighted in f32: no atomics,
the same bits from run to run (on the card, where autograd records
nothing, in one kernel, K5 ``ops/moe_combine.py``).  No device-to-host
read happens inside the layer.  A layer holding a share sends the slots
of the experts it lacks to one more group past its own, which no GEMM
computes and whose slots weigh 0.  :func:`routed_experts_loop` is the
plain twin, a loop of matmuls over the held experts that reads each
expert's rows to the host; a CPU tensor takes it, a CUDA tensor takes the
grouped GEMMs or raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from dhr_tpu_torch.models.transformer import Dense
from dhr_tpu_torch.ops.kda_scan import fused_kda_scan
from dhr_tpu_torch.ops.mla_attention import mla_attention, mla_attention_plain
from dhr_tpu_torch.ops.moe_combine import combine, moe_combine
from dhr_tpu_torch.ops.ssd_scan import fused_ssd_scan
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
    # the router: "softmax" (DeepSeek-V2) or "sigmoid" with a correction
    # bias for the choice (Kimi Linear's moe_router_activation_func)
    router: str = "softmax"
    # [start, stop) of the routed experts this layer holds (one chip's
    # share of an expert-parallel layer); None: all of them
    experts_held: tuple[int, int] | None = None
    # MLA without rotary positions (Kimi Linear's mla_use_nope)
    mla_use_nope: bool = False
    # Kimi Linear's linear_attn_config: the KDA layers (1-based), their
    # heads, head width and short-convolution length
    kda_layers: tuple[int, ...] = ()
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    kda_conv_size: int = 4
    # Nemotron-H's blocks, one letter each ("M" Mamba-2, "*" attention,
    # "E" a mixture of experts), each holding that one mixer; "": the
    # blocks of attention then an FFN above
    hybrid_override_pattern: str = ""
    # Nemotron-H's Mamba-2 mixers: heads, head width, state, groups of B
    # and C, the convolution's taps, the SSD chunk
    mamba_num_heads: int = 64
    mamba_head_dim: int = 64
    ssm_state_size: int = 128
    n_groups: int = 8
    conv_kernel: int = 4
    chunk_size: int = 128
    # Nemotron-H's attention: key / value heads and the head width
    num_key_value_heads: int = 2
    head_dim: int = 128
    # the experts' activation: "silu" (SwiGLU: gate, up, down) or "relu2"
    # (down(relu(up(x))^2), Nemotron-H), and the shared expert's width
    # where it is a key of its own (0: n_shared x the expert width)
    mlp_hidden_act: str = "silu"
    moe_shared_expert_intermediate_size: int = 0
    dtype: torch.dtype = torch.bfloat16        # activation / compute dtype
    param_dtype: torch.dtype = torch.float32   # linear and embedding weights

    def __post_init__(self):
        if self.num_experts_per_tok > self.n_routed_experts:
            raise ValueError("num_experts_per_tok exceeds n_routed_experts")
        if self.router not in ("softmax", "sigmoid"):
            raise ValueError(f"router {self.router!r}: softmax or sigmoid")
        if self.experts_held is not None:
            lo, hi = self.experts_held
            if not 0 <= lo < hi <= self.n_routed_experts:
                raise ValueError(f"experts_held {self.experts_held} is not "
                                 f"a range inside the "
                                 f"{self.n_routed_experts} routed experts")
        if any(not 1 <= i <= self.num_layers for i in self.kda_layers):
            raise ValueError(f"kda_layers {self.kda_layers} are 1-based "
                             f"layer numbers up to {self.num_layers}")
        if self.mlp_hidden_act not in ("silu", "relu2"):
            raise ValueError(f"mlp_hidden_act {self.mlp_hidden_act!r}: "
                             f"silu or relu2")
        pattern = self.hybrid_override_pattern
        if pattern:
            if len(pattern) != self.num_layers or set(pattern) - set("M*E"):
                raise ValueError(f"hybrid_override_pattern {pattern!r} is "
                                 f"not {self.num_layers} letters of M, * "
                                 f"and E")
            if self.kda_layers:
                raise ValueError("a block pattern takes no kda_layers")
            if self.mamba_num_heads % self.n_groups \
                    or self.num_heads % self.num_key_value_heads:
                raise ValueError("n_groups must divide mamba_num_heads, "
                                 "and num_key_value_heads num_heads")

    @staticmethod
    def deepseek_v2_lite(**kw) -> "DecoderConfig":
        """DeepSeek-V2-Lite's published shape (its HF ``config.json``)."""
        return DecoderConfig(**kw)

    @staticmethod
    def kimi_linear_48b_a3b(**kw) -> "DecoderConfig":
        """Kimi-Linear-48B-A3B's published shape (its HF ``config.json``):
        27 layers at 2,304, 20 KDA layers (32 heads of 128, conv 4) and 7
        MLA layers without positions, layer 1 dense (9,216), then 256
        experts of 1,024 top-8 (sigmoid, renormalised, x 2.446) and one
        shared; vocabulary 163,840."""
        base = dict(vocab_size=163840, hidden_size=2304, num_layers=27,
                    num_heads=32, intermediate_size=9216,
                    moe_intermediate_size=1024, n_routed_experts=256,
                    n_shared_experts=1, num_experts_per_tok=8,
                    norm_topk_prob=True, routed_scaling_factor=2.446,
                    router="sigmoid", mla_use_nope=True, rope_factor=1.0,
                    max_position_embeddings=1048576, rms_norm_eps=1e-5,
                    kda_layers=KIMI_KDA_LAYERS)
        base.update(kw)
        return DecoderConfig(**base)

    @staticmethod
    def tiny_kimi_linear(**kw) -> "DecoderConfig":
        """A fast Kimi Linear config for tests: 1 dense + 3 MoE layers,
        KDA layers 1, 2 and 4 beside MLA layer 3 (no positions), 8
        experts top-3 (sigmoid) and one shared, small widths."""
        base = dict(vocab_size=1024, hidden_size=32, num_layers=4,
                    num_heads=2, intermediate_size=48,
                    moe_intermediate_size=16, n_routed_experts=8,
                    n_shared_experts=1, num_experts_per_tok=3,
                    norm_topk_prob=True, routed_scaling_factor=2.446,
                    router="sigmoid", mla_use_nope=True, rope_factor=1.0,
                    kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                    v_head_dim=8, max_position_embeddings=4096,
                    rms_norm_eps=1e-5, initializer_range=0.02,
                    kda_layers=(1, 2, 4), kda_num_heads=2, kda_head_dim=8)
        base.update(kw)
        return DecoderConfig(**base)

    @staticmethod
    def nemotron_3_nano_30b_a3b(**kw) -> "DecoderConfig":
        """NVIDIA-Nemotron-3-Nano-30B-A3B's published shape (its HF
        ``config.json``, ``model_type`` ``nemotron_h``): 52 blocks at
        2,688 after :data:`NEMOTRON_3_NANO_PATTERN`, 23 Mamba-2 mixers (64
        heads of 64, state 128, 8 groups, conv 4, chunk 128), 6 attention
        layers (32 query and 2 key / value heads of 128, no positions), 23
        MoE layers of 128 relu^2 experts of 1,856 top-6 (sigmoid,
        renormalised, x 2.5) and one shared of 3,712; vocabulary 131,072,
        untied head."""
        base = dict(vocab_size=131072, hidden_size=2688, num_layers=52,
                    num_heads=32, num_key_value_heads=2, head_dim=128,
                    intermediate_size=1856, moe_intermediate_size=1856,
                    n_routed_experts=128, n_shared_experts=1,
                    moe_shared_expert_intermediate_size=3712,
                    num_experts_per_tok=6, first_k_dense_replace=0,
                    norm_topk_prob=True, routed_scaling_factor=2.5,
                    router="sigmoid", mlp_hidden_act="relu2",
                    hybrid_override_pattern=NEMOTRON_3_NANO_PATTERN,
                    mamba_num_heads=64, mamba_head_dim=64, ssm_state_size=128,
                    n_groups=8, conv_kernel=4, chunk_size=128,
                    max_position_embeddings=262144, rms_norm_eps=1e-5,
                    initializer_range=0.02)
        base.update(kw)
        return DecoderConfig(**base)

    @staticmethod
    def tiny_nemotron_h(**kw) -> "DecoderConfig":
        """A fast Nemotron-H config for tests: blocks ``MEM*EME``, 4 Mamba
        heads of 8 (state 16, 2 groups, chunk 16), 4 query and 2 key /
        value heads of 8, 8 relu^2 experts top-3 and one shared of its own
        width."""
        base = dict(vocab_size=1024, hidden_size=32, num_layers=7,
                    num_heads=4, num_key_value_heads=2, head_dim=8,
                    intermediate_size=16, moe_intermediate_size=16,
                    n_routed_experts=8, n_shared_experts=1,
                    moe_shared_expert_intermediate_size=24,
                    num_experts_per_tok=3, first_k_dense_replace=0,
                    norm_topk_prob=True, routed_scaling_factor=2.5,
                    router="sigmoid", mlp_hidden_act="relu2",
                    hybrid_override_pattern="MEM*EME", mamba_num_heads=4,
                    mamba_head_dim=8, ssm_state_size=16, n_groups=2,
                    conv_kernel=4, chunk_size=16,
                    max_position_embeddings=4096, rms_norm_eps=1e-5,
                    initializer_range=0.02)
        base.update(kw)
        return DecoderConfig(**base)

    def is_kda(self, layer: int) -> bool:
        """Layer ``layer`` (0-based) is a KDA layer."""
        return layer + 1 in self.kda_layers

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
        if self.hybrid_override_pattern:
            return self.hybrid_override_pattern[layer] == "E"
        return (self.n_routed_experts > 0
                and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


KIMI_KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
                   23, 25, 26)
NEMOTRON_3_NANO_PATTERN = \
    "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"


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


def position_tables(cfg: DecoderConfig, length: int, device):
    """MLA's ``(cos, sin)``: :func:`rotary`'s, or identities (cos 1, sin
    0) for MLA without positions, which leave the rope half exact."""
    if not cfg.mla_use_nope:
        return rotary(cfg, length, device)
    shape = (length, cfg.qk_rope_head_dim)
    return (torch.ones(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


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


def check_card_dtype(cfg: DecoderConfig, device) -> None:
    """Refuse a decoder that would run inference on the card in another
    compute dtype than bf16: there, where autograd records nothing, its
    MLA core is K6 (:func:`mla_attention`), which takes bf16 alone."""
    if torch.device(device).type == "cuda" and cfg.dtype != torch.bfloat16:
        raise ValueError(
            f"a decoder backbone runs inference on the card in bfloat16 "
            f"only (its attention core's kernel takes bfloat16), not "
            f"{cfg.dtype}: build its DecoderConfig with "
            f"dtype=torch.bfloat16 (the CLI's --bf16), or run it on the CPU")


class MLA(nn.Module):
    """Multi-head latent attention, in its prefill form: ``k_nope`` and
    ``v`` per head from ``kv_b_proj``, ``k_pe`` one head shared by all
    (encoding is one forward, so no cache)."""

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
        m = 1.0 if cfg.mla_use_nope else yarn_mscale(
            cfg.rope_factor, cfg.rope_mscale_all_dim)
        self.scale = q_dim ** -0.5 * m * m

    def forward(self, x, mask, cos, sin):
        """``x`` (B, L, H), ``mask`` the (B, L) attention mask, ``cos`` and
        ``sin`` :func:`rotary`'s.  The core between the projections and
        ``o_proj`` is K6 (:func:`mla_attention`) for CUDA tensors where
        autograd records nothing, :func:`mla_attention_plain` otherwise."""
        q = self.q_proj(x)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.d_rope],
                                                   dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c))
        records = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, kv, k_pe))
        core = mla_attention if x.is_cuda and not records \
            else mla_attention_plain
        out = core(q, kv, k_pe, cos, sin, mask, self.n, self.d_nope,
                   self.scale)
        return self.o_proj(out)


# -- Kimi Delta Attention --------------------------------------------------

KDA_CHUNK = 64      # the recurrence's chunk
KDA_SUB = 8         # a chunk's sub-chunks, at whose edges decays factor
KDA_BLOCK_BYTES = 1 << 30   # the within-chunk transients of a block of chunks


def l2norm(t: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``t * rsqrt(sum(t^2) + eps)`` over the last dim, in f32."""
    t = t.float()
    return t * torch.rsqrt(t.pow(2).sum(-1, keepdim=True) + eps)


def _chunk_local(q, k, v, g, beta, sub: int):
    """The part of :func:`kda_scan` that each chunk computes alone, for
    chunks laid out ``(..., C, d)`` in f32: ``g`` the log-decays (<= 0),
    ``beta`` ``(..., C)``.  Returns ``(u, wk, qs, o_in, ks, decay)``: the
    chunk's recurrence is then, from its entering state ``S``, ``W = u -
    wk S``, ``o = o_in + qs S`` and ``S' = decay * S + ks^T W``.

    With ``G`` the cumulative log-decay within the chunk, ``A[r, s] =
    beta_r sum_i k_r,i k_s,i exp(G_r,i - G_s,i)`` (s < r) and ``P[r, s] =
    sum_i q_r,i k_s,i exp(G_r,i - G_s,i)`` (s <= r).  For ``s`` in an
    earlier sub-chunk than ``r`` the decay factors at the end ``e`` of the
    sub-chunk before ``r``'s, ``exp(G_r - G_e) exp(G_e - G_s)``, and the
    pair is one matrix product; inside a sub-chunk it is taken pairwise.
    Every exponent is a sum of the ``g`` it spans (cumulative sums and sums
    of whole sub-chunks, never a difference of two), so each is <= 0 and
    keeps its relative precision however far the decay has run.  ``(I +
    A) [u | wk] = [beta v | beta exp(G) k]`` is one unit-triangular
    solve."""
    C, d = k.shape[-2:]
    ns = C // sub
    lead = k.shape[:-2]
    dev = k.device
    gs, ks_, qs_ = (t.unflatten(-2, (ns, sub)) for t in (g, k, q))
    incl = gs.cumsum(-2)              # g over [sub-chunk start, t]
    # g over (t, sub-chunk end]: the shifted g summed from the end
    after = F.pad(gs[..., 1:, :], (0, 0, 0, 1)).flip(-2).cumsum(-2).flip(-2)
    # between[I, J]: g over the whole sub-chunks strictly between J and I
    # (I = ns: to the chunk's end), -inf where J >= I
    blk = torch.arange(ns, device=dev)
    inside = (blk[None, :, None] < blk[None, None, :]) \
        & (blk[None, None, :] < torch.arange(ns + 1, device=dev)[:, None,
                                                                  None])
    between = torch.matmul(inside.flatten(0, 1).float(), incl[..., -1, :]) \
        .unflatten(-2, (ns + 1, ns))
    between = between.masked_fill(
        (blk[None, :] >= torch.arange(ns + 1, device=dev)[:, None])[..., None],
        float("-inf"))
    col = (between[..., :ns, :, None, :] + after.unsqueeze(-4)) \
        .flatten(-3, -2).exp_().mul_(k.unsqueeze(-3))   # (.., ns, C, d)
    row = incl.exp()
    lhs = torch.cat([ks_ * row, qs_ * row], dim=-2)       # (.., ns, 2s, d)
    off = torch.matmul(lhs, col.transpose(-1, -2))        # (.., ns, 2s, C)
    a = off[..., :sub, :].reshape(*lead, C, C)
    p = off[..., sub:, :].reshape(*lead, C, C)
    sp = torch.arange(sub, device=dev)
    # g over (s, r] inside a sub-chunk: (.., ns, r, s, d)
    pair = (gs.unsqueeze(-2) * (sp[:, None] > sp[None, :])[..., None]) \
        .cumsum_(-3).exp_().mul_(ks_.unsqueeze(-3))
    both = torch.matmul(pair, torch.stack([ks_, qs_], dim=-1))
    tri = torch.ones(sub, sub, dtype=torch.bool, device=dev).tril()
    a.view(*lead, ns, sub, ns, sub).diagonal(0, -4, -2).add_(
        (both[..., 0] * tri.tril(-1)).movedim(-3, -1))
    p.view(*lead, ns, sub, ns, sub).diagonal(0, -4, -2).add_(
        (both[..., 1] * tri).movedim(-3, -1))
    a.mul_(beta[..., None])
    eg = g.cumsum(-2).exp_()
    dv = v.shape[-1]
    x = torch.linalg.solve_triangular(
        a, torch.cat([v, eg * k], dim=-1) * beta[..., None], upper=False,
        unitriangular=True)
    u, wk = x[..., :dv], x[..., dv:]
    ks = (between[..., ns, :, None, :] + after).flatten(-3, -2).exp_() * k
    return (u, wk, (eg * q).sub_(torch.matmul(p, wk)), torch.matmul(p, u),
            ks, eg[..., -1, :])


def kda_scan(q, k, v, g, beta) -> torch.Tensor:
    """KDA's recurrence from its post-convolution ``q``, ``k``, ``v``
    ``(B, L, h, d)``, log-decays ``g`` ``(B, L, h, d)`` (<= 0) and ``beta``
    ``(B, L, h)``: ``o`` ``(B, L, h, d_v)`` in ``v``'s dtype, with ``q``
    and ``k`` L2-normed here and ``q`` scaled by ``d ** -0.5`` (the
    published ``chunk_kda`` with ``use_qk_l2norm_in_kernel``).

    Chunked, in f32 plain torch ops: each chunk of :data:`KDA_CHUNK`
    positions computes its local part (:func:`_chunk_local`) for a block
    of chunks at a time, whose transients stay under
    :data:`KDA_BLOCK_BYTES`, and the state ``(d, d_v)`` per passage and
    head passes from chunk to chunk, three batched products a chunk:
    ``ceil(L / 64)`` steps.  A position sees only itself and those before
    it, so right padding changes no real output.

    This is the plain version: on the card, where autograd records
    nothing, :class:`KDA` takes K7 (``ops/kda_scan.py``
    :func:`~dhr_tpu_torch.ops.kda_scan.fused_kda_scan`) instead, which
    computes the same in one kernel; this twin runs on the CPU and where
    autograd records (K7 has no backward)."""
    B, L, h, d = k.shape
    dv = v.shape[-1]
    chunk, sub = KDA_CHUNK, KDA_SUB
    n = -(-L // chunk)
    BH, dev = B * h, k.device

    def lay(t):   # (B, L, h, e) -> (n, B h, chunk, e) f32, right-padded
        t = F.pad(t, (0, 0, 0, 0, 0, n * chunk - L))
        t = t.view(B, n, chunk, h, -1).permute(1, 0, 3, 2, 4)
        return torch.empty(t.shape, dtype=torch.float32,
                           device=dev).copy_(t).view(n, BH, chunk, -1)

    qc = lay(l2norm(q) * d ** -0.5)
    kc, vc = lay(l2norm(k)), lay(v)
    gc = lay(g)
    bc = lay(beta.float()[..., None])[..., 0]
    per = 4 * (chunk // sub * (sub * sub * d + chunk * d)
               + chunk * (6 * d + 3 * dv + 4 * chunk))
    nb = max(1, min(n, KDA_BLOCK_BYTES // (BH * per)))
    out = torch.empty(n, BH, chunk, dv, dtype=torch.float32, device=dev)
    state = torch.zeros(BH, d, dv, dtype=torch.float32, device=dev)
    for c0 in range(0, n, nb):
        c1 = min(c0 + nb, n)
        u, wk, qs, o_in, ks, decay = _chunk_local(
            qc[c0:c1], kc[c0:c1], vc[c0:c1], gc[c0:c1], bc[c0:c1], sub)
        states = torch.empty(c1 - c0 + 1, BH, d, dv, dtype=torch.float32,
                             device=dev)
        states[0] = state
        for j in range(c1 - c0):
            w = torch.baddbmm(u[j], wk[j], states[j], alpha=-1)
            torch.baddbmm(states[j] * decay[j][..., None],
                          ks[j].transpose(-1, -2), w, out=states[j + 1])
        out[c0:c1] = torch.matmul(qs, states[:-1]).add_(o_in)
        state = states[-1]
    o = out.view(n, B, h, chunk, dv).permute(1, 0, 3, 2, 4) \
        .reshape(B, n * chunk, h, dv)
    return o[:, :L].to(v.dtype)


class ShortConv(nn.Module):
    """The published ``ShortConvolution``: a causal depthwise convolution
    over the last ``size`` positions, then SiLU; its weight ``(D, 1,
    size)`` and, where ``bias`` (Mamba-2's ``conv1d``), its bias ``(D,)``
    as ``nn.Conv1d``'s (KDA's have none).  Computes in its input's
    dtype."""

    def __init__(self, dim: int, size: int, dtype, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, size, dtype=dtype))
        self.register_parameter("bias", nn.Parameter(
            torch.zeros(dim, dtype=dtype)) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L, size = x.shape[1], self.weight.shape[-1]
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), bias,
                     padding=size - 1, groups=x.shape[-1])
        return F.silu(y[..., :L]).transpose(1, 2)


class KDA(nn.Module):
    """Kimi Delta Attention (the module docstring's equations), under the
    published names; ``A_log`` ``(1, 1, h, 1)`` and ``dt_bias`` ``(D,)`` in
    f32.  Device span ``kda.scan`` around the recurrence: K7
    (:func:`fused_kda_scan`) for CUDA tensors where autograd records
    nothing, the plain :func:`kda_scan` otherwise."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        H, pd = cfg.hidden_size, cfg.param_dtype
        self.h, self.d = cfg.kda_num_heads, cfg.kda_head_dim
        D = self.h * self.d
        for c in ("q", "k", "v"):
            setattr(self, f"{c}_proj", Dense(H, D, bias=False, dtype=pd))
            setattr(self, f"{c}_conv1d", ShortConv(D, cfg.kda_conv_size, pd))
        self.A_log = nn.Parameter(torch.zeros(1, 1, self.h, 1))
        self.f_a_proj = Dense(H, self.d, bias=False, dtype=pd)
        self.f_b_proj = Dense(self.d, D, bias=False, dtype=pd)
        self.dt_bias = nn.Parameter(torch.zeros(D))
        self.b_proj = Dense(H, self.h, bias=False, dtype=pd)
        self.g_a_proj = Dense(H, self.d, bias=False, dtype=pd)
        self.g_b_proj = Dense(self.d, D, bias=True, dtype=pd)
        self.o_norm = RMSNorm(self.d, cfg.rms_norm_eps)
        self.o_proj = Dense(D, H, bias=False, dtype=pd)

    def forward(self, x, mask=None, cos=None, sin=None):
        """``x`` (B, L, H) right-padded; ``mask``, ``cos`` and ``sin`` are
        not read (causal order keeps pads out of real positions)."""
        B, L, _ = x.shape
        heads = (B, L, self.h, self.d)
        q, k, v = (getattr(self, f"{c}_conv1d")(
            getattr(self, f"{c}_proj")(x)).reshape(heads) for c in "qkv")
        g = self.f_b_proj(self.f_a_proj(x)).float().reshape(heads)
        g = F.softplus(g + self.dt_bias.float().view(self.h, self.d)) \
            * -self.A_log.float().view(self.h, 1).exp()
        beta = torch.sigmoid(self.b_proj(x).float())
        records = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, g, beta))
        scan = fused_kda_scan if x.is_cuda and not records else kda_scan
        with profiling.span("kda.scan", device=True):
            o = scan(q, k, v, g, beta)
        gate = torch.sigmoid(self.g_b_proj(self.g_a_proj(x)).float())
        o = self.o_norm(o.float()) * gate.reshape(heads)
        return self.o_proj(o.reshape(B, L, -1).to(x.dtype))


# -- Nemotron-H: Mamba-2 and attention with grouped key / value heads -----

SSD_BLOCK_BYTES = 1 << 30   # the within-chunk transients of a block of chunks


def ssd_scan(x, dt, A, B, C, D, chunk: int = 128) -> torch.Tensor:
    """Mamba-2's SSD recurrence from its post-convolution ``x`` ``(Bt, L,
    h, P)``, ``dt`` ``(Bt, L, h)`` (>= 0), ``A`` ``(h,)`` (< 0), ``B`` and
    ``C`` ``(Bt, L, g, N)`` (head ``j`` reads group ``j // (h / g)``) and
    the skip ``D`` ``(h,)``: ``y`` ``(Bt, L, h, P)`` in ``x``'s dtype, ``y_t
    = S_t C_t + D x_t`` with ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t
    B_t^T`` from ``S_0 = 0``.

    Chunked, in f32 plain torch ops (HF's ``torch_forward``): within a
    chunk of ``chunk`` positions, with ``a = dt A`` (<= 0), the output is
    ``(C B^T o exp(seg)) (dt x)`` per head, ``seg[i, j]`` the ``a`` summed
    over ``(j, i]`` (a masked cumulative sum, HF's ``segment_sum``), plus
    the entering state's ``exp(a summed over [0, i]) C_i S``; a chunk's
    state is ``B^T (exp(a summed over (j, end]) dt x)`` and passes on
    decayed by its ``a`` summed whole.  Every exponent is a sum of the
    ``a`` it spans, never a difference of two cumulative sums, so each is
    <= 0 and keeps its precision however far the decay has run.  ``C
    B^T`` is one product a group, the states' and the entering state's
    products one a group over its heads side by side: B and C are never
    broadcast to the heads in memory.  The within-chunk transients of a
    block of chunks at a time stay under :data:`SSD_BLOCK_BYTES`.  A
    position sees only itself and those before it, so right padding
    changes no real output."""
    Bt, L, h, P = x.shape
    g, N = B.shape[-2:]
    r = h // g
    n = -(-L // chunk)
    pad = n * chunk - L
    f32 = torch.float32
    dt = dt.float()
    # (Bt, n, c, g, r, P) and (Bt, n, g, c, N), zeros past the end
    xd = F.pad(x.float() * dt[..., None], (0, 0, 0, 0, 0, pad)).view(
        Bt, n, chunk, g, r, P)
    Bc, Cc = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).view(
        Bt, n, chunk, g, N).transpose(2, 3) for t in (B, C))
    a = F.pad(dt * A.float(), (0, 0, 0, pad)).view(Bt, n, chunk, g, r) \
        .permute(0, 1, 3, 4, 2)                       # (Bt, n, g, r, c)
    upto = a.cumsum(-1)                                  # a over [0, i]
    after = F.pad(a[..., 1:], (0, 1)).flip(-1).cumsum(-1).flip(-1)
    # each chunk's own state: B^T (exp(a over (j, end]) dt x), a group's
    # heads side by side
    xe = xd.transpose(2, 3) * after.exp().transpose(-1, -2)[..., None]
    own = torch.matmul(Bc.transpose(-1, -2), xe.flatten(-2))  # (.., N, rP)
    decay = upto[..., -1].exp()                           # (Bt, n, g, r)
    states = torch.empty_like(own)                        # entering each
    s = torch.zeros_like(own[:, 0])
    for j in range(n):
        states[:, j] = s
        s = (s.unflatten(-1, (r, P)) * decay[:, j, :, None, :, None]) \
            .flatten(-2) + own[:, j]
    del xe, own
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device)
    below, upper = tri.tril(-1), ~tri.tril()
    per = 4 * g * r * chunk * chunk * 3
    nb = max(1, min(n, SSD_BLOCK_BYTES // (Bt * per)))
    y = torch.empty(Bt, n, chunk, g, r, P, dtype=f32, device=x.device)
    for c0 in range(0, n, nb):
        c1 = min(c0 + nb, n)
        ab = a[:, c0:c1]
        # seg[i, j]: a over (j, i], -inf above the diagonal
        seg = ab[..., :, None].expand(*ab.shape, chunk) \
            .masked_fill(~below, 0.0).cumsum(-2).masked_fill_(upper,
                                                            float("-inf"))
        cb = torch.matmul(Cc[:, c0:c1], Bc[:, c0:c1].transpose(-1, -2))
        m = seg.exp_().mul_(cb[:, :, :, None])           # (.., g, r, c, c)
        del seg, cb
        inner = torch.matmul(m, xd[:, c0:c1].permute(0, 1, 3, 4, 2, 5))
        del m
        enter = torch.matmul(Cc[:, c0:c1], states[:, c0:c1]).unflatten(
            -1, (r, P)) * upto[:, c0:c1].exp().transpose(-1, -2)[..., None]
        y[:, c0:c1] = (inner.transpose(3, 4) + enter).transpose(2, 3)
        del inner, enter
    y = y.view(Bt, n * chunk, h, P)[:, :L] + D.float()[:, None] * x.float()
    return y.to(x.dtype)


class GatedRMSNorm(nn.Module):
    """Mamba-2's ``MambaRMSNormGated`` (``norm_before_gate=False``): ``y *
    SiLU(z)`` normed over groups of ``dim / groups`` channels, times an f32
    weight, in f32, returning ``y``'s dtype."""

    def __init__(self, dim: int, groups: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        t = (y.float() * F.silu(z.float())).unflatten(-1, (self.groups, -1))
        t = t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + self.eps)
        return (t.flatten(-2) * self.weight.float()).to(y.dtype)


class Mamba2(nn.Module):
    """Nemotron-H's Mamba-2 mixer (the module docstring's equations) under
    the published names: ``in_proj``, ``conv1d`` (with its bias),
    ``dt_bias``, ``A_log`` and ``D`` ``(h,)`` in f32, ``norm`` (gated,
    grouped), ``out_proj``.  Device span ``mamba.scan`` around the
    recurrence: K8 (:func:`fused_ssd_scan`, reading x, B and C in place
    from the convolution's output) for CUDA tensors where autograd records
    nothing, the plain :func:`ssd_scan` otherwise."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        H, pd = cfg.hidden_size, cfg.param_dtype
        self.h, self.p = cfg.mamba_num_heads, cfg.mamba_head_dim
        self.g, self.n = cfg.n_groups, cfg.ssm_state_size
        self.chunk = cfg.chunk_size
        D = self.h * self.p
        self.split = (D, D + 2 * self.g * self.n, self.h)
        self.in_proj = Dense(H, sum(self.split), bias=False, dtype=pd)
        self.conv1d = ShortConv(self.split[1], cfg.conv_kernel, pd,
                                bias=True)
        self.dt_bias = nn.Parameter(torch.ones(self.h))
        self.A_log = nn.Parameter(torch.arange(1, self.h + 1,
                                               dtype=torch.float32).log())
        self.D = nn.Parameter(torch.ones(self.h))
        self.norm = GatedRMSNorm(D, self.g, cfg.rms_norm_eps)
        self.out_proj = Dense(D, H, bias=False, dtype=pd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, L, H) right-padded (causal order keeps pads out of
        real positions)."""
        B, L, _ = x.shape
        D, gn = self.split[0], self.g * self.n
        z, xbc, dt = self.in_proj(x).split(self.split, dim=-1)
        xs, b, c = self.conv1d(xbc).split([D, gn, gn], dim=-1)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        with profiling.span("mamba.scan", device=True):
            args = (xs.reshape(B, L, self.h, self.p), dt,
                    -self.A_log.float().exp(),
                    b.reshape(B, L, self.g, self.n),
                    c.reshape(B, L, self.g, self.n), self.D.float())
            records = torch.is_grad_enabled() and any(
                t.requires_grad for t in args)
            scan = fused_ssd_scan if x.is_cuda and not records else ssd_scan
            y = scan(*args, self.chunk)
        return self.out_proj(self.norm(y.reshape(B, L, D), z))


def gqa_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention of ``q`` ``(B, n, L, d)`` over ``k`` and ``v``
    ``(B, n_kv, L, d)``, query head ``j`` reading key / value head ``j //
    (n / n_kv)``: scores and softmax in f32, P in ``v``'s dtype times
    ``v``; ``(B, n, L, d)``."""
    B, n, L, d = q.shape
    kv = k.shape[1]
    qg = q.float().reshape(B, kv, n // kv, L, d)
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.matmul(p.to(v.dtype), v[:, :, None]).view(B, n, L, d)


class GQA(nn.Module):
    """Nemotron-H's attention: ``q_proj``, ``k_proj``, ``v_proj``,
    ``o_proj`` (no bias), no positions, scale ``head_dim ** -0.5``.  The
    core is ``F.scaled_dot_product_attention`` (causal, grouped) for CUDA
    tensors where autograd records nothing, :func:`gqa_attention_plain`
    otherwise."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        H, pd = cfg.hidden_size, cfg.param_dtype
        self.n, self.kv, self.d = (cfg.num_heads, cfg.num_key_value_heads,
                                   cfg.head_dim)
        self.q_proj = Dense(H, self.n * self.d, bias=False, dtype=pd)
        self.k_proj = Dense(H, self.kv * self.d, bias=False, dtype=pd)
        self.v_proj = Dense(H, self.kv * self.d, bias=False, dtype=pd)
        self.o_proj = Dense(self.n * self.d, H, bias=False, dtype=pd)
        self.scale = self.d ** -0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, L, H) right-padded; the key mask is not read (a pad
        sits after every real position)."""
        B, L, _ = x.shape
        q = self.q_proj(x).view(B, L, self.n, self.d).transpose(1, 2)
        k, v = (p(x).view(B, L, self.kv, self.d).transpose(1, 2)
                for p in (self.k_proj, self.v_proj))
        records = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        if x.is_cuda and not records:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=self.scale, enable_gqa=True)
        else:
            out = gqa_attention_plain(q, k, v, self.scale)
        return self.o_proj(out.transpose(1, 2).reshape(B, L, -1))


class MLP(nn.Module):
    """SwiGLU, ``down(silu(gate(x)) * up(x))``; with ``act`` ``"relu2"``
    Nemotron-H's form, not gated and without ``gate_proj``:
    ``down(relu(up(x))^2)``."""

    def __init__(self, hidden: int, width: int, dtype, act: str = "silu"):
        super().__init__()
        self.gated = act == "silu"
        if self.gated:
            self.gate_proj = Dense(hidden, width, bias=False, dtype=dtype)
        self.up_proj = Dense(hidden, width, bias=False, dtype=dtype)
        self.down_proj = Dense(width, hidden, bias=False, dtype=dtype)

    def forward(self, x):
        if self.gated:
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return self.down_proj(F.relu(self.up_proj(x)).square())


class Experts(nn.Module):
    """The routed experts' weights, stacked: ``gate_proj`` (SwiGLU alone)
    and ``up_proj`` ``(E, width, H)``, ``down_proj`` ``(E, H, width)``
    (each expert's ``nn.Linear`` layout); ``act`` as :class:`MLP`'s.
    :meth:`weights` gives the input projections, then ``down_proj``;
    :meth:`act` joins the input projections' outputs."""

    def __init__(self, n: int, hidden: int, width: int, dtype,
                 act: str = "silu"):
        super().__init__()
        self.gated = act == "silu"
        if self.gated:
            self.gate_proj = nn.Parameter(torch.empty(n, width, hidden,
                                                      dtype=dtype))
        self.up_proj = nn.Parameter(torch.empty(n, width, hidden,
                                                dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, width,
                                                  dtype=dtype))

    def weights(self, dtype):
        """The stacks in ``dtype`` (a no-op where they are)."""
        ws = (self.gate_proj,) if self.gated else ()
        return tuple(w.to(dtype) for w in (*ws, self.up_proj,
                                           self.down_proj))

    def act(self, *ins: torch.Tensor) -> torch.Tensor:
        if self.gated:
            gate, up = ins
            return F.silu(gate) * up
        return F.relu(ins[0]).square()


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


def route_sigmoid(x: torch.Tensor, gate_weight: torch.Tensor,
                  bias: torch.Tensor, k: int, scaling: float = 1.0,
                  norm_topk: bool = True):
    """``(experts (N, k) int64, weights (N, k) f32)``: sigmoid scores in
    f32, the top ``k`` of the scores plus ``bias`` (highest first), their
    scores renormalised and times ``scaling``."""
    scores = torch.sigmoid(F.linear(x.float(), gate_weight.float()))
    _, idx = torch.topk(scores + bias.float(), k, dim=-1, sorted=True)
    w = scores.gather(1, idx)
    if k > 1 and norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * scaling


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


def routed_experts_grouped(x, idx, weights, experts: Experts,
                           first: int | None = None):
    """The routed part of an MoE layer on ``x`` (N, H): dispatch, a grouped
    GEMM a stack (three SwiGLU, two relu^2), combine.  No device-to-host
    read.  Where autograd records nothing the combine is
    :func:`moe_combine` (K5 on the card, :func:`combine` on the CPU);
    otherwise the eager :func:`combine`, which autograd differentiates.

    ``first``: the global id of the first expert ``experts`` holds, where
    it holds a share (None: all).  The slots of other experts then form
    one more group past the held ones, which no GEMM computes (its rows
    stay unwritten); they weigh 0 and read row 0, which is a held expert's
    row, or zeroed where no slot of the batch is held."""
    E = experts.down_proj.shape[0]
    if first is not None:
        held = (idx >= first) & (idx < first + E)
        idx = torch.where(held, idx - first, E)
        weights = torch.where(held, weights, 0.0)
    d = dispatch(idx, E if first is None else E + 1)
    offs = d.offs[:E]
    *ins, wd = experts.weights(x.dtype)
    xs = x[d.token]
    h = experts.act(*(grouped_mm(xs, w, offs) for w in ins))
    rows = grouped_mm(h, wd, offs)
    slot = d.slot
    if first is not None:
        slot = torch.where(held, slot, 0)
        rows[:1].masked_fill_(offs[-1:] == 0, 0)
    if torch.is_grad_enabled() and (rows.requires_grad
                                    or weights.requires_grad):
        return combine(rows, slot, weights)
    return moe_combine(rows, slot, weights)


def routed_experts_loop(x, idx, weights, experts: Experts,
                        first: int | None = None):
    """The plain twin of :func:`routed_experts_grouped`: each held
    expert's rows found on the host (one read an expert, counted as
    ``moe.host_reads`` once for the layer), a matmul chain per expert,
    the same combine (the slots of experts not held keep zero rows)."""
    N, k = idx.shape
    *ins, wd = experts.weights(x.dtype)
    rows = torch.zeros(N * k, x.shape[-1], dtype=x.dtype, device=x.device)
    flat = idx.reshape(-1)
    profiling.count("moe.host_reads", wd.shape[0])
    for e in range(wd.shape[0]):
        at = torch.nonzero(flat == (first or 0) + e)[:, 0]
        if at.numel() == 0:
            continue
        t = x[at // k]
        h = experts.act(*(t @ w[e].T for w in ins))
        rows[at] = h @ wd[e].T
    slot = torch.arange(N * k, device=x.device).view(N, k)
    return combine(rows, slot, weights)


class MoEGate(nn.Module):
    """The router: its weight ``(E, H)``; a sigmoid router's
    ``e_score_correction_bias`` ``(E,)`` f32 too (a buffer).  Its forward
    gives ``(experts (N, k) int64, weights (N, k) f32)`` of the rows it is
    given (:func:`route` or :func:`route_sigmoid`), so a forward hook on it
    sees the layer's routes."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        n = cfg.n_routed_experts
        self.k = cfg.num_experts_per_tok
        self.scaling = cfg.routed_scaling_factor
        self.norm_topk = cfg.norm_topk_prob
        self.sigmoid = cfg.router == "sigmoid"
        self.weight = nn.Parameter(torch.empty(n, cfg.hidden_size,
                                               dtype=cfg.param_dtype))
        if self.sigmoid:
            self.register_buffer("e_score_correction_bias", torch.zeros(n))

    def forward(self, t: torch.Tensor):
        if self.sigmoid:
            return route_sigmoid(t, self.weight, self.e_score_correction_bias,
                                 self.k, self.scaling, self.norm_topk)
        return route(t, self.weight, self.k, self.scaling, self.norm_topk)


class MoE(nn.Module):
    """Router, routed experts and shared experts.  ``rows``: the flattened
    positions to route (the batch's real tokens); the others get an FFN
    output of 0.  Device spans ``moe.route`` (gate, softmax or sigmoid,
    top-k) and ``moe.experts`` (dispatch, the grouped GEMMs: three
    SwiGLU, two relu^2; combine); the counter ``moe.host_reads`` counts
    the layer's device reads (0 on the grouped path).  With
    ``cfg.experts_held`` the layer holds those experts alone
    (``experts.*`` stacks of their number), routes over all and sums their
    terms alone.  ``cfg.mlp_hidden_act``
    chooses the form of :class:`Experts` and the shared :class:`MLP` when
    the layer is built: SwiGLU or relu^2 (the shared expert then
    ``moe_shared_expert_intermediate_size`` wide)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        H, pd = cfg.hidden_size, cfg.param_dtype
        self.gate = MoEGate(cfg)
        lo, hi = cfg.experts_held or (0, cfg.n_routed_experts)
        self.first = None if cfg.experts_held is None else lo
        act = cfg.mlp_hidden_act
        self.experts = Experts(hi - lo, H, cfg.moe_intermediate_size, pd,
                               act)
        width = (cfg.moe_shared_expert_intermediate_size
                 or cfg.moe_intermediate_size * cfg.n_shared_experts)
        self.shared_experts = MLP(H, width, pd, act) \
            if cfg.n_shared_experts else None

    def forward(self, x: torch.Tensor, rows: torch.Tensor | None = None):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        t = flat if rows is None else flat.index_select(0, rows)
        with profiling.span("moe.route", device=True):
            idx, w = self.gate(t)
        with profiling.span("moe.experts", device=True):
            if t.is_cuda:
                y = routed_experts_grouped(t, idx, w, self.experts,
                                           self.first)
                profiling.count("moe.host_reads", 0)
            elif t.device.type == "cpu":
                y = routed_experts_loop(t, idx, w, self.experts, self.first)
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
        kda = cfg.is_kda(layer)
        self.self_attn = KDA(cfg) if kda else MLA(cfg)
        self.attn_span = "kda.attention" if kda else "mla.attention"
        self.post_attention_layernorm = RMSNorm(H, eps)
        self.mlp = MoE(cfg) if cfg.is_moe(layer) else MLP(
            H, cfg.intermediate_size, cfg.param_dtype)

    def forward(self, x, mask, cos, sin, rows=None):
        with profiling.span(self.attn_span, device=True):
            x = x + self.self_attn(self.input_layernorm(x), mask, cos, sin)
        h = self.post_attention_layernorm(x)
        h = self.mlp(h, rows) if isinstance(self.mlp, MoE) else self.mlp(h)
        return x + h


class MixerBlock(nn.Module):
    """A Nemotron-H block: ``x + MIXER(RMSNorm(x))``, its mixer the
    pattern's letter for the block (``M`` :class:`Mamba2`, ``*``
    :class:`GQA`, ``E`` :class:`MoE`), under the published names ``norm``
    and ``mixer``.  Device spans ``mamba.mixer`` and ``gqa.attention``
    around a whole M or * block (norm, mixer, residual); an E block's
    are its MoE's."""

    MIXERS = {"M": ("mamba.mixer", Mamba2), "*": ("gqa.attention", GQA),
              "E": (None, MoE)}

    def __init__(self, cfg: DecoderConfig, layer: int):
        super().__init__()
        self.span, mixer = self.MIXERS[cfg.hybrid_override_pattern[layer]]
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mixer = mixer(cfg)

    def forward(self, x, mask=None, cos=None, sin=None, rows=None):
        """``mask``, ``cos`` and ``sin`` are not read; ``rows``: the real
        positions an E block routes (:class:`MoE`)."""
        if self.span is None:
            return x + self.mixer(self.norm(x), rows)
        with profiling.span(self.span, device=True):
            return x + self.mixer(self.norm(x))


class DecoderModel(nn.Module):
    """Embeddings, the decoder layers (or Nemotron-H's blocks, where the
    config has a block pattern) and the final RMSNorm: the final-normed
    hidden states ``(B, L, H)`` in the compute dtype."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, _weight=torch.empty(
                cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype))
        block = MixerBlock if cfg.hybrid_override_pattern else DecoderLayer
        self.layers = nn.ModuleList(block(cfg, i)
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
        cos, sin = (None, None) if self.cfg.hybrid_override_pattern \
            else position_tables(self.cfg, L, x.device)
        for layer in self.layers:
            x = layer(x, attention_mask, cos, sin, rows)
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
    ``N(0, std)`` (RMSNorm weights stay 1, biases 0); KDA's published
    inits: ``A_log = log U(1, 16)``, ``dt_bias = softplus^-1(U(1e-3,
    1e-1))``, the short convolutions ``nn.Conv1d``'s ``U(+-size^-0.5)``
    (and their bias, where they have one); Mamba-2's: ``A_log = log(1..h)``,
    ``D = 1``, ``dt_bias = softplus^-1(dt)`` with ``dt = exp U(log 1e-3,
    log 0.1)`` floored at 1e-4.  Skipped on the meta device, where a draw
    costs the import of ``torch._dynamo``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding, MoEGate, Experts)):
                for p in m.parameters(recurse=False):
                    if p.dim() > 1 and not p.is_meta:
                        p.normal_(0.0, std)
            elif isinstance(m, ShortConv) and not m.weight.is_meta:
                bound = m.weight.shape[-1] ** -0.5
                m.weight.uniform_(-bound, bound)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound)
            elif isinstance(m, Mamba2) and not m.A_log.is_meta:
                dt = torch.empty_like(m.dt_bias).uniform_(
                    math.log(1e-3), math.log(0.1)).exp_().clamp_(min=1e-4)
                m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif isinstance(m, KDA) and not m.A_log.is_meta:
                m.A_log.uniform_(1, 16).log_()
                dt = torch.empty_like(m.dt_bias).uniform_(1e-3, 1e-1)
                m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
