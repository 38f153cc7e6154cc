"""The operations of a DHR tower on a DeepSeek-V2-family decoder, computed
from the configuration's widths and the passages' real lengths alone (so a
layer reads the same work whatever implements it, and pads are not work).
"""

from __future__ import annotations

import numpy as np

from benchmarks.gen.weights_decoder import is_moe, model_dims


def _layers(d: dict) -> tuple[int, int]:
    """``(dense layers, MoE layers)``."""
    moe = sum(is_moe(d, i) for i in range(d["layers"]))
    return d["layers"] - moe, moe


def layer_counts(cfg: dict) -> tuple[int, int]:
    """``(dense layers, MoE layers)`` of a configuration file."""
    return _layers(model_dims(cfg))


def expert_flops_per_token(d: dict) -> float:
    """One expert's SwiGLU on one token: three products of H x width."""
    return 2.0 * 3 * d["hidden"] * d["expert_ffn"]


def tower_flops(lengths, d: dict) -> float:
    """Forward FLOPs over passages of ``lengths`` real tokens each (BOS and
    EOS included): per token and layer MLA's four projections, then layer
    0's dense SwiGLU, each MoE layer's gate and its ``k`` routed plus the
    shared experts' SwiGLU; causal attention's two products over each
    passage's ``n (n + 1) / 2`` pairs a head (at ``d_nope + d_rope`` and
    ``d_v``); the LM head and the term weight on positions 1..L-1; the
    pooler.  Element-wise work is not counted."""
    n = np.asarray(lengths, np.float64)
    H, heads = d["hidden"], d["heads"]
    dq, dv, rank = d["d_nope"] + d["d_rope"], d["d_v"], d["kv_rank"]
    dense, moe = _layers(d)
    mla = 2 * (H * heads * dq + H * (rank + d["d_rope"])
               + rank * heads * (d["d_nope"] + dv) + heads * dv * H)
    per_token = (d["layers"] * mla + dense * 2 * 3 * H * d["ffn"]
                 + moe * (2 * H * d["experts"]
                          + (d["top_k"] + d["shared"])
                          * expert_flops_per_token(d)))
    attn = d["layers"] * 2 * heads * (n * (n + 1) / 2) * (dq + dv)
    head = (n - 1) * 2 * (H * d["vocab"] + H)
    total = per_token * n.sum() + attn.sum() + head.sum()
    return float(total + len(n) * 2 * H * d["proj"])


def routed_expert_flops(lengths, d: dict) -> float:
    """The routed experts' FLOPs alone: every MoE layer's ``k`` experts on
    every real token."""
    _, moe = _layers(d)
    return float(moe * np.asarray(lengths, np.float64).sum() * d["top_k"]
                 * expert_flops_per_token(d))
