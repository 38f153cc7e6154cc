"""The work of a DHR tower on a Kimi Linear decoder and of its KDA scans,
computed from the configuration's widths and the documents' real lengths
alone (so a layer reads the same work whatever implements it, and pads are
not work).

KDA's scan (one layer, ``h`` heads of ``d_k = d_v = d``), for a document of
``n`` real tokens in chunks of :data:`CHUNK` (the last one ``n mod 64``
long), per chunk of ``c`` tokens and head:

- FLOPs, the chunked algorithm's: the key-key and query-key products
  ``2 c^2 d_k`` each; the unit-triangular solve for ``[v | k]`` ``c^2 (d_v
  + d_k)``; the query's correction and the intra-chunk output ``2 c^2 d_k``
  and ``2 c^2 d_v``; from the chunk's entering state the delta, the output
  and the state's update ``2 c d_k d_v`` each.  Element-wise work (decays,
  masks, norms) is not counted;
- bytes: one read of ``q``, ``k``, ``v`` (compute dtype, 2 B), of ``g`` (f32,
  ``d_k`` a head) and ``beta`` (f32, one a head), and one write of ``o``
  (compute dtype), per real token.
"""

from __future__ import annotations

import numpy as np

from benchmarks.gen.weights_kimi import is_kda, is_moe, model_dims

CHUNK = 64


def layer_counts(cfg: dict) -> dict:
    """``{"kda", "mla", "dense", "moe"}`` layer counts of a configuration
    file."""
    d = model_dims(cfg)
    kda = sum(is_kda(d, i) for i in range(d["layers"]))
    moe = sum(is_moe(d, i) for i in range(d["layers"]))
    return {"kda": kda, "mla": d["layers"] - kda, "moe": moe,
            "dense": d["layers"] - moe}


def _chunks(lengths):
    """Each document's chunk lengths, flattened."""
    n = np.asarray(lengths, np.int64)
    full, rest = n // CHUNK, n % CHUNK
    return np.concatenate([np.repeat(float(CHUNK), int(full.sum())),
                           rest[rest > 0].astype(np.float64)])


def scan_flops(lengths, d: dict) -> float:
    """One KDA layer's scan FLOPs over documents of ``lengths`` tokens."""
    c = _chunks(lengths)
    k = v = d["kda_dim"]
    per_head = (c * c * (2 * k + 2 * k + (v + k) + 2 * k + 2 * v)
                + 3 * 2 * c * k * v)
    return float(d["kda_heads"] * per_head.sum())


def scan_bytes(lengths, d: dict) -> float:
    """One KDA layer's scan bytes over documents of ``lengths`` tokens."""
    h, k = d["kda_heads"], d["kda_dim"]
    per_token = h * (2 * k + 2 * k + 2 * k + 4 * k + 4 + 2 * k)
    return float(per_token * np.asarray(lengths, np.float64).sum())


def tower_flops(lengths, d: dict) -> float:
    """Forward FLOPs over documents of ``lengths`` real tokens each (BOS and
    EOS included): per token and layer KDA's projections (q, k, v, the
    decay's and the output gate's low-rank pairs, beta, o) and short
    convolutions, or MLA's four; layer 1's dense SwiGLU; each MoE layer's
    router over all experts, the held share of its ``k`` routed experts'
    SwiGLU (``k E_held / E``: uniform routing) and the shared expert's;
    KDA's scan (:func:`scan_flops`); causal attention's two products over
    each document's ``n (n + 1) / 2`` pairs a head on the MLA layers; the
    LM head and the term weight on positions 1..L-1; the pooler.
    Element-wise work is not counted."""
    n = np.asarray(lengths, np.float64)
    H, heads = d["hidden"], d["heads"]
    h, k = d["kda_heads"], d["kda_dim"]
    D = h * k
    dq, dv, rank = d["d_nope"] + d["d_rope"], d["d_v"], d["kv_rank"]
    kda = sum(is_kda(d, i) for i in range(d["layers"]))
    moe = sum(is_moe(d, i) for i in range(d["layers"]))
    mla_n = d["layers"] - kda
    kda_proj = 2 * (3 * H * D + 3 * D * d["conv"] + 2 * (H * k + k * D)
                    + H * h + D * H)
    mla_proj = 2 * (H * heads * dq + H * (rank + d["d_rope"])
                    + rank * heads * (d["d_nope"] + dv) + heads * dv * H)
    expert = 2.0 * 3 * H * d["expert_ffn"]
    held = (d["held"][1] - d["held"][0]) / d["experts"]
    per_token = (kda * kda_proj + mla_n * mla_proj
                 + (d["layers"] - moe) * 2 * 3 * H * d["ffn"]
                 + moe * (2 * H * d["experts"]
                          + (d["top_k"] * held + d["shared"]) * expert))
    attn = mla_n * 2 * heads * (n * (n + 1) / 2) * (dq + dv)
    head = (n - 1) * 2 * (H * d["vocab"] + H)
    total = (per_token * n.sum() + attn.sum() + head.sum()
             + kda * scan_flops(lengths, d))
    return float(total + len(n) * 2 * H * d["proj"])
