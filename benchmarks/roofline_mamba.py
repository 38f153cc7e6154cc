"""The work of a DHR tower on a Nemotron-H decoder and of its Mamba-2 SSD
scans, computed from the configuration's widths and the documents' real
lengths alone (so a layer reads the same work whatever implements it, and
pads are not work).

The SSD scan (one Mamba-2 mixer, ``h`` heads of ``P``, ``g`` groups of
state ``N``), for a document of ``n`` real tokens in chunks of the
configuration's ``chunk_size`` (the last one ``n mod chunk`` long), per
chunk of ``c`` tokens:

- FLOPs, the chunked algorithm's: ``C B^T`` once a group, ``2 c^2 N``;
  the masked product with ``dt x`` a head, ``2 c^2 P``; the chunk's state
  ``B^T (dt x)`` and the entering state's output ``C S`` a head, ``2 c N
  P`` each.  Element-wise work (decays, masks, the skip) and the passing
  of states between chunks are not counted;
- bytes: one read of ``x``, ``B`` and ``C`` (compute dtype, 2 B) and of
  ``dt`` (f32, one a head), and one write of ``y`` (compute dtype), per
  real token.
"""

from __future__ import annotations

import numpy as np

from benchmarks.gen.weights_nemotron import kind, model_dims


def layer_counts(cfg: dict) -> dict:
    """``{"mamba", "attention", "moe"}`` block counts of a configuration
    file."""
    return _counts(model_dims(cfg))


def _counts(d: dict) -> dict:
    kinds = [kind(d, i) for i in range(d["layers"])]
    return {"mamba": kinds.count("M"), "attention": kinds.count("*"),
            "moe": kinds.count("E")}


def _chunks(lengths, chunk: int):
    """Each document's chunk lengths, flattened."""
    n = np.asarray(lengths, np.int64)
    full, rest = n // chunk, n % chunk
    return np.concatenate([np.repeat(float(chunk), int(full.sum())),
                           rest[rest > 0].astype(np.float64)])


def scan_flops(lengths, d: dict) -> float:
    """One Mamba-2 mixer's scan FLOPs over documents of ``lengths``
    tokens."""
    c = _chunks(lengths, d["chunk"])
    h, P, g, N = d["mamba_heads"], d["mamba_dim"], d["groups"], d["state"]
    per_chunk = g * 2 * c * c * N + h * (2 * c * c * P + 2 * 2 * c * N * P)
    return float(per_chunk.sum())


def scan_bytes(lengths, d: dict) -> float:
    """One Mamba-2 mixer's scan bytes over documents of ``lengths``
    tokens."""
    h, P, g, N = d["mamba_heads"], d["mamba_dim"], d["groups"], d["state"]
    per_token = 2 * h * P + 2 * 2 * g * N + 4 * h + 2 * h * P
    return float(per_token * np.asarray(lengths, np.float64).sum())


def tower_flops(lengths, d: dict) -> float:
    """Forward FLOPs over documents of ``lengths`` real tokens each (BOS and
    EOS included): per token and block Mamba-2's ``in_proj``, depthwise
    convolution and ``out_proj``, or attention's four projections, or the
    router over all experts, the ``k`` routed relu^2 experts' two products
    and the shared expert's; the SSD scans (:func:`scan_flops`); causal
    attention's two products over each document's ``n (n + 1) / 2`` pairs
    a query head; the LM head and the term weight on positions 1..L-1; the
    pooler.  Element-wise work is not counted."""
    n = np.asarray(lengths, np.float64)
    H, heads, kv, hd = d["hidden"], d["heads"], d["kv_heads"], d["head_dim"]
    h, g, N = d["mamba_heads"], d["groups"], d["state"]
    D = h * d["mamba_dim"]
    conv = D + 2 * g * N
    mamba, attn_n, moe = _counts(d).values()
    mamba_proj = 2 * (H * (D + conv + h) + conv * d["conv"] + D * H)
    attn_proj = 2 * (H * (heads + 2 * kv) * hd + heads * hd * H)
    moe_tok = 2 * (H * d["experts"]
                   + 2 * H * (d["top_k"] * d["expert_ffn"]
                              + d["shared"] * d["shared_ffn"]))
    per_token = mamba * mamba_proj + attn_n * attn_proj + moe * moe_tok
    attn = attn_n * 2 * heads * (n * (n + 1) / 2) * (hd + hd)
    head = (n - 1) * 2 * (H * d["vocab"] + H)
    total = (per_token * n.sum() + attn.sum() + head.sum()
             + mamba * scan_flops(lengths, d))
    return float(total + len(n) * 2 * H * d["proj"])
