"""The yardstick's arithmetic: the card's published peaks, and the operations
and bytes of each layer's work, computed from shapes and inputs alone (so a
layer reads the same work whatever implements it).
"""

from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the 700 W limit)
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS_PER_S = 989e12


# -- search: stage 1 and selection ------------------------------------------


def used_dims(qv: np.ndarray, scales: np.ndarray, theta: float,
              max_dims: int) -> list[np.ndarray]:
    """Each query's used dims in the theta pass: of its values above
    ``theta``, scale-folded, the ``max_dims`` largest (ties to the lower
    dim)."""
    q = np.where(qv > theta, qv, 0.0).astype(np.float32) * scales[None, :]
    out = []
    for row in q:
        order = np.argsort(-row, kind="stable")[:max_dims]
        out.append(order[row[order] > 0])
    return out


def candidates_bytes(dims: list[np.ndarray], batch: int, n_rows: int,
                     lex_dim: int, pool: int, value_bytes: int = 1,
                     fold_bytes: int = 1, cand_bytes: int = 2,
                     row_id_bytes: int = 8) -> list[int]:
    """Least bytes of each batch's stage 1 and selection: the value row
    of every distinct used dim and the fold row of every lexical one, over
    all ``n_rows`` rows, each read once; the pool (a candidate score and a
    row id per entry) written once."""
    out = []
    for s in range(0, len(dims), batch):
        part = dims[s:s + batch]
        union = np.unique(np.concatenate(part)) if part else np.zeros(0)
        n_lex = int((union < lex_dim).sum())
        read = n_rows * (len(union) * value_bytes + n_lex * fold_bytes)
        written = len(part) * min(pool, n_rows) * (cand_bytes + row_id_bytes)
        out.append(read + written)
    return out


def rerank_bytes(n_queries: int, batch: int, pool: int, dim: int,
                 lex_dim: int, topk: int) -> list[int]:
    """Least bytes of each batch's exact rerank and final top-k: every
    candidate's row id read, its value row and lexical fold row read once
    (int8), and the top-k scores (f32) and row ids written once."""
    out = []
    for s in range(0, n_queries, batch):
        b = min(batch, n_queries - s)
        out.append(b * pool * (8 + dim + lex_dim) + b * topk * (4 + 8))
    return out


# -- the transformer towers -------------------------------------------------


def tower_flops(lengths, d: dict, lexical_head: bool = True) -> float:
    """Forward FLOPs of a DHR tower over passages of ``lengths`` real tokens
    each ([CLS] and [SEP] included): the layers' projections and FFN per
    token, attention's two products over each passage's own tokens, the
    MLM transform and vocabulary projection and the term weight on
    positions 1..L-1, and the CLS projection.  Element-wise work is not
    counted."""
    n = np.asarray(lengths, np.float64)
    H, F, V, L = d["hidden"], d["ffn"], d["vocab"], d["layers"]
    per_token = 2 * L * (4 * H * H + 2 * H * F)
    attn = 2 * 2 * L * H * n * n
    total = per_token * n.sum() + attn.sum()
    if lexical_head:
        total += (n - 1).sum() * 2 * (H * H + H * V + H)
    total += len(n) * 2 * H * d["proj"]
    return float(total)


def train_step_flops(q_lengths, p_lengths, d: dict) -> float:
    """Three times the forward FLOPs of a train step's real tokens
    (forward, and a backward of twice the forward)."""
    return 3.0 * (tower_flops(q_lengths, d) + tower_flops(p_lengths, d))
