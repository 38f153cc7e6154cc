"""Exact Gated Inner Product over a whole index, by brute force.

For a query ``(qv, qf)`` over ``lex`` lexical dims plus a CLS tail and a
passage ``(pv, pf)``::

    score = sum_{j < lex} [qf_j == pf_j] qv_j pv_j  +  sum_{j >= lex} qv_j pv_j

with ``pv = values_i8 * scales`` (the dequantized int8 plane).  Rows are
scored in blocks, so at most one block of f32 values and one (queries,
block) score slab exist at a time.
"""

from __future__ import annotations

import torch

# the precision a plane block and the query are multiplied in: the
# reference's own (f32), or the control's one step below it (bf16)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def gip_all_rows(qv: torch.Tensor, qf: torch.Tensor, values_i8: torch.Tensor,
                 folds: torch.Tensor, scales: torch.Tensor, lex: int,
                 block_rows: int = 1 << 17, precision: str = "f32"
                 ) -> torch.Tensor:
    """``(Q, N)`` f32 exact GIP scores of every row for ``Q`` queries.

    ``precision="bf16"`` rounds the query, the dequantized plane and each
    product to bf16 and sums in bf16 (the control)."""
    dt = DTYPES[precision]
    Q, N = qv.shape[0], values_i8.shape[0]
    q = qv.float().to(dt)
    out = torch.empty(Q, N, dtype=torch.float32, device=qv.device)
    for s in range(0, N, block_rows):
        e = min(s + block_rows, N)
        pv = (values_i8[s:e].float() * scales[None, :]).to(dt)   # (R, D)
        pf = folds[s:e]
        cls = pv[:, lex:] @ q[:, lex:].T                          # (R, Q)
        for i in range(Q):
            gate = pf == qf[i, :lex].to(pf.dtype)[None, :]
            prod = torch.where(gate, pv[:, :lex] * q[i, :lex][None, :],
                               torch.zeros((), dtype=dt, device=pv.device))
            out[i, s:e] = (prod.sum(dim=1, dtype=dt) + cls[:, i]).float()
    return out


def topk_rows(scores: torch.Tensor, k: int):
    """The exact top-``k`` ``(values, rows)`` of each row of ``scores``,
    descending, ties to the lower row."""
    k = min(k, scores.shape[1])
    # a stable descending sort keeps equal scores in row order
    vals, rows = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], rows[:, :k]
