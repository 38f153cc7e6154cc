"""Gated Inner Product (GIP) scoring: the oracle layer.

Port of ``dhr_tpu/ops/gip.py``.  For a query ``(qv, qi)`` and a passage
``(pv, pi)`` over ``lex`` lexical dims plus an optional CLS tail::

    score = sum_j [qi_j == pi_j] * qv_j * pv_j   (+ always-on CLS tail)

The CLS tail is always on because both index planes are padded with the
constant 1 there.  These are plain tensor functions for training-sized pools,
tests and verification; corpus-scale search goes through
``dhr_tpu_torch.ops.partial_gip`` and ``dhr_tpu_torch.ops.rerank_gip``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_indices_for_cls(indices: torch.Tensor, cls_dim: int) -> torch.Tensor:
    """Pad an index plane with constant 1 over the CLS tail dims."""
    if cls_dim <= 0:
        return indices
    return F.pad(indices, (0, cls_dim), value=1)


def scale_cls_tail(values: torch.Tensor, lex_dim: int,
                   lam: float) -> torch.Tensor:
    """Scale the CLS tail of a value plane by ``lam`` (query side, once)."""
    if values.shape[-1] == lex_dim or lam == 1.0:
        return values
    lex, cls = values[..., :lex_dim], values[..., lex_dim:]
    return torch.cat([lex, cls * lam], dim=-1)


def gip_scores_masked(qv: torch.Tensor, qi: torch.Tensor, pv: torch.Tensor,
                      pi: torch.Tensor, q_chunk: int = 32) -> torch.Tensor:
    """Exact GIP scores ``(B, N)`` via an eq-mask broadcast, chunked over
    queries so at most ``q_chunk * N * d`` mask elements exist at once."""
    pv32 = pv.float()
    out = []
    for s in range(0, qv.shape[0], q_chunk):
        cv, ci = qv[s:s + q_chunk].float(), qi[s:s + q_chunk]
        gate = ci[:, None, :] == pi[None, :, :]
        prod = cv[:, None, :] * pv32[None, :, :]
        out.append(torch.where(gate, prod, 0.0).sum(dim=-1))
    return torch.cat(out, dim=0)


def gip_scores_subindex(qv: torch.Tensor, qi: torch.Tensor, pv: torch.Tensor,
                        pi: torch.Tensor, num_folds: int) -> torch.Tensor:
    """Exact GIP scores ``(B, N)`` as ``num_folds`` masked matmuls:
    ``sum_s (qv*[qi==s]) @ (pv*[pi==s])^T`` (f32, no TF32)."""
    qv32, pv32 = qv.float(), pv.float()
    acc = torch.zeros(qv.shape[0], pv.shape[0], dtype=torch.float32,
                      device=qv.device)
    for s in range(num_folds):
        qm = torch.where(qi == s, qv32, 0.0)
        pm = torch.where(pi == s, pv32, 0.0)
        acc += qm @ pm.T
    return acc


def gip_scores_pairwise(qv: torch.Tensor, qi: torch.Tensor, pv: torch.Tensor,
                        pi: torch.Tensor) -> torch.Tensor:
    """Row-aligned GIP scores ``(B,)`` (rerank / eval path)."""
    prod = qv.float() * pv.float()
    return torch.where(qi == pi, prod, 0.0).sum(dim=-1)


def ip_scores(qv: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """Plain inner-product scores ``(B, N)`` in f32."""
    return qv.float() @ pv.float().T


def threshold_query_values(qv: torch.Tensor, theta: float, lex_dim: int,
                           keep_cls: bool = False) -> torch.Tensor:
    """Zero query dims with value <= theta (the approximate-GIP gate);
    ``keep_cls`` exempts the CLS tail (dims >= ``lex_dim``)."""
    keep = qv > theta
    if keep_cls and qv.shape[-1] > lex_dim:
        dim_ids = torch.arange(qv.shape[-1], device=qv.device)
        keep = keep | (dim_ids >= lex_dim)
    return torch.where(keep, qv, torch.zeros_like(qv))
