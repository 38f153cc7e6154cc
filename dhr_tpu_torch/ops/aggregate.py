"""Aggretriever aggregation: fold a vocabulary-space vector to a fixed dim.

Port of ``dhr_tpu/ops/aggregate.py``.  Two modes:

- ``full``: fold the vocabulary into ``(k, 2*dim)`` (trimming the front,
  or zero-padding the tail, so it divides evenly), max-pool over folds,
  then a sign competition between the interleaved halves: each output lane
  keeps ``pos`` (even lane) if ``pos > neg`` (odd lane), else ``-neg``;
- ``semi``: a plain fold-max to ``(k, dim)``.

Trim rule: ``r = vocab % width``; if ``r > 1000`` the fold is instead padded
with ``width - r`` zeros at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cal_remove_dim(dims: int, vocab_size: int = 30522) -> int:
    """Leading dims to trim (or, if negative, trailing zeros to pad)."""
    remove_dims = vocab_size % dims
    if remove_dims > 1000:
        remove_dims -= dims
    return remove_dims


def _fold_max(x: torch.Tensor, width: int) -> torch.Tensor:
    remove_dims = cal_remove_dim(width, x.shape[-1])
    x = x[..., remove_dims:] if remove_dims >= 0 else F.pad(
        x, (0, -remove_dims))
    return x.reshape(*x.shape[:-1], -1, width).amax(dim=-2)


def aggregate(lexical_reps: torch.Tensor, dim: int = 640,
              full: bool = True) -> torch.Tensor:
    """Aggregate ``(..., vocab)`` lexical vectors to ``(..., dim)``."""
    if not full:
        return _fold_max(lexical_reps, dim)
    tok = _fold_max(lexical_reps, 2 * dim)
    pos, neg = tok[..., 0::2], tok[..., 1::2]
    return torch.where(pos > neg, pos, -neg)


def merge_reps(lexical_reps: torch.Tensor,
               semantic_reps: torch.Tensor) -> torch.Tensor:
    """Concatenate aggregated lexical and semantic planes into one vector."""
    return torch.cat([lexical_reps, semantic_reps.to(lexical_reps.dtype)],
                     dim=-1)
