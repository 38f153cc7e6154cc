"""Top-k utilities: blockwise top-k and the merge of pre-selected lists.

Port of ``dhr_tpu/ops/topk.py``.  Both are exact and return values in
descending order with indices into the original last axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def blockwise_topk(scores: torch.Tensor, k: int, block: int = 16384
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``(..., N)`` scores via per-block top-k, then a merge."""
    n = scores.shape[-1]
    if n <= block or n <= k:
        return torch.topk(scores, min(k, n), dim=-1)
    n_blocks = -(-n // block)
    pad = n_blocks * block - n
    if pad:
        scores = F.pad(scores, (0, pad), value=float("-inf"))
    blocked = scores.reshape(*scores.shape[:-1], n_blocks, block)
    kb = min(k, block)
    vals, idx = torch.topk(blocked, kb, dim=-1)
    offsets = (torch.arange(n_blocks, device=scores.device) * block)[:, None]
    idx = (idx + offsets).reshape(*idx.shape[:-2], n_blocks * kb)
    vals = vals.reshape(*vals.shape[:-2], n_blocks * kb)
    return merge_topk(vals, idx, k)


def merge_topk(values: torch.Tensor, indices: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge pre-selected ``(..., M)`` (value, index) lists to the top-k."""
    vals, pos = torch.topk(values, k, dim=-1)
    return vals, torch.gather(indices, -1, pos)
