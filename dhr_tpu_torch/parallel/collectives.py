"""The collectives of the sharded paths.

Thin wrappers over ``torch.distributed`` that a one-rank group skips:
NCCL on cards of their own, gloo on the CPU and for ranks sharing one
card (NCCL refuses two ranks on one GPU).  gloo takes CUDA tensors in
every collective used here and copies them through the host itself
(``chip_smoke.py``'s parallel path runs each on the card).  The tensors
these carry are small: top-k lists, candidate scores, queries, losses and
gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group=None) -> int:
    return dist.get_world_size(group)


def rank_in(group=None) -> int:
    return dist.get_rank(group)


def all_gather_cat(t: torch.Tensor, group=None, dim: int = -1
                   ) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    group-rank order (a tiled all-gather)."""
    n = size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
                ) -> torch.Tensor:
    """Reduce ``t`` over the group in place; returns ``t``."""
    if size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_coalesced_(tensors: list[torch.Tensor], group=None) -> None:
    """SUM-reduce a list of tensors in place through one flat buffer per
    dtype (one collective each, not one per tensor)."""
    if size(group) == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group=group)
        o = 0
        for t in ts:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every rank (pickled)."""
    if size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_true(flag: bool, group=None) -> bool:
    """True when ``flag`` holds on every rank of the group."""
    if size(group) == 1:
        return flag
    flags = [None] * size(group)
    dist.all_gather_object(flags, bool(flag), group=group)
    return all(flags)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward hands each rank the gradient
    of its own rows.  Every rank computes the same loss of the gathered
    rows, so a rank's rows get the whole gradient from its own copy: no
    reduction here (the parameter gradients are summed over the ranks
    after the backward)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rows, ctx.index = t.shape[0], rank_in(group)
        return all_gather_cat(t, group, dim=0)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.index * ctx.rows
        return grad[s:s + ctx.rows], None


def gather_rows(t: torch.Tensor | None, group=None):
    """Every rank's rows of ``t`` in rank order, with gradients flowing
    back to this rank's rows (:class:`_GatherRows`); None stays None."""
    if t is None or size(group) == 1:
        return t
    if t.requires_grad:
        return _GatherRows.apply(t, group)
    return all_gather_cat(t, group, dim=0)
