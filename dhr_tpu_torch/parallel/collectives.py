"""The collectives of the sharded paths.

Thin wrappers over ``torch.distributed`` that a one-rank group skips:
NCCL on cards of their own, gloo on the CPU and for ranks sharing one
card (NCCL refuses two ranks on one GPU).  gloo takes CUDA tensors in
every collective used here and copies them through the host itself
(``chip_smoke.py``'s parallel path runs each on the card).  The tensors
these carry are small: top-k lists, candidate scores, queries, losses and
gradients; :func:`gather_full` gathers whole sharded parameters and
optimizer moments for a checkpoint, and :func:`copy_to_model` /
:func:`reduce_from_model` carry tensor parallelism's activations and
their gradients (c10d, not DTensor's functional collectives, which crash
under gloo with CUDA tensors on torch 2.11).
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


def _check_placements(t) -> None:
    from torch.distributed.tensor import Replicate, Shard

    for p in t.placements:
        if type(p) not in (Shard, Replicate):
            raise NotImplementedError(
                f"placement {p} of a DTensor: only Shard and Replicate are "
                "gathered here")


def shard_groups(t) -> list:
    """The process groups of the mesh dims over which DTensor ``t`` is
    sharded (its ``Shard`` placements)."""
    from torch.distributed.tensor import Shard

    _check_placements(t)
    return [t.device_mesh.get_group(m) for m, p in enumerate(t.placements)
            if isinstance(p, Shard)]


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a plain tensor as is), gathered with
    c10d all-gathers: ``DTensor.full_tensor``'s functional collectives
    crash under gloo with CUDA tensors (torch 2.11).  Every rank of the
    mesh must call it.

    A ``Shard(d)`` placement is gathered along ``d`` in its mesh dim's
    group, innermost mesh dim first; shards are ``torch.chunk``'s (the
    ceiling, the last ones short or empty), so each is padded to the
    ceiling and the gathered dim trimmed.  ``Replicate`` keeps the local
    tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    _check_placements(t)
    mesh = t.device_mesh
    shape = list(t.shape)
    splits = []  # (mesh dim, tensor dim, size before the split, chunk)
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            size = shape[p.dim]
            chunk = -(-size // mesh.size(m))
            splits.append((m, p.dim, size, chunk))
            shape[p.dim] = max(0, min(chunk, size
                                      - mesh.get_local_rank(m) * chunk))
    x = t.to_local()
    for m, d, size, chunk in reversed(splits):
        if x.shape[d] < chunk:
            pad = list(x.shape)
            pad[d] = chunk - x.shape[d]
            x = torch.cat([x, x.new_zeros(pad)], dim=d)
        x = all_gather_cat(x, mesh.get_group(m), dim=d).narrow(d, 0, size)
    return x


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


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the backward SUMs the
    gradient over the model ranks (each rank's column-parallel layers
    give only their output features' share of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return all_reduce_(grad, group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the forward SUMs the row-parallel partial outputs
    over the model ranks; the backward is the identity (every rank holds
    the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as is, its gradient summed over ``group`` in the backward
    (:class:`_CopyToModel`): the input of a block of column-parallel
    layers."""
    if size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, its gradient passed through
    (:class:`_ReduceFromModel`): the output of a row-parallel layer."""
    if size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)
