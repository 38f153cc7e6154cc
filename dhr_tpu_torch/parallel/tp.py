"""Tensor-parallel (Megatron) and FSDP parameter sharding.

Port of ``dhr_tpu/parallel/tp.py``.  The reference annotates parameter
shardings and lets XLA insert the collectives; here the TP rules make each
planned layer's parameters DTensors (cut locally from the weights every
rank holds) and the layer compute on its local shard, with Megatron's two
conjugate collectives on c10d (``parallel.collectives``): the input of a
block of column-parallel layers passes ``copy_to_model`` once (its
gradient summed over the model ranks in the backward), a row-parallel
output passes ``reduce_from_model`` (summed in the forward).  No DTensor
redistribution runs on the TP path: DTensor's functional collectives crash
under gloo with CUDA tensors (torch 2.11), the backend of ranks sharing
one card.  FSDP is FSDP2 ``fully_shard`` (the parameters live sharded,
each is gathered where it is used and its gradient reduce-scattered).

TP rules over the port's modules, with the reference's (Flax) path each one
matches; a port ``Dense`` weight is ``(out, in)`` where a Flax kernel is
``(in, out)``:

- ``attention.{query,key,value}``: column-parallel, weight ``Shard(0)``
  over heads (Flax ``attention/{query,key,value}/kernel`` ``(H, heads,
  hd)`` sharded on ``heads``), bias ``Shard(0)``;
- ``attention.out``: row-parallel, weight ``Shard(1)`` (Flax
  ``attention/out/kernel`` ``(heads, hd, H)`` on ``heads``), the output
  all-reduced, bias replicated;
- ``ffn_in``: column-parallel, weight ``Shard(0)`` (Flax ``ffn_in/kernel``
  ``(H, I)`` on its columns), bias ``Shard(0)``;
- ``ffn_out``: row-parallel, weight ``Shard(1)`` (Flax ``ffn_out/kernel``
  ``(I, H)`` on its rows), bias replicated;
- everything else (embeddings, layer norms, poolers, the MLM transform):
  replicated.

FSDP rule (:func:`fsdp_param_specs`): a parameter of at least ``min_size``
elements whose first dim divides by the axis size is ``Shard(0)`` over
``data``; every other one stays replicated (a plain tensor whose gradient
the train state sums over the data ranks).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from dhr_tpu_torch.models.transformer import Dense
from dhr_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from dhr_tpu_torch.parallel.mesh import check_device

MODEL_AXIS = "model"

_COLUMN = ("query", "key", "value", "ffn_in")
_ROW = ("out", "ffn_out")


def _tp_style(name: str) -> str | None:
    """'column' / 'row' for a module name of the plan, else None."""
    parts = name.split(".")
    leaf = parts[-1]
    in_attention = len(parts) > 1 and parts[-2] == "attention"
    if leaf in ("query", "key", "value", "out") and not in_attention:
        return None
    if leaf in _COLUMN:
        return "column"
    if leaf in _ROW:
        return "row"
    return None


def tp_param_specs(model: nn.Module, axis: str = MODEL_AXIS) -> dict:
    """``{parameter name: placement}`` over the 1-D ``axis`` mesh (the
    reference's ``PartitionSpec`` tree)."""
    from torch.distributed.tensor import Replicate, Shard

    del axis  # one mesh dim: the placement names no axis
    out = {}
    for name, _ in model.named_parameters():
        mod, _, kind = name.rpartition(".")
        style = _tp_style(mod)
        if style == "column":
            out[name] = Shard(0)
        elif style == "row" and kind == "weight":
            out[name] = Shard(1)
        else:
            out[name] = Replicate()
    return out


class _ColumnParallel(Dense):
    """Megatron's column-parallel layer: this rank's output features (its
    heads, its FFN columns) from its ``Shard(0)`` weight and bias.  The
    block's input passed ``copy_to_model`` before it (one hook a block,
    not one a layer): no collective here."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to_local().to(x.dtype),
                        self.bias.to_local().to(x.dtype))


class _RowParallel(Dense):
    """Megatron's row-parallel layer: this rank's ``Shard(1)`` weight on
    its share of the features, the partial outputs summed over the model
    ranks (``reduce_from_model``), then the replicated bias added once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to_local().to(x.dtype))
        y = reduce_from_model(y, self.weight.device_mesh.get_group())
        return y + self.bias.to_local().to(x.dtype)


def _copy_input(group, module, args):
    """A forward pre-hook: the block's input through ``copy_to_model``."""
    x, *rest = args
    return (copy_to_model(x, group), *rest)


def shard_params_tp(model: nn.Module, mesh, axis: str = MODEL_AXIS
                    ) -> nn.Module:
    """Shard ``model`` in place with the TP rules over the ``axis`` dim of
    ``mesh``; returns it.  Each rank cuts its shards from its own weights,
    so every rank must hold the same ones (the same seed or checkpoint).
    Heads and the FFN width must divide by the axis size."""
    from torch.distributed.tensor import Shard, distribute_tensor

    check_device(next(model.parameters()).device, mesh, "the model")
    sub = mesh[axis] if mesh.ndim > 1 else mesh
    n, group = sub.size(), sub.get_group()
    specs = tp_param_specs(model, axis)
    blocks = {}
    for name, mod in list(model.named_modules()):
        style = _tp_style(name)
        if style is None:
            continue
        for pname, p in list(mod.named_parameters(recurse=False)):
            place = specs[f"{name}.{pname}"]
            if isinstance(place, Shard) and p.shape[place.dim] % n:
                raise ValueError(f"{name}.{pname} {tuple(p.shape)} does not "
                                 f"shard over {n} model ranks")
            mod.register_parameter(pname, nn.Parameter(
                distribute_tensor(p.detach(), sub, [place],
                                  src_data_rank=None),
                requires_grad=p.requires_grad))
        mod.__class__ = _ColumnParallel if style == "column" else _RowParallel
        if style == "column":
            # attention's query / key / value share one input
            parent, _, leaf = name.rpartition(".")
            block = parent if leaf in ("query", "key", "value") else name
            blocks[block] = model.get_submodule(block)
    for block in blocks.values():
        block.register_forward_pre_hook(functools.partial(_copy_input,
                                                          group))
    return model


def fsdp_param_specs(model: nn.Module, axis: str = "data",
                     min_size: int = 2 ** 14) -> dict:
    """``{parameter name: placement}``: ``Shard(0)`` for every parameter of
    at least ``min_size`` elements, replicated below it (norms, biases)."""
    from torch.distributed.tensor import Replicate, Shard

    del axis
    return {n: Shard(0) if p.dim() and math.prod(p.shape) >= min_size
            else Replicate()
            for n, p in model.named_parameters()}


def shard_params_fsdp(model: nn.Module, mesh, axis: str = "data",
                      min_size: int = 2 ** 14) -> nn.Module:
    """Shard ``model`` in place with FSDP2 over the ``axis`` dim of
    ``mesh`` (on a 2-D ``(host, axis)`` mesh: sharded over ``axis``,
    replicated over ``host``, the hybrid recipe); returns it.

    Parameters the rule replicates, and those whose first dim does not
    divide by the axis size, stay plain tensors (FSDP's ``ignored_params``).
    Gradients are SUM-reduced: every rank computes the same global loss of
    the gathered batch, so its gradient is its rows' share of the whole.
    """
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    check_device(next(model.parameters()).device, mesh, "the model")
    names = tuple(mesh.mesh_dim_names)
    n = mesh.size(names.index(axis))
    specs = fsdp_param_specs(model, axis, min_size)
    ignored = {p for name, p in model.named_parameters()
               if not isinstance(specs[name], Shard) or p.shape[0] % n}
    fully_shard(model, mesh=mesh, ignored_params=ignored,
                reshard_after_forward=True)
    # a plain SUM (no pre-multiplied sum: gloo has none)
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)
    # the packed passage tower runs through methods other than forward
    from torch.distributed.fsdp import register_fsdp_forward_method

    for name in ("encode_passages_packed", "encode_tokens_packed"):
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)
    return model

