"""Train state: the step count, the parameters and the optimizer state.

Port of ``dhr_tpu/train/state.py``.  The reference's state is functional
(each update makes new arrays); here the model's parameters and the
optimizer's moments are updated in place, and ``step`` counts the updates
made, on the host.

Under data parallelism (``data_group``, the process group of the ``data``
mesh axes) every rank holds the same state, or its FSDP / TP shards of it
(``parallel.tp``): :meth:`TrainState.apply_gradients` first sums the
gradients the ranks computed for their rows, except those FSDP has
already reduce-scattered, then clips by the global norm.  Under TP the
sum stays over the data ranks: a replicated parameter's gradient is
already the same on every model rank (``copy_to_model`` summed the
activations' gradients in the backward) and a sharded one is its rank's
shard of the whole.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from dhr_tpu_torch.train.optimizer import (
    OptimizerConfig,
    clip_grad_norm,
    linear_warmup_decay,
    make_optimizer,
)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    opt_cfg: OptimizerConfig
    # True while an update is being applied: the optimizer writes the
    # parameters in place, one group at a time, so a state caught
    # mid-update mixes two steps and is no resume point
    updating: bool = False
    data_group: object | None = None  # data-parallel process group

    @classmethod
    def create(cls, model: nn.Module, opt_cfg: OptimizerConfig,
               data_group=None) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=make_optimizer(opt_cfg, model), opt_cfg=opt_cfg,
                   data_group=data_group)

    @property
    def params(self) -> list[torch.nn.Parameter]:
        """The optimized parameters (frozen ones left out)."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at
        ``schedule(step)``, then ``step + 1``."""
        if self.data_group is not None:
            sum_data_parallel_grads(self.params, self.data_group)
        if self.opt_cfg.max_grad_norm:
            clip_grad_norm(self.params, self.opt_cfg.max_grad_norm)
        lr = linear_warmup_decay(self.opt_cfg)(self.step)
        for g in self.optimizer.param_groups:
            g["lr"] = lr
        self.updating = True
        self.optimizer.step()
        self.step += 1
        self.updating = False


def _reduced_by_fsdp(p: torch.Tensor) -> bool:
    """An FSDP-sharded parameter (a DTensor over the ``data`` axis): FSDP
    reduce-scatters its gradient itself."""
    from torch.distributed.tensor import DTensor

    return (isinstance(p, DTensor)
            and "data" in (p.device_mesh.mesh_dim_names or ()))


@torch.no_grad()
def sum_data_parallel_grads(params, group) -> None:
    """SUM every gradient over the data ranks in place (TP shards by their
    local tensors), FSDP's own excepted: one collective per dtype."""
    from torch.distributed.tensor import DTensor

    from dhr_tpu_torch.parallel.collectives import all_reduce_coalesced_

    grads = []
    for p in params:
        if p.grad is None or _reduced_by_fsdp(p):
            continue
        g = p.grad
        grads.append(g.to_local() if isinstance(g, DTensor) else g)
    all_reduce_coalesced_(grads, group)
