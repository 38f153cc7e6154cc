"""Train state: the step count, the parameters and the optimizer state.

Port of ``dhr_tpu/train/state.py``.  The reference's state is functional
(each update makes new arrays); here the model's parameters and the
optimizer's moments are updated in place, and ``step`` counts the updates
made, on the host.
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

    @classmethod
    def create(cls, model: nn.Module, opt_cfg: OptimizerConfig
               ) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=make_optimizer(opt_cfg, model), opt_cfg=opt_cfg)

    @property
    def params(self) -> list[torch.nn.Parameter]:
        """The optimized parameters (frozen ones left out)."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at
        ``schedule(step)``, then ``step + 1``."""
        if self.opt_cfg.max_grad_norm:
            clip_grad_norm(self.params, self.opt_cfg.max_grad_norm)
        lr = linear_warmup_decay(self.opt_cfg)(self.step)
        for g in self.optimizer.param_groups:
            g["lr"] = lr
        self.updating = True
        self.optimizer.step()
        self.step += 1
        self.updating = False
