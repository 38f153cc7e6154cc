"""Training: losses, AdamW, train state, steps, checkpoints, driver."""

from dhr_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from dhr_tpu_torch.train.state import TrainState
from dhr_tpu_torch.train.step import (
    LossConfig,
    compute_loss,
    make_grad_cache_train_step,
    make_packed_train_step,
    make_train_step,
)

__all__ = [
    "LossConfig", "OptimizerConfig", "TrainState", "compute_loss",
    "make_grad_cache_train_step", "make_optimizer", "make_packed_train_step",
    "make_train_step",
]
