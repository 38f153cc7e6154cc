"""AdamW with the reference's schedule and parameter masks.

Port of ``dhr_tpu/train/optimizer.py`` (optax there):

- the learning rate warms up linearly to ``learning_rate`` over
  ``max(warmup_steps, 1)`` updates, then decays linearly to 0 at
  ``total_steps``; update t (t = updates before it) uses ``schedule(t)``,
  so with warmup > 0 the first update has lr 0;
- weight decay applies to every parameter except those whose reference
  (Flax) path contains ``layer_norm``, ``bias`` or ``scale``
  (:func:`decay_mask`);
- ``freeze_word_embeddings`` is optax's ``set_to_zero``: a frozen word
  embedding table (also the tied MLM decoder) gets no update, no decay and
  no Adam moments, so it is left out of every parameter group and out of
  the gradient computation (:func:`make_optimizer`);
- ``max_grad_norm`` clips the global norm of the optimized parameters'
  gradients before Adam (:func:`clip_grad_norm`).

The update is ``torch.optim.AdamW``'s: it scales the parameter by ``1 - lr
* wd`` and then subtracts ``lr * m_hat / (sqrt(v_hat) + eps)``, where optax
adds ``wd * p`` to the Adam direction before the lr scale.  Both give ``p -
lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` from the same ``p``; they
differ in rounding only.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 5e-6
    warmup_steps: int = 0
    total_steps: int = 100_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float | None = None
    freeze_word_embeddings: bool = False


def linear_warmup_decay(cfg: OptimizerConfig):
    """``t -> lr`` of optax's joined linear warmup and linear decay."""
    warmup = max(cfg.warmup_steps, 1)
    decay = max(cfg.total_steps - cfg.warmup_steps, 1)
    lr = cfg.learning_rate

    def schedule(t: int) -> float:
        if t < cfg.warmup_steps:
            return lr * min(t, warmup) / warmup
        return lr * (1.0 - min(t - cfg.warmup_steps, decay) / decay)

    return schedule


def flax_path(name: str) -> str:
    """The reference (Flax) path of a port parameter name: LayerNorm and
    embedding ``weight`` are ``scale`` and ``embedding`` there, linear
    ``weight`` is ``kernel``, ``layers.<i>`` is ``layers_<i>``."""
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
            continue
        out.append(parts[i])
        i += 1
    if out[-1] == "weight":
        parent = out[-2] if len(out) > 1 else ""
        if parent in ("word", "position", "token_type"):
            out[-1] = "embedding"
        elif "layer_norm" in parent:
            out[-1] = "scale"
        else:
            out[-1] = "kernel"
    return "/".join(out)


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """True where weight decay applies: every parameter whose Flax path
    has none of ``layer_norm``, ``bias``, ``scale``."""
    return {n: not any(k in flax_path(n) for k in ("layer_norm", "bias",
                                                    "scale"))
            for n, _ in model.named_parameters()}


def frozen_word_embedding_mask(model: nn.Module) -> dict[str, bool]:
    """True for the word-embedding tables (the reference matches ``word``
    in the Flax path)."""
    return {n: "word" in flax_path(n) for n, _ in model.named_parameters()}


def make_optimizer(cfg: OptimizerConfig,
                   model: nn.Module) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters: a decayed and an undecayed group;
    frozen word embeddings (``freeze_word_embeddings``) are in neither
    group and stop requiring gradients.  The caller sets each group's
    ``lr`` from :func:`linear_warmup_decay` before every update."""
    from torch.distributed.tensor import DTensor

    decay = decay_mask(model)
    frozen = (frozen_word_embedding_mask(model) if cfg.freeze_word_embeddings
              else dict.fromkeys(decay, False))
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if frozen[name]:
            p.requires_grad_(False)
        else:
            groups[decay[name]].append(p)
    # FSDP leaves small and indivisible parameters plain beside its DTensor
    # shards; the multi-tensor (foreach) update refuses a group that mixes
    # the two (torch 2.11 on the card), so such a model updates tensor by
    # tensor
    kinds = {isinstance(p, DTensor) for g in groups.values() for p in g}
    return torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": cfg.weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
        foreach=False if len(kinds) > 1 else None)


def _grad_norm(g: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a whole gradient: a sharded (DTensor) one's squared
    local norm is summed over its shard groups (c10d all-reduces; a
    replicated mesh dim adds nothing), not this rank's alone."""
    from torch.distributed.tensor import DTensor

    from dhr_tpu_torch.parallel.collectives import all_reduce_, shard_groups

    if not isinstance(g, DTensor):
        return torch.linalg.vector_norm(g.float())
    sq = g.to_local().float().square().sum()
    for group in shard_groups(g):
        all_reduce_(sq, group=group)
    return sq.sqrt()


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale every gradient by ``max_norm /
    norm`` when the global norm reaches ``max_norm``; no host sync.
    Sharded gradients count whole.  Returns the norm."""
    from torch.distributed.tensor import DTensor

    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([_grad_norm(g)
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_([g.to_local() if isinstance(g, DTensor) else g
                         for g in grads], scale)
    return norm
