"""Train steps: plain, token-packed and gradient-cache.

Port of ``dhr_tpu/train/step.py``.  Each step encodes a batch in training
mode, computes the family's listwise loss over the whole batch, backpropagates
and applies one AdamW update (``TrainState.apply_gradients``).  It returns
the loss as a device tensor, so the caller decides when to read it.

Dropout masks are stateless, as the reference's ``fold_in(rng, step)``:
every generator is seeded from ``(seed, step, ...)`` (:func:`generator`), so
a resumed run needs no saved RNG state.  The plain step draws queries then
passages from one generator; the packed step one per tower; the
gradient-cache step one per (side, chunk), seeded again for its second pass
so that the re-encode reuses the first pass's masks.

The gradient-cache step (the classic two-pass scheme) decouples the
contrastive batch from device memory:

1. encode every chunk under ``torch.no_grad``;
2. differentiate the loss with respect to the reps only;
3. re-encode each chunk with gradients and call ``torch.autograd.backward``
   on its reps with the cached rep gradients; the parameter gradients
   accumulate over the chunks, and one chunk's activations live at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dhr_tpu_torch.models.retrievers import BiEncoder, Reps, RetrieverConfig
from dhr_tpu_torch.train import loss as losses
from dhr_tpu_torch.train.state import TrainState

REP_FIELDS = ("dense", "lexical", "semantic", "token", "token_cls")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    n_passages: int = 8
    temperature: float = 1.0
    loss_scale: float = 1.0
    use_tct_teacher: bool = False  # distill from an in-graph ColBERT teacher
    remove_dims: int = 570


def generator(seed: int, step: int, *path: int,
              device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step, *path)``."""
    s = np.random.SeedSequence([seed, step, *path]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(s[0]) << 31 | int(s[1]) >> 1)
    return g


def to_device(batch, device):
    """numpy arrays of a (nested) batch dict -> tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device, non_blocking=True)


def state_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def compute_loss(cfg: RetrieverConfig, loss_cfg: LossConfig, q_reps: Reps,
                 p_reps: Reps, teacher_scores: torch.Tensor | None):
    """Dispatch to the per-family loss; returns ``(loss, scores)``."""
    if cfg.model_type == "dense":
        scores = losses.listwise_ip(q_reps.dense, p_reps.dense)
        loss = losses.kl_onehot(scores, loss_cfg.n_passages)
        return loss * loss_cfg.loss_scale, scores
    if cfg.model_type in ("dhr", "dlr"):
        return losses.dhr_loss(
            q_reps, p_reps, loss_cfg.n_passages,
            dlr_out_dim=cfg.dlr_out_dim, combine_cls=cfg.combine_cls,
            remove_dims=loss_cfg.remove_dims, teacher_scores=teacher_scores,
            temperature=loss_cfg.temperature,
            loss_scale=loss_cfg.loss_scale)
    if cfg.model_type == "agg":
        return losses.agg_loss(
            q_reps, p_reps, loss_cfg.n_passages, agg_dim=cfg.agg_dim,
            semi_aggregate=cfg.semi_aggregate, teacher_scores=teacher_scores,
            temperature=loss_cfg.temperature,
            loss_scale=loss_cfg.loss_scale)
    if cfg.model_type == "colbert":
        return losses.colbert_loss(
            q_reps, p_reps, loss_cfg.n_passages,
            teacher_scores=teacher_scores, temperature=loss_cfg.temperature,
            loss_scale=loss_cfg.loss_scale)
    raise ValueError(cfg.model_type)


def _teacher_scores(batch, loss_cfg, teacher):
    """Data-provided teacher scores, or the in-graph TCT teacher's (no
    gradient) when ``use_tct_teacher`` and a teacher is given."""
    if loss_cfg.use_tct_teacher and teacher is not None:
        with torch.no_grad():
            tq, tp = teacher(query=batch["query"], passage=batch["passage"])
        return losses.colbert_teacher_scores(tq, tp)
    return batch.get("teacher_scores")


def plain_loss(model: BiEncoder, cfg: RetrieverConfig, loss_cfg: LossConfig,
               batch: dict, gen: torch.Generator | None = None,
               teacher: BiEncoder | None = None):
    """The plain step's ``(loss, scores)`` on a device batch (the
    reference's ``loss_fn``)."""
    q_reps, p_reps = model(query=batch["query"], passage=batch["passage"],
                           gen=gen)
    return compute_loss(cfg, loss_cfg, q_reps, p_reps,
                        _teacher_scores(batch, loss_cfg, teacher))


def _no_phase(name: str) -> None:
    pass


def make_train_step(model: BiEncoder, cfg: RetrieverConfig,
                    loss_cfg: LossConfig, teacher: BiEncoder | None = None,
                    on_phase: Callable[[str], None] | None = None
                    ) -> Callable:
    """The plain step: ``train_step(state, batch, seed) -> loss``.
    ``teacher`` is an in-graph ColBERT teacher for TCT distillation.
    ``on_phase(name)`` is called as each part of the step has been queued:
    ``ready`` (batch on the device, gradients cleared), ``forward``,
    ``loss``, ``backward``, ``optimizer`` (a profiler records CUDA events
    there)."""
    if teacher is not None:
        teacher.eval()
    mark = on_phase or _no_phase

    def train_step(state: TrainState, batch: dict, seed: int):
        model.train()
        dev = state_device(model)
        batch = to_device(batch, dev)
        gen = generator(seed, state.step, device=dev)
        state.zero_grad()
        mark("ready")
        q_reps, p_reps = model(query=batch["query"],
                               passage=batch["passage"], gen=gen)
        mark("forward")
        loss, _ = compute_loss(cfg, loss_cfg, q_reps, p_reps,
                               _teacher_scores(batch, loss_cfg, teacher))
        mark("loss")
        loss.backward()
        mark("backward")
        state.apply_gradients()
        mark("optimizer")
        return loss.detach()

    return train_step


def check_packed(cfg: RetrieverConfig, loss_cfg: LossConfig) -> None:
    """The packed step's rejections, by name."""
    if cfg.model_type == "agg" and cfg.skip_mlm:
        raise ValueError(
            "packed training does not support agg skip_mlm (the plain "
            "path's pad-position scatter cannot be reproduced in packed "
            "rows — see RetrieverEncoder.encode_packed)")
    if loss_cfg.use_tct_teacher:
        raise ValueError(
            "packed training does not support the in-graph TCT teacher; "
            "pass teacher scores through the data instead")
    if cfg.model_type in ("dhr", "dlr") and cfg.dlr_out_dim is None:
        raise ValueError("packed training needs dlr_out_dim (GIP variant)")


def packed_loss(model: BiEncoder, cfg: RetrieverConfig, loss_cfg: LossConfig,
                batch: dict, q_gen: torch.Generator | None = None,
                p_gen: torch.Generator | None = None):
    """``(loss, scores)`` of a ``collate_train_packed`` device batch: the
    query tower plain, the passage tower packed, whose per-slot reps
    ``slot_pos`` puts back in the plain flatten order."""
    q_reps, _ = model(query=batch["query"], gen=q_gen)
    pp = batch["packed_passage"]
    teacher_scores = batch.get("teacher_scores")
    kw = dict(teacher_scores=teacher_scores,
              temperature=loss_cfg.temperature,
              loss_scale=loss_cfg.loss_scale)
    if cfg.model_type == "colbert":
        packed_tok = model.encode_tokens_packed(
            pp["input_ids"], pp["segment_ids"], pp["position_ids"], p_gen)
        return losses.colbert_loss_packed(
            q_reps, packed_tok, pp["segment_ids"], pp["position_ids"],
            pp["seg_start"], pp["slot_pos"], loss_cfg.n_passages,
            p_len=pp["input_ids"].shape[1], **kw)
    vals, idxs, semantic = model.encode_passages_packed(
        pp["input_ids"], pp["segment_ids"], pp["position_ids"],
        pp["seg_start"], cfg.dlr_out_dim, loss_cfg.remove_dims, p_gen)
    slot_pos = pp["slot_pos"].long()

    def take(x):
        return x.reshape(-1, *x.shape[2:])[slot_pos]

    if cfg.model_type == "dense":
        scores = losses.listwise_ip(q_reps.dense, take(vals))
        loss = losses.kl_onehot(scores, loss_cfg.n_passages)
        return loss * loss_cfg.loss_scale, scores
    if cfg.model_type in ("dhr", "dlr"):
        return losses.dhr_loss_packed(
            q_reps, take(vals), take(idxs), take(semantic),
            loss_cfg.n_passages, combine_cls=cfg.combine_cls,
            dlr_out_dim=cfg.dlr_out_dim, remove_dims=loss_cfg.remove_dims,
            **kw)
    return losses.agg_loss_packed(
        q_reps, take(vals), take(semantic) if semantic is not None else None,
        loss_cfg.n_passages, agg_dim=cfg.agg_dim,
        semi_aggregate=cfg.semi_aggregate, **kw)


def make_packed_train_step(model: BiEncoder, cfg: RetrieverConfig,
                           loss_cfg: LossConfig) -> Callable:
    """Train step with a token-packed passage tower (batches from
    ``collate_train_packed``): several passages per row, so the pad work of
    every passage shorter than ``p_max_len`` is gone.  Gradients match the
    plain step's up to float near-ties; dropout masks differ by layout.
    Not here: the in-graph TCT teacher, ``dlr_out_dim`` None, agg
    skip-MLM."""
    check_packed(cfg, loss_cfg)

    def train_step(state: TrainState, batch: dict, seed: int):
        model.train()
        dev = state_device(model)
        batch = to_device(batch, dev)
        state.zero_grad()
        loss, _ = packed_loss(model, cfg, loss_cfg, batch,
                              generator(seed, state.step, 0, device=dev),
                              generator(seed, state.step, 1, device=dev))
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    return train_step


# --------------------------------------------------------------------------
# gradient cache
# --------------------------------------------------------------------------


def _chunks(side: dict, n: int) -> list[dict]:
    """``n`` equal chunks of a side's rows; rows that do not split evenly
    are refused (the reference's reshape refuses them too), never
    dropped."""
    rows = side["input_ids"].shape[0]
    if rows % n:
        raise ValueError(f"gradient cache: {rows} rows do not split into "
                         f"{n} equal chunks")
    size = rows // n
    return [{k: v[i * size:(i + 1) * size] for k, v in side.items()}
            for i in range(n)]


def _encode(model, chunk, is_query, gen) -> Reps:
    q, p = model(query=chunk if is_query else None,
                 passage=None if is_query else chunk, gen=gen)
    return q if is_query else p


def _cat_reps(parts: list[Reps]) -> Reps:
    return Reps(**{f: None if getattr(parts[0], f) is None else torch.cat(
        [getattr(r, f) for r in parts]) for f in REP_FIELDS})


def grad_cache_backward(model: BiEncoder, cfg: RetrieverConfig,
                        loss_cfg: LossConfig, batch: dict, seed: int,
                        step: int, q_chunks: int, p_chunks: int,
                        teacher: BiEncoder | None = None):
    """The two passes: accumulate the batch's parameter gradients into
    ``.grad`` chunk by chunk; returns the loss (no gradient)."""
    dev = state_device(model)
    sides = ((0, True, _chunks(batch["query"], q_chunks)),
             (1, False, _chunks(batch["passage"], p_chunks)))
    reps = []
    with torch.no_grad():  # pass 1
        for side, is_query, chunks in sides:
            parts = [_encode(model, c, is_query,
                             generator(seed, step, side, i, device=dev))
                     for i, c in enumerate(chunks)]
            reps.append(_cat_reps(parts))
    for r in reps:
        for f in REP_FIELDS:
            if getattr(r, f) is not None:
                getattr(r, f).requires_grad_(True)
    loss, _ = compute_loss(cfg, loss_cfg, reps[0], reps[1],
                           _teacher_scores(batch, loss_cfg, teacher))
    loss.backward()
    for (side, is_query, chunks), r in zip(sides, reps):  # pass 2
        size = chunks[0]["input_ids"].shape[0]
        for i, c in enumerate(chunks):
            out = _encode(model, c, is_query,
                          generator(seed, step, side, i, device=dev))
            fields = [f for f in REP_FIELDS if getattr(r, f) is not None
                      and getattr(r, f).grad is not None]
            torch.autograd.backward(
                [getattr(out, f) for f in fields],
                [getattr(r, f).grad[i * size:(i + 1) * size]
                 for f in fields])
    return loss.detach()


def make_grad_cache_train_step(model: BiEncoder, cfg: RetrieverConfig,
                               loss_cfg: LossConfig, q_chunks: int = 4,
                               p_chunks: int = 8,
                               teacher: BiEncoder | None = None
                               ) -> Callable:
    """The two-pass gradient-cache step; ``q_chunks`` / ``p_chunks`` split
    the step's query / passage batches.  An in-graph TCT teacher runs once,
    over the whole batch, without gradient."""
    if teacher is not None:
        teacher.eval()

    def train_step(state: TrainState, batch: dict, seed: int):
        model.train()
        batch = to_device(batch, state_device(model))
        state.zero_grad()
        loss = grad_cache_backward(model, cfg, loss_cfg, batch, seed,
                                   state.step, q_chunks, p_chunks, teacher)
        state.apply_gradients()
        return loss

    return train_step
