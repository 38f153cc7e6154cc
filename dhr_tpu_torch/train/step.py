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

Data parallelism (a train state with ``data_group``, the reference's
``data`` mesh axis): each rank forwards its rows of the global batch (from
``parallel.shard_batch``), the reps (packed: the per-row encoder outputs)
are all-gathered with autograd (:func:`~dhr_tpu_torch.parallel.
collectives.gather_rows`, whose backward hands each rank the gradient of
its own rows), and every rank computes the reference's loss over the
global batch.  ``TrainState.apply_gradients`` then sums the parameter
gradients over the ranks, which gives the one-process gradient of the
global batch.  Dropout masks are drawn at the global shape and sliced
(:class:`~dhr_tpu_torch.models.transformer.RowShard`), so every step
matches one process with dropout on: the gradient-cache step's rank chunks
each take their block of the one-process chunk they lie in (the same
``q_chunks`` / ``p_chunks`` per rank as in one process).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dhr_tpu_torch.models.retrievers import BiEncoder, Reps, RetrieverConfig
from dhr_tpu_torch.models.transformer import RowShard
from dhr_tpu_torch.train import loss as losses
from dhr_tpu_torch.train.state import TrainState
from dhr_tpu_torch.utils.profiling import span

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


def dropout_gen(state: TrainState, seed: int, *path: int,
                device: torch.device | str = "cpu"):
    """The step's dropout generator for ``path``: :func:`generator`, or
    under data parallelism its :class:`RowShard` of the global mask."""
    g = generator(seed, state.step, *path, device=device)
    if state.data_group is None:
        return g
    from dhr_tpu_torch.parallel.collectives import rank_in, size

    return RowShard(g, rank_in(state.data_group), size(state.data_group))


def gather_reps(reps: Reps, group) -> Reps:
    """Every rank's rows of each rep field, with autograd (identity without
    a group)."""
    if group is None:
        return reps
    from dhr_tpu_torch.parallel.collectives import gather_rows

    return Reps(**{f: gather_rows(getattr(reps, f), group)
                   for f in REP_FIELDS})


def gather_global(x, group):
    """Every rank's rows of a batch tensor (no gradient): the global rows
    of an array ``shard_batch`` split (None stays None)."""
    if group is None or x is None:
        return x
    from dhr_tpu_torch.parallel.collectives import all_gather_cat

    return all_gather_cat(x, group, dim=0)


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


def _teacher_scores(batch, loss_cfg, teacher, group=None):
    """Data-provided teacher scores, or the in-graph TCT teacher's (no
    gradient) when ``use_tct_teacher`` and a teacher is given; over the
    global batch under data parallelism (``group``)."""
    if loss_cfg.use_tct_teacher and teacher is not None:
        with torch.no_grad():
            tq, tp = teacher(query=batch["query"], passage=batch["passage"])
            tq, tp = gather_reps(tq, group), gather_reps(tp, group)
        return losses.colbert_teacher_scores(tq, tp)
    return gather_global(batch.get("teacher_scores"), group)


def plain_loss(model: BiEncoder, cfg: RetrieverConfig, loss_cfg: LossConfig,
               batch: dict, gen: torch.Generator | None = None,
               teacher: BiEncoder | None = None):
    """The plain step's ``(loss, scores)`` on a device batch (the
    reference's ``loss_fn``)."""
    q_reps, p_reps = model(query=batch["query"], passage=batch["passage"],
                           gen=gen)
    return compute_loss(cfg, loss_cfg, q_reps, p_reps,
                        _teacher_scores(batch, loss_cfg, teacher))


def make_train_step(model: BiEncoder, cfg: RetrieverConfig,
                    loss_cfg: LossConfig, teacher: BiEncoder | None = None
                    ) -> Callable:
    """The plain step: ``train_step(state, batch, seed) -> loss``.
    ``teacher`` is an in-graph ColBERT teacher for TCT distillation.  Each
    step is a ``train.step`` span over its parts, each a device span of
    the recorder (``utils.profiling``): ``train.prep`` (the batch to the
    device, the dropout generator, the gradients cleared),
    ``train.forward`` (the towers and the reps' gather), ``train.loss``,
    ``train.backward`` and ``train.optimizer``."""
    if teacher is not None:
        teacher.eval()

    def train_step(state: TrainState, batch: dict, seed: int):
        with span("train.step", device=True):
            with span("train.prep", device=True):
                model.train()
                dev = state_device(model)
                batch = to_device(batch, dev)
                group = state.data_group
                gen = dropout_gen(state, seed, device=dev)
                state.zero_grad()
            with span("train.forward", device=True):
                q_reps, p_reps = model(query=batch["query"],
                                       passage=batch["passage"], gen=gen)
                q_reps = gather_reps(q_reps, group)
                p_reps = gather_reps(p_reps, group)
            with span("train.loss", device=True):
                loss, _ = compute_loss(cfg, loss_cfg, q_reps, p_reps,
                                       _teacher_scores(batch, loss_cfg,
                                                       teacher, group))
            with span("train.backward", device=True):
                loss.backward()
            with span("train.optimizer", device=True):
                state.apply_gradients()
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
                p_gen: torch.Generator | None = None, group=None):
    """``(loss, scores)`` of a ``collate_train_packed`` device batch: the
    query tower plain, the passage tower packed, whose per-slot reps
    ``slot_pos`` puts back in the plain flatten order.  Under data
    parallelism (``group``) each rank encodes its packed rows and the loss
    sees every rank's outputs and the global batch arrays."""
    q_reps, _ = model(query=batch["query"], gen=q_gen)
    q_reps = gather_reps(q_reps, group)
    pp = batch["packed_passage"]
    pg = {k: gather_global(v, group) for k, v in pp.items()}
    teacher_scores = gather_global(batch.get("teacher_scores"), group)
    kw = dict(teacher_scores=teacher_scores,
              temperature=loss_cfg.temperature,
              loss_scale=loss_cfg.loss_scale)
    if cfg.model_type == "colbert":
        packed_tok = model.encode_tokens_packed(
            pp["input_ids"], pp["segment_ids"], pp["position_ids"], p_gen)
        return losses.colbert_loss_packed(
            q_reps, gather_rows_of(packed_tok, group), pg["segment_ids"],
            pg["position_ids"], pg["seg_start"], pg["slot_pos"],
            loss_cfg.n_passages, p_len=pp["input_ids"].shape[1], **kw)
    vals, idxs, semantic = model.encode_passages_packed(
        pp["input_ids"], pp["segment_ids"], pp["position_ids"],
        pp["seg_start"], cfg.dlr_out_dim, loss_cfg.remove_dims, p_gen)
    vals, idxs, semantic = (gather_rows_of(x, group)
                            for x in (vals, idxs, semantic))
    slot_pos = pg["slot_pos"].long()

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


def gather_rows_of(x, group):
    """Every rank's rows of a tensor, with autograd where it needs a
    gradient (identity without a group)."""
    if group is None or x is None:
        return x
    from dhr_tpu_torch.parallel.collectives import gather_rows

    return gather_rows(x, group)


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
                              dropout_gen(state, seed, 0, device=dev),
                              dropout_gen(state, seed, 1, device=dev),
                              state.data_group)
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
                        teacher: BiEncoder | None = None, group=None):
    """The two passes: accumulate the batch's parameter gradients into
    ``.grad`` chunk by chunk; returns the loss (no gradient).  Under data
    parallelism (``group``) the chunks split this rank's rows, the loss
    sees every rank's reps, and pass 2 takes the gradient of this rank's
    rows."""
    from dhr_tpu_torch.parallel import collectives

    dev = state_device(model)
    sides = ((0, True, _chunks(batch["query"], q_chunks)),
             (1, False, _chunks(batch["passage"], p_chunks)))

    def chunk_gen(side, i, n_chunks):
        if group is None:
            return generator(seed, step, side, i, device=dev)
        # in row order the ranks' chunks k = rank * n + i split each
        # one-process chunk k // W into W blocks: draw its mask, keep ours
        w = collectives.size(group)
        k = collectives.rank_in(group) * n_chunks + i
        return RowShard(generator(seed, step, side, k // w, device=dev),
                        k % w, w)

    reps = []
    with torch.no_grad():  # pass 1
        for side, is_query, chunks in sides:
            parts = [_encode(model, c, is_query,
                             chunk_gen(side, i, len(chunks)))
                     for i, c in enumerate(chunks)]
            reps.append(gather_reps(_cat_reps(parts), group))
    for r in reps:
        for f in REP_FIELDS:
            if getattr(r, f) is not None:
                getattr(r, f).requires_grad_(True)
    loss, _ = compute_loss(cfg, loss_cfg, reps[0], reps[1],
                           _teacher_scores(batch, loss_cfg, teacher, group))
    loss.backward()
    for (side, is_query, chunks), r in zip(sides, reps):  # pass 2
        size = chunks[0]["input_ids"].shape[0]
        # this rank's rows of the global reps
        base = (0 if group is None
                else collectives.rank_in(group) * size * len(chunks))
        for i, c in enumerate(chunks):
            out = _encode(model, c, is_query,
                          chunk_gen(side, i, len(chunks)))
            fields = [f for f in REP_FIELDS if getattr(r, f) is not None
                      and getattr(r, f).grad is not None]
            lo = base + i * size
            torch.autograd.backward(
                [getattr(out, f) for f in fields],
                [getattr(r, f).grad[lo:lo + size] for f in fields])
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
                                   state.step, q_chunks, p_chunks, teacher,
                                   state.data_group)
        state.apply_gradients()
        return loss

    return train_step
