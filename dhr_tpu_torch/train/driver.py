"""The training driver: loader -> steps -> checkpoints.

Port of ``dhr_tpu/train/driver.py`` for one device (``batch_size`` is the
step's whole batch).  The loop keeps what the reference has: periodic
checkpoints written in the background, resume that restarts in the epoch
where the checkpoint was taken and skips its consumed batches (so the
resumed run sees the uninterrupted run's batch stream), an emergency
checkpoint when a step raises, a final save, metrics JSONL, and an optional
profiler trace (``torch.profiler`` here).

Losses stay on the device and are read once per log interval: a read per
step would make the host wait for every step.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import torch

from dhr_tpu_torch.data import SamplingConfig, TASBSampler, TrainLoader
from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig
from dhr_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_train_state,
    save_train_state,
)
from dhr_tpu_torch.train.optimizer import OptimizerConfig
from dhr_tpu_torch.train.state import TrainState
from dhr_tpu_torch.train.step import (
    LossConfig,
    make_grad_cache_train_step,
    make_packed_train_step,
    make_train_step,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    num_epochs: int = 1
    # total-step cap (HF TrainingArguments.max_steps); None = epoch-bounded
    max_steps: int | None = None
    batch_size: int = 32          # queries per step
    save_steps: int = 20000
    log_steps: int = 100
    ckpt_dir: str | None = None
    resume: bool = True
    seed: int = 42
    grad_cache: bool = False
    gc_q_chunks: int = 4
    gc_p_chunks: int = 8
    profile_dir: str | None = None
    metrics_path: str | None = None  # per-interval metrics JSONL
    # the reference's PRNG choice for its dropout stream on the TPU;
    # accepted for config compatibility, no effect here
    rng_impl: str = "rbg"
    # token-packed passage tower; pack_rows None = auto-size from the
    # first batch.  Not with grad_cache or the in-graph TCT teacher.
    pack_passages: bool = False
    pack_segments: int = 4
    pack_rows: int | None = None


def run_training(
    model_cfg: RetrieverConfig,
    loss_cfg: LossConfig,
    opt_cfg: OptimizerConfig,
    run_cfg: RunConfig,
    groups: list[dict],
    sampling: SamplingConfig,
    corpus=None,
    kd: bool = False,
    tasb_clusters: list[dict] | None = None,
    model: BiEncoder | None = None,
    teacher: BiEncoder | None = None,
    device: str | torch.device | None = None,
) -> TrainState:
    """Train a retriever end to end on ``device`` (default the GPU);
    returns the final state.  ``model`` holds the initial weights (default:
    the seeded random tree of ``run_cfg.seed``)."""
    device = resolve_device(device)
    if run_cfg.grad_cache and (
            run_cfg.batch_size % run_cfg.gc_q_chunks
            or run_cfg.batch_size * sampling.n_passages
            % run_cfg.gc_p_chunks):
        raise ValueError(
            f"grad_cache: batch {run_cfg.batch_size} x {sampling.n_passages} "
            f"passages does not split into {run_cfg.gc_q_chunks} query / "
            f"{run_cfg.gc_p_chunks} passage chunks of equal size")
    if run_cfg.pack_passages and run_cfg.grad_cache:
        raise ValueError("pack_passages does not combine with grad_cache; "
                         "lower pack_rows / batch size instead")
    if run_cfg.pack_passages and teacher is not None:
        raise ValueError(
            "pack_passages does not combine with the in-graph TCT teacher "
            "(it would need its own plain passage batch)")
    loader = TrainLoader(
        groups, sampling, batch_size=run_cfg.batch_size, corpus=corpus,
        kd=kd,
        tasb=TASBSampler(tasb_clusters, seed=sampling.seed)
        if tasb_clusters else None,
        pack_passages=run_cfg.pack_passages,
        pack_segments=run_cfg.pack_segments, pack_rows=run_cfg.pack_rows)
    if model is None:
        from dhr_tpu_torch.models.flax_params import (
            load_flax_params,
            random_flax_params,
        )

        model = load_flax_params(BiEncoder(model_cfg), random_flax_params(
            model_cfg, torch.Generator().manual_seed(run_cfg.seed)))
    model.to(device)
    if teacher is not None:
        teacher.to(device)
    state = TrainState.create(model, opt_cfg)
    if run_cfg.resume and run_cfg.ckpt_dir and latest_step(run_cfg.ckpt_dir):
        restore_train_state(run_cfg.ckpt_dir, state)
        logger.info("resumed from step %d", state.step)

    if run_cfg.grad_cache:
        step_fn = make_grad_cache_train_step(
            model, model_cfg, loss_cfg, q_chunks=run_cfg.gc_q_chunks,
            p_chunks=run_cfg.gc_p_chunks, teacher=teacher)
    elif run_cfg.pack_passages:
        step_fn = make_packed_train_step(model, model_cfg, loss_cfg)
    else:
        step_fn = make_train_step(model, model_cfg, loss_cfg, teacher=teacher)

    start_step = state.step
    loader.global_step = start_step
    losses: list[torch.Tensor] = []
    metrics_f = open(run_cfg.metrics_path, "a") if run_cfg.metrics_path \
        else None
    run_t0 = t0 = time.time()

    def log_interval(epoch):
        nonlocal t0
        vals = torch.stack(losses).float().cpu().tolist()  # the one read
        rate = len(vals) / max(time.time() - t0, 1e-9)
        loss_mean = sum(vals) / len(vals)
        logger.info("step %d loss %.4f (%.2f steps/s)", state.step,
                    loss_mean, rate)
        if metrics_f is not None:
            metrics_f.write(json.dumps({
                "step": state.step, "epoch": epoch, "loss": loss_mean,
                "steps_per_sec": round(rate, 4),
                "wall_s": round(time.time() - run_t0, 3),
            }) + "\n")
            metrics_f.flush()
        losses.clear()
        t0 = time.time()

    profiler = None
    if run_cfg.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        os.makedirs(run_cfg.profile_dir, exist_ok=True)
        profiler = profile(activities=acts)
        profiler.start()
    ckptr = AsyncCheckpointer()
    spe = loader.steps_per_epoch()
    start_epoch = min(start_step // spe, run_cfg.num_epochs) if spe else 0
    done = False
    try:
        for epoch in range(start_epoch, run_cfg.num_epochs):
            if done:
                break
            skip = max(start_step - epoch * spe, 0) \
                if epoch == start_epoch else 0
            for batch in loader.epoch(epoch, skip=skip):
                if run_cfg.max_steps and state.step >= run_cfg.max_steps:
                    done = True
                    break
                losses.append(step_fn(state, batch, run_cfg.seed))
                if state.step % run_cfg.log_steps == 0:
                    log_interval(epoch)
                if run_cfg.ckpt_dir and state.step % run_cfg.save_steps == 0:
                    # the previous write's transient IO error must not
                    # abort training: the final save is the authoritative
                    # one (the emergency and final paths still raise)
                    try:
                        ckptr.save(run_cfg.ckpt_dir, state)
                    except Exception:  # noqa: BLE001
                        logger.exception("previous async checkpoint "
                                         "failed; training continues")
                        ckptr.save(run_cfg.ckpt_dir, state)
        if losses:
            log_interval(run_cfg.num_epochs - 1)
    except Exception:
        # persist the last good state so the run restarts where it died;
        # a step that failed inside its update left the parameters half
        # updated, so the last periodic save stays the resume point
        if run_cfg.ckpt_dir:
            try:
                try:
                    ckptr.wait()
                except Exception:  # noqa: BLE001
                    logger.exception("in-flight checkpoint failed")
                if state.updating:
                    logger.error("training failed inside the update of "
                                 "step %d; no emergency checkpoint",
                                 state.step)
                else:
                    path = save_train_state(run_cfg.ckpt_dir, state)
                    logger.error("training failed; emergency checkpoint "
                                 "at %s", path)
            except Exception:  # noqa: BLE001 - keep the original error
                logger.exception("emergency checkpoint also failed")
        raise
    finally:
        if profiler is not None:
            profiler.stop()
            profiler.export_chrome_trace(
                os.path.join(run_cfg.profile_dir, "trace.json"))
        if metrics_f is not None:
            metrics_f.close()
    try:
        ckptr.wait()
    except Exception:  # noqa: BLE001 - the final save below still runs
        logger.exception("in-flight async checkpoint failed; final "
                         "synchronous save still runs")
    if run_cfg.ckpt_dir:
        save_train_state(run_cfg.ckpt_dir, state)
    return state
