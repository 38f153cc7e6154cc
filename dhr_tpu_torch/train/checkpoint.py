"""Checkpoints of the train state, and the HF export.

Port of ``dhr_tpu/train/checkpoint.py``.  The train state (step, parameters,
optimizer state) is saved with ``torch.save`` under ``ckpt_dir/step_<n>``
(eight digits, as the reference names its directories) and restored from
the latest one.  Orbax checkpoints of the reference do not load here: the
format the two packages exchange is the HF export
(:func:`export_hf_checkpoint`, the reference's layout: ``save_pretrained``
files, ``query_model`` / ``passage_model`` when untied, and the pooler /
TermWeightTrans sidecars).

A sharded state (data-parallel ranks, FSDP or TP DTensors) is saved as
the full state in the same format: every rank takes part in gathering each
sharded tensor, rank 0 alone writes, so the checkpoint restores on any
number of ranks, one included; the restore loads the full state on every
rank and re-shards each tensor into the template's placement.

The reference's state is functional, so its background save may read the
live arrays.  Here the step updates parameters and moments in place, so
:meth:`AsyncCheckpointer.save` copies them to the host before it returns
(before the next step runs); only the write runs in the background.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from dhr_tpu_torch.parallel.collectives import gather_full
from dhr_tpu_torch.parallel.mesh import is_rank0
from dhr_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def _state_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _to_host(tree, keep: bool = True):
    """A copy of a (nested) state dict with every tensor whole on the CPU:
    a DTensor is gathered first by c10d (``parallel.collectives.
    gather_full``; every rank must call this).  ``keep`` False (a rank that
    does not write) takes part in the gathers and keeps nothing."""
    if isinstance(tree, torch.Tensor):
        tree = gather_full(tree)
        return tree.detach().to("cpu", copy=True) if keep else None
    if isinstance(tree, dict):
        return {k: _to_host(v, keep) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, keep) for v in tree)
    return tree


def snapshot(state: TrainState) -> dict:
    """The state's step, parameters and optimizer state, whole and copied
    to the host (on rank 0; the other ranks only help gather shards)."""
    keep = is_rank0()
    return {"step": state.step,
            "model": _to_host(state.model.state_dict(), keep),
            "optimizer": _to_host(state.optimizer.state_dict(), keep)}


def write_snapshot(ckpt_dir: str, snap: dict) -> str:
    """Write a :func:`snapshot` to ``step_<n>`` (through a ``.tmp``
    directory, renamed when complete); returns the path."""
    path = _state_dir(ckpt_dir, snap["step"])
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(snap, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)  # the final save may repeat one
    os.replace(tmp, path)
    return path


def save_train_state(ckpt_dir: str, state: TrainState) -> str:
    """Save the state under ``ckpt_dir/step_XXXXXXXX`` (rank 0 writes);
    returns the path."""
    snap = snapshot(state)
    if is_rank0():
        return write_snapshot(ckpt_dir, snap)
    return _state_dir(ckpt_dir, snap["step"])


class AsyncCheckpointer:
    """Mid-run saves whose write runs on a background thread.

    :meth:`save` copies the state to the host first (the next step updates
    the live tensors in place), then hands the copy to a thread.  At most
    one write is in flight: a new save waits for the previous one and
    raises its error.  Call :meth:`wait` before reading checkpoints or
    exiting.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._path: str | None = None
        self._error: BaseException | None = None

    def save(self, ckpt_dir: str, state: TrainState) -> None:
        self.wait()  # raises (and clears) any previous write's error
        snap = snapshot(state)
        if not is_rank0():
            return

        def run():
            try:
                self._path = write_snapshot(ckpt_dir, snap)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> str | None:
        """Join the write in flight; returns its path (or raises its
        error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, state: TrainState,
                        step: int | None = None) -> TrainState:
    """Load ``step`` (default the latest) into ``state`` in place; returns
    it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    snap = torch.load(os.path.join(_state_dir(ckpt_dir, step), STATE_FILE),
                      map_location="cpu", weights_only=True)
    _load_model(state.model, snap["model"])
    state.optimizer.load_state_dict(_reshard_optimizer(state.optimizer,
                                                       snap["optimizer"]))
    state.step = int(snap["step"])
    return state


def _like(full: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``template``: this rank's shard of it when the
    template is a DTensor (cut locally, no collective), else itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(template, DTensor):
        return full
    return distribute_tensor(
        full.to(template.device_mesh.device_type), template.device_mesh,
        template.placements, src_data_rank=None)


@torch.no_grad()
def _load_model(model: torch.nn.Module, full: dict) -> None:
    """Load a full state dict into a model whose parameters may be
    sharded: each tensor is cut to this rank's shard and copied in."""
    from torch.distributed.tensor import DTensor

    own = model.state_dict(keep_vars=True)
    missing = set(own) ^ set(full)
    if missing:
        raise KeyError(f"checkpoint and model differ in {sorted(missing)}")
    for name, t in own.items():
        src = _like(full[name], t)
        if isinstance(t, DTensor):
            t.to_local().copy_(src.to_local())
        else:
            t.copy_(src)


def _reshard_optimizer(optimizer, full: dict) -> dict:
    """A full optimizer state dict with every per-parameter tensor placed
    as its parameter (index order is the parameter order of the groups,
    the same on any number of ranks)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, st in full["state"].items():
        p = params[int(i)]
        state[i] = {k: _like(v, p) if torch.is_tensor(v)
                    and v.shape == p.shape else v for k, v in st.items()}
    return {"state": state, "param_groups": full["param_groups"]}


# --------------------------------------------------------------------------
# HF-compatible model export
# --------------------------------------------------------------------------


def hf_config_of(enc_cfg, arch: str = "distilbert") -> dict:
    """An HF ``config.json`` synthesized from an ``EncoderConfig``."""
    if arch == "distilbert":
        return {
            "model_type": "distilbert",
            "vocab_size": enc_cfg.vocab_size,
            "dim": enc_cfg.hidden_size,
            "n_layers": enc_cfg.num_layers,
            "n_heads": enc_cfg.num_heads,
            "hidden_dim": enc_cfg.intermediate_size,
            "max_position_embeddings": enc_cfg.max_position_embeddings,
            "dropout": enc_cfg.hidden_dropout,
            "attention_dropout": enc_cfg.attention_dropout,
            "activation": "gelu",
        }
    return {
        "model_type": "bert",
        "vocab_size": enc_cfg.vocab_size,
        "hidden_size": enc_cfg.hidden_size,
        "num_hidden_layers": enc_cfg.num_layers,
        "num_attention_heads": enc_cfg.num_heads,
        "intermediate_size": enc_cfg.intermediate_size,
        "max_position_embeddings": enc_cfg.max_position_embeddings,
        "type_vocab_size": enc_cfg.type_vocab_size,
        "layer_norm_eps": enc_cfg.layer_norm_eps,
    }


def export_arch(enc_cfg, hf_config: dict | None = None) -> str:
    """The key layout of an export: the ``model_type`` of the init's
    ``config.json`` when one is given, else ``bert`` for an encoder with
    token-type embeddings and ``distilbert`` without."""
    if hf_config and "model_type" in hf_config:
        return hf_config["model_type"]
    return "bert" if enc_cfg.type_vocab_size > 0 else "distilbert"


def export_hf_checkpoint(out_dir: str, model, retriever_cfg: Any,
                         hf_config: dict | None = None,
                         arch: str | None = None) -> None:
    """Write ``model`` (a ``BiEncoder``) in the reference's HF layout:
    ``pytorch_model.bin`` + ``config.json`` (under ``query_model`` /
    ``passage_model`` when untied), and the ``TermWeightTrans`` / ``pooler``
    sidecars.  Families without an MLM head export encoder-only weights.
    ``arch`` None takes :func:`export_arch`'s, so a model trained from a
    BERT init writes ``bert.*`` keys, token types included, beside the
    init's ``config.json``."""
    from dhr_tpu_torch.models.hf_io import export_hf_mlm, save_sidecar_head

    os.makedirs(out_dir, exist_ok=True)
    untied = retriever_cfg.untie_encoder
    enc_q = model.encoder("query")
    enc_p = model.encoder("passage") if untied else None
    if arch is None:
        arch = export_arch(retriever_cfg.encoder, hf_config)
    if hf_config is None:
        hf_config = hf_config_of(retriever_cfg.encoder, arch)

    def write_encoder(enc, d):
        os.makedirs(d, exist_ok=True)
        sd = export_hf_mlm(enc.backbone, retriever_cfg.encoder, arch)
        torch.save({k: torch.from_numpy(np.asarray(v, np.float32))
                    for k, v in sd.items()},
                   os.path.join(d, "pytorch_model.bin"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=1)

    if untied:
        write_encoder(enc_q, os.path.join(out_dir, "query_model"))
        write_encoder(enc_p, os.path.join(out_dir, "passage_model"))
    else:
        write_encoder(enc_q, out_dir)
    hid = retriever_cfg.encoder.hidden_size
    if hasattr(enc_q, "term_weight"):
        save_sidecar_head(out_dir, "TermWeightTrans", enc_q.term_weight.linear,
                          enc_p.term_weight.linear if untied else None,
                          input_dim=hid, output_dim=1)
    if hasattr(enc_q, "pooler"):
        save_sidecar_head(out_dir, "pooler", enc_q.pooler.linear,
                          enc_p.pooler.linear if untied else None,
                          input_dim=hid,
                          output_dim=retriever_cfg.projection_dim)
