"""Checkpoints of the train state, and the HF export.

Port of ``dhr_tpu/train/checkpoint.py``.  The train state (step, parameters,
optimizer state) is saved with ``torch.save`` under ``ckpt_dir/step_<n>``
(eight digits, as the reference names its directories) and restored from
the latest one.  Orbax checkpoints of the reference do not load here: the
format the two packages exchange is the HF export
(:func:`export_hf_checkpoint`, the reference's layout: ``save_pretrained``
files, ``query_model`` / ``passage_model`` when untied, and the pooler /
TermWeightTrans sidecars).

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

from dhr_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def _state_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _to_host(tree):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def snapshot(state: TrainState) -> dict:
    """The state's step, parameters and optimizer state, copied to the
    host."""
    return {"step": state.step,
            "model": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict())}


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
    """Save the state under ``ckpt_dir/step_XXXXXXXX``; returns the path."""
    return write_snapshot(ckpt_dir, snapshot(state))


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
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = int(snap["step"])
    return state


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


def export_hf_checkpoint(out_dir: str, model, retriever_cfg: Any,
                         hf_config: dict | None = None,
                         arch: str = "distilbert") -> None:
    """Write ``model`` (a ``BiEncoder``) in the reference's HF layout:
    ``pytorch_model.bin`` + ``config.json`` (under ``query_model`` /
    ``passage_model`` when untied), and the ``TermWeightTrans`` / ``pooler``
    sidecars.  Families without an MLM head export encoder-only weights."""
    from dhr_tpu_torch.models.hf_io import export_hf_mlm, save_sidecar_head

    os.makedirs(out_dir, exist_ok=True)
    untied = retriever_cfg.untie_encoder
    enc_q = model.encoder("query")
    enc_p = model.encoder("passage") if untied else None
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
