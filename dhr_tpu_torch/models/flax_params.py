"""Weights carried across from ``dhr_tpu``'s Flax param tree.

The port's modules carry the reference's Flax module names, so a Flax tree
(nested dicts of arrays, as ``BiEncoder.init(...)["params"]`` gives it, or
as numpy) maps onto a PyTorch state dict by name alone:

- ``layers_<i>`` is ``layers.<i>``;
- ``Dense`` kernels ``(in, out)`` are transposed to ``(out, in)``;
  ``DenseGeneral`` kernels ``(H, heads, head_dim)`` (query / key / value)
  and ``(heads, head_dim, H)`` (``out``) are flattened first, their biases
  ``(heads, head_dim)`` flattened;
- ``LayerNorm`` ``scale`` and ``Embed`` ``embedding`` are ``weight``.

A tied ``BiEncoder``'s tree holds ``encoder_q`` only, an untied one
``encoder_q`` and ``encoder_p``, as the port's modules do.

:func:`random_flax_params` draws a tree of that layout from an explicit
``torch.Generator``: the random weights every run uses while no checkpoint
is in the repository.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dhr_tpu_torch.models.retrievers import RetrieverConfig


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if value is None:
            continue
        if key.startswith("layers_") and key[7:].isdigit():
            key = f"layers.{key[7:]}"
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def flax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax param tree -> the port's state dict (f32 tensors)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, a in _flatten(tree):
        parent, _, leaf = path.rpartition(".")
        name = parent.rpartition(".")[2]
        if leaf == "kernel":
            if a.ndim == 3:  # DenseGeneral
                a = (a.reshape(-1, a.shape[-1]) if name == "out"
                     else a.reshape(a.shape[0], -1))
            a, leaf = a.T, "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf == "bias" and a.ndim == 2:  # DenseGeneral (heads, hd)
            a = a.reshape(-1)
        key = f"{parent}.{leaf}" if parent else leaf
        sd[key] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return sd


def load_flax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a Flax param tree into ``module`` (strict: every parameter of
    the module must be in the tree and nothing else); returns it."""
    module.load_state_dict(flax_to_state_dict(tree), strict=True)
    return module


def _dense(g, n_in, n_out):
    """Lecun-normal kernel ``(in, out)``, zero bias."""
    return {"kernel": (torch.randn(n_in, n_out, generator=g)
                       / n_in ** 0.5).numpy(),
            "bias": np.zeros(n_out, np.float32)}


def _ln(n):
    return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}


def _encoder_tree(enc, g):
    H, nh = enc.hidden_size, enc.num_heads
    hd = H // nh

    def embed(rows):
        return {"embedding": (torch.randn(rows, H, generator=g)
                              / H ** 0.5).numpy()}

    tree = {"embeddings": {"word": embed(enc.vocab_size),
                           "position": embed(enc.max_position_embeddings),
                           "layer_norm": _ln(H)}}
    if enc.type_vocab_size > 0:
        tree["embeddings"]["token_type"] = embed(enc.type_vocab_size)
    for i in range(enc.num_layers):
        attn = {}
        for name in ("query", "key", "value"):
            d = _dense(g, H, H)
            attn[name] = {"kernel": d["kernel"].reshape(H, nh, hd),
                          "bias": d["bias"].reshape(nh, hd)}
        d = _dense(g, H, H)
        attn["out"] = {"kernel": d["kernel"].reshape(nh, hd, H),
                       "bias": d["bias"]}
        tree[f"layers_{i}"] = {
            "attention": attn, "attn_layer_norm": _ln(H),
            "ffn_in": _dense(g, H, enc.intermediate_size),
            "ffn_out": _dense(g, enc.intermediate_size, H),
            "ffn_layer_norm": _ln(H)}
    return tree


def _retriever_tree(cfg: RetrieverConfig, g):
    enc = cfg.encoder
    H = enc.hidden_size
    encoder = _encoder_tree(enc, g)
    if cfg.needs_mlm:
        backbone = {"encoder": encoder,
                    "mlm": {"transform": _dense(g, H, H),
                            "layer_norm": _ln(H),
                            "bias": np.zeros(enc.vocab_size, np.float32)}}
    else:
        backbone = encoder
    tree = {"backbone": backbone}
    if cfg.model_type in ("dhr", "dlr", "agg"):
        tree["term_weight"] = {"linear": _dense(g, H, 1)}
    if cfg.model_type == "colbert" or cfg.add_pooler:
        tree["pooler"] = {"linear": _dense(g, H, cfg.projection_dim)}
    return tree


def random_flax_params(cfg: RetrieverConfig,
                       generator: torch.Generator) -> dict:
    """Random ``BiEncoder`` params in the Flax layout, as numpy f32: kernels
    normal with std 1/sqrt(fan_in), embeddings normal with std
    1/sqrt(hidden), LayerNorm scale 1, biases 0."""
    tree = {"encoder_q": _retriever_tree(cfg, generator)}
    if cfg.untie_encoder:
        tree["encoder_p"] = _retriever_tree(cfg, generator)
    return tree
