"""Seeded weights of a DHR bi-encoder on a Nemotron-H decoder (blocks of
one mixer each: Mamba-2, attention, or a mixture of relu^2 experts), drawn
tensor by tensor on the device.

Each tensor is one draw from its own generator, seeded from ``(seed, the
tensor's name)``, so any one tensor, or one block's, can be drawn again
alone and comes out the same as in the whole draw: the program gets the
whole model in its compute dtype, and the f32 reference draws one block
at a time (no f32 copy of the whole model ever exists).

The names are the port's, which keep Hugging Face's
``modeling_nemotron_h.py`` names inside the blocks
(``model.layers.{i}.norm.weight``, ``model.layers.{i}.mixer.*``: Mamba-2's
``in_proj``, ``conv1d`` (weight ``(C, 1, K)`` and bias), ``dt_bias``,
``A_log``, ``D``, ``norm``, ``out_proj``; attention's ``q_proj`` ...
``o_proj``; the router's ``gate.weight`` ``(E, H)`` and
``gate.e_score_correction_bias`` ``(E,)``, the experts stacked as
``experts.up_proj`` ``(E, width, H)`` and ``experts.down_proj`` ``(E, H,
width)``, ``shared_experts.up_proj`` / ``down_proj``) and the port's
outside them (``model.embed_tokens``, ``model.norm``, ``lm_head``).
Draws (the configuration's ``assumed``): matrices and embeddings ``N(0,
initializer_range)``; RMSNorm and gated-norm scales ``1 + N(0,
initializer_range)``; Mamba-2's published inits, ``A_log = log(1..h)``,
``D = 1``, ``dt_bias = softplus^-1(dt)`` with ``dt = exp U(log 1e-3, log
0.1)`` floored at 1e-4; the convolution's weight and bias ``U(-0.5,
0.5)``; the correction bias ``N(0, 0.01)``; the term-weight bias shifted
by the head's ``term_weight_bias``.  Norm scales, ``A_log``, ``dt_bias``,
``D`` and the correction bias stay f32 in the program's set (the program
keeps them so).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

F32 = ("norm.weight", "A_log", "dt_bias", ".D", "e_score_correction_bias")


def model_dims(cfg: dict) -> dict:
    """The widths a configuration file states, under one set of names."""
    m, h = cfg["model"], cfg["head"]
    return {"layers": m["num_hidden_layers"],
            "pattern": m["hybrid_override_pattern"],
            "hidden": m["hidden_size"], "heads": m["num_attention_heads"],
            "kv_heads": m["num_key_value_heads"], "head_dim": m["head_dim"],
            "mamba_heads": m["mamba_num_heads"],
            "mamba_dim": m["mamba_head_dim"], "state": m["ssm_state_size"],
            "groups": m["n_groups"], "conv": m["conv_kernel"],
            "chunk": m["chunk_size"],
            "dt_limit": tuple(float(v) for v in m["time_step_limit"]),
            "dt_floor": m["time_step_floor"], "dt_min": m["time_step_min"],
            "dt_max": m["time_step_max"],
            "expert_ffn": m["moe_intermediate_size"],
            "shared_ffn": m["moe_shared_expert_intermediate_size"],
            "experts": m["n_routed_experts"], "shared": m["n_shared_experts"],
            "top_k": m["num_experts_per_tok"],
            "renormalize": m["norm_topk_prob"],
            "routed_scale": float(m["routed_scaling_factor"]),
            "vocab": m["vocab_size"], "eps": m["layer_norm_epsilon"],
            "init": m["initializer_range"], "proj": h["projection_dim"],
            "tw_bias": h.get("term_weight_bias", 0.0)}


def kind(d: dict, layer: int) -> str:
    """Block ``layer``'s mixer: ``M``, ``*`` or ``E``."""
    return d["pattern"][layer]


def layer_shapes(d: dict, i: int) -> list[tuple[str, tuple[int, ...]]]:
    """Block ``i``'s tensors: names and shapes."""
    H = d["hidden"]
    p = f"model.layers.{i}."
    a = p + "mixer."
    out = [(p + "norm.weight", (H,))]
    if kind(d, i) == "M":
        h, g, N = d["mamba_heads"], d["groups"], d["state"]
        D = h * d["mamba_dim"]
        conv = D + 2 * g * N
        out += [(a + "in_proj.weight", (D + conv + h, H)),
                (a + "conv1d.weight", (conv, 1, d["conv"])),
                (a + "conv1d.bias", (conv,)), (a + "dt_bias", (h,)),
                (a + "A_log", (h,)), (a + "D", (h,)),
                (a + "norm.weight", (D,)), (a + "out_proj.weight", (H, D))]
    elif kind(d, i) == "*":
        n, kv, hd = d["heads"], d["kv_heads"], d["head_dim"]
        out += [(a + "q_proj.weight", (n * hd, H)),
                (a + "k_proj.weight", (kv * hd, H)),
                (a + "v_proj.weight", (kv * hd, H)),
                (a + "o_proj.weight", (H, n * hd))]
    else:
        E, F, S = d["experts"], d["expert_ffn"], d["shared_ffn"]
        out += [(a + "gate.weight", (E, H)),
                (a + "gate.e_score_correction_bias", (E,)),
                (a + "experts.up_proj", (E, F, H)),
                (a + "experts.down_proj", (E, H, F)),
                (a + "shared_experts.up_proj.weight", (S, H)),
                (a + "shared_experts.down_proj.weight", (H, S))]
    return out


def shapes(d: dict) -> list[tuple[str, tuple[int, ...]]]:
    """Every tensor's name and shape."""
    H = d["hidden"]
    out = [("model.embed_tokens.weight", (d["vocab"], H))]
    for i in range(d["layers"]):
        out += layer_shapes(d, i)
    out += [("model.norm.weight", (H,)), ("lm_head.weight", (d["vocab"], H)),
            ("term_weight.linear.weight", (1, H)),
            ("term_weight.linear.bias", (1,)),
            ("pooler.linear.weight", (d["proj"], H)),
            ("pooler.linear.bias", (d["proj"],))]
    return out


def draw(d: dict, seed: int, name: str, shape, device) -> torch.Tensor:
    """Tensor ``name`` in f32: its own generator, seeded from ``(seed,
    name)``, and the draw its name calls for."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed) % (1 << 64), 0x4E3, zlib.crc32(name.encode())])
        .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))

    def uniform(lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    if name.endswith("A_log"):
        return torch.arange(1, shape[0] + 1, dtype=torch.float32,
                            device=device).log_()
    if name.endswith(".D"):
        return torch.ones(shape, device=device)
    if name.endswith("dt_bias"):
        dt = uniform(math.log(d["dt_min"]), math.log(d["dt_max"])).exp_() \
            .clamp_(min=d["dt_floor"])
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith(("conv1d.weight", "conv1d.bias")):
        return uniform(-0.5, 0.5)
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    if name.endswith("e_score_correction_bias"):
        return t.mul_(0.01)
    t.mul_(d["init"])
    if name.endswith("norm.weight"):
        t.add_(1.0)
    elif name == "term_weight.linear.bias":
        t.add_(d["tw_bias"])
    return t


def make_weights(cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every tensor of ``cfg``'s model in ``dtype`` (those of :data:`F32`
    in f32), each drawn in f32 and rounded."""
    d = model_dims(cfg)
    out = {}
    for name, shape in shapes(d):
        t = draw(d, seed, name, shape, device)
        out[name] = t if name.endswith(F32) else t.to(dtype)
        del t
    return out


def layer_weights(d: dict, seed: int, layer: int, device) -> dict:
    """Block ``layer``'s tensors in f32, drawn alone."""
    return {n: draw(d, seed, n, s, device) for n, s in layer_shapes(d, layer)}


def outer_weights(d: dict, seed: int, device) -> dict:
    """The tensors outside the blocks in f32, drawn alone."""
    return {n: draw(d, seed, n, s, device) for n, s in shapes(d)
            if not n.startswith("model.layers.")}
