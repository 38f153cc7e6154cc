"""Seeded weights of a DHR bi-encoder on a Kimi Linear decoder holding a
share of each MoE layer's experts, drawn tensor by tensor on the device.

Each tensor is one draw from its own generator, seeded from ``(seed, the
tensor's name)``, so any one tensor, or one layer's, can be drawn again
alone and comes out the same as in the whole draw: the program gets the
whole model in its compute dtype, and the f32 reference draws one layer
at a time (no f32 copy of the whole model ever exists).

The names are the port's, which keep Hugging Face's ``modeling_kimi.py``
names for attention (``model.layers.{i}.self_attn.*``: KDA's ``q_proj``
... ``o_proj``, ``A_log`` ``(1, 1, h, 1)``, ``dt_bias``, the convolutions
``(D, 1, size)``; MLA's as DeepSeek-V2's) and stack the held experts of
each MoE layer (``mlp.experts.gate_proj`` and ``up_proj`` ``(E_held,
width, H)``, ``down_proj`` ``(E_held, H, width)``) beside the router's
``mlp.gate.weight`` ``(E, H)`` and ``mlp.gate.e_score_correction_bias``
``(E,)`` over all ``E`` experts.  Draws (the configuration's
``assumed``): matrices, embeddings and biases ``N(0,
initializer_range)``; RMSNorm scales ``1 + N(0, initializer_range)``;
``A_log = log U(1, 16)``; ``dt_bias = softplus^-1(U(1e-3, 1e-1))``; the
convolutions ``U(-0.5, 0.5)``; the correction bias ``N(0, 0.01)``; the
term-weight bias shifted by the head's ``term_weight_bias``.  RMSNorm
scales, ``A_log``, ``dt_bias`` and the correction bias stay f32 in the
program's set (the program keeps them so).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

F32 = ("norm.weight", "A_log", "dt_bias", "e_score_correction_bias")


def model_dims(cfg: dict) -> dict:
    """The widths a configuration file states, under one set of names;
    ``experts`` is the router's width, ``held`` the experts this chip
    holds."""
    m, h = cfg["model"], cfg["head"]
    lac = m["linear_attn_config"]
    held = tuple(m["experts_held"])
    if held[1] - held[0] != m["num_experts"]:
        raise ValueError(f"experts_held {held} is not num_experts "
                         f"{m['num_experts']} experts")
    return {"layers": m["num_hidden_layers"], "hidden": m["hidden_size"],
            "heads": m["num_attention_heads"],
            "ffn": m["intermediate_size"],
            "expert_ffn": m["moe_intermediate_size"],
            "experts": cfg["expert_parallel"]["published_num_experts"],
            "held": held, "shared": m["num_shared_experts"],
            "top_k": m["num_experts_per_token"],
            "dense_layers": m["first_k_dense_replace"],
            "moe_freq": m["moe_layer_freq"],
            "renormalize": m["moe_renormalize"],
            "routed_scale": float(m["routed_scaling_factor"]),
            "kv_rank": m["kv_lora_rank"], "d_nope": m["qk_nope_head_dim"],
            "d_rope": m["qk_rope_head_dim"], "d_v": m["v_head_dim"],
            "kda_layers": tuple(lac["kda_layers"]),
            "kda_heads": lac["num_heads"], "kda_dim": lac["head_dim"],
            "conv": lac["short_conv_kernel_size"],
            "vocab": m["vocab_size"], "eps": m["rms_norm_eps"],
            "init": m["initializer_range"], "proj": h["projection_dim"],
            "tw_bias": h.get("term_weight_bias", 0.0)}


def is_moe(d: dict, layer: int) -> bool:
    return (d["experts"] > 0 and layer >= d["dense_layers"]
            and layer % d["moe_freq"] == 0)


def is_kda(d: dict, layer: int) -> bool:
    return layer + 1 in d["kda_layers"]


def layer_shapes(d: dict, i: int) -> list[tuple[str, tuple[int, ...]]]:
    """Layer ``i``'s tensors: names and shapes."""
    H, n = d["hidden"], d["heads"]
    h, k = d["kda_heads"], d["kda_dim"]
    D = h * k
    p = f"model.layers.{i}."
    a = p + "self_attn."
    out = [(p + "input_layernorm.weight", (H,)),
           (p + "post_attention_layernorm.weight", (H,))]
    if is_kda(d, i):
        out += [(f"{a}{c}_proj.weight", (D, H)) for c in "qkv"]
        out += [(f"{a}{c}_conv1d.weight", (D, 1, d["conv"])) for c in "qkv"]
        out += [(a + "A_log", (1, 1, h, 1)), (a + "f_a_proj.weight", (k, H)),
                (a + "f_b_proj.weight", (D, k)), (a + "dt_bias", (D,)),
                (a + "b_proj.weight", (h, H)), (a + "g_a_proj.weight", (k, H)),
                (a + "g_b_proj.weight", (D, k)), (a + "g_b_proj.bias", (D,)),
                (a + "o_norm.weight", (k,)), (a + "o_proj.weight", (H, D))]
    else:
        out += [(a + "q_proj.weight", (n * (d["d_nope"] + d["d_rope"]), H)),
                (a + "kv_a_proj_with_mqa.weight",
                 (d["kv_rank"] + d["d_rope"], H)),
                (a + "kv_a_layernorm.weight", (d["kv_rank"],)),
                (a + "kv_b_proj.weight", (n * (d["d_nope"] + d["d_v"]),
                                          d["kv_rank"])),
                (a + "o_proj.weight", (H, n * d["d_v"]))]
    m = p + "mlp."
    if is_moe(d, i):
        E, F = d["held"][1] - d["held"][0], d["expert_ffn"]
        out += [(m + "gate.weight", (d["experts"], H)),
                (m + "gate.e_score_correction_bias", (d["experts"],)),
                (m + "experts.gate_proj", (E, F, H)),
                (m + "experts.up_proj", (E, F, H)),
                (m + "experts.down_proj", (E, H, F))]
        if d["shared"]:
            S = F * d["shared"]
            out += [(m + "shared_experts.gate_proj.weight", (S, H)),
                    (m + "shared_experts.up_proj.weight", (S, H)),
                    (m + "shared_experts.down_proj.weight", (H, S))]
    else:
        F = d["ffn"]
        out += [(m + "gate_proj.weight", (F, H)),
                (m + "up_proj.weight", (F, H)),
                (m + "down_proj.weight", (H, F))]
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
        [int(seed) % (1 << 64), 0x4B1, zlib.crc32(name.encode())])
        .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))

    def uniform(lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    if name.endswith("A_log"):
        return uniform(1.0, 16.0).log_()
    if name.endswith("dt_bias"):
        dt = uniform(1e-3, 1e-1)
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith("conv1d.weight"):
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
    """Layer ``layer``'s tensors in f32, drawn alone."""
    return {n: draw(d, seed, n, s, device) for n, s in layer_shapes(d, layer)}


def outer_weights(d: dict, seed: int, device) -> dict:
    """The tensors outside the layers in f32, drawn alone."""
    return {n: draw(d, seed, n, s, device) for n, s in shapes(d)
            if not n.startswith("model.layers.")}
