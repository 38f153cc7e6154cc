"""Seeded weights of a DHR bi-encoder on a DeepSeek-V2-family decoder,
drawn tensor by tensor on the device.

Each tensor is one normal draw from its own generator, seeded from
``(seed, the tensor's name)``, so any one tensor, or one layer's, can be
drawn again alone and comes out the same as in the whole draw: the
program gets the whole model in its compute dtype, and the f32 reference
draws one layer at a time (no f32 copy of the whole model ever exists).

The names are Hugging Face's for DeepSeek-V2 (``model.layers.{i}...``,
``lm_head.weight``), with each MoE layer's experts stacked
(``mlp.experts.gate_proj`` and ``up_proj`` ``(E, width, H)``,
``down_proj`` ``(E, H, width)``), and the DHR head's
(``term_weight.linear.*``, ``pooler.linear.*``).  Linear weights are
``(out, in)``.  Every matrix, embedding and bias is drawn from ``N(0,
initializer_range)``, the gate's included; RMSNorm scales are ``1 + N(0,
initializer_range)``, and the term-weight bias is shifted by the head's
``term_weight_bias``, as ``gen/weights.py`` does and for its reason.
RMSNorm scales stay f32 in the program's set (the program keeps them so).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def model_dims(cfg: dict) -> dict:
    """The widths a configuration file states, under one set of names."""
    m, h = cfg["model"], cfg["head"]
    rs = m["rope_scaling"]
    return {"layers": m["num_hidden_layers"], "hidden": m["hidden_size"],
            "heads": m["num_attention_heads"],
            "ffn": m["intermediate_size"],
            "expert_ffn": m["moe_intermediate_size"],
            "experts": m["n_routed_experts"],
            "shared": m["n_shared_experts"],
            "top_k": m["num_experts_per_tok"],
            "dense_layers": m["first_k_dense_replace"],
            "moe_freq": m["moe_layer_freq"],
            "norm_topk": m["norm_topk_prob"],
            "routed_scale": float(m["routed_scaling_factor"]),
            "kv_rank": m["kv_lora_rank"], "d_nope": m["qk_nope_head_dim"],
            "d_rope": m["qk_rope_head_dim"], "d_v": m["v_head_dim"],
            "theta": float(m["rope_theta"]), "rope_factor": rs["factor"],
            "rope_orig": rs["original_max_position_embeddings"],
            "beta_fast": rs["beta_fast"], "beta_slow": rs["beta_slow"],
            "mscale": rs["mscale"], "mscale_all_dim": rs["mscale_all_dim"],
            "vocab": m["vocab_size"], "eps": m["rms_norm_eps"],
            "init": m["initializer_range"], "proj": h["projection_dim"],
            "tw_bias": h.get("term_weight_bias", 0.0)}


def is_moe(d: dict, layer: int) -> bool:
    return (d["experts"] > 0 and layer >= d["dense_layers"]
            and layer % d["moe_freq"] == 0)


def layer_shapes(d: dict, i: int) -> list[tuple[str, tuple[int, ...]]]:
    """Layer ``i``'s tensors: names and shapes."""
    H, n = d["hidden"], d["heads"]
    p = f"model.layers.{i}."
    a = p + "self_attn."
    out = [(p + "input_layernorm.weight", (H,)),
           (a + "q_proj.weight", (n * (d["d_nope"] + d["d_rope"]), H)),
           (a + "kv_a_proj_with_mqa.weight", (d["kv_rank"] + d["d_rope"], H)),
           (a + "kv_a_layernorm.weight", (d["kv_rank"],)),
           (a + "kv_b_proj.weight", (n * (d["d_nope"] + d["d_v"]),
                                     d["kv_rank"])),
           (a + "o_proj.weight", (H, n * d["d_v"])),
           (p + "post_attention_layernorm.weight", (H,))]
    m = p + "mlp."
    if is_moe(d, i):
        E, F = d["experts"], d["expert_ffn"]
        out += [(m + "gate.weight", (E, H)),
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


def is_norm(name: str) -> bool:
    return name.endswith("layernorm.weight") or name == "model.norm.weight"


def draw(d: dict, seed: int, name: str, shape, device) -> torch.Tensor:
    """Tensor ``name`` in f32: its own generator, seeded from ``(seed,
    name)``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed) % (1 << 64), 0xDEC0, zlib.crc32(name.encode())])
        .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    t.mul_(d["init"])
    if is_norm(name):
        t.add_(1.0)
    elif name == "term_weight.linear.bias":
        t.add_(d["tw_bias"])
    return t


def make_weights(cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every tensor of ``cfg``'s model in ``dtype`` (RMSNorm scales in f32),
    each drawn in f32 and rounded."""
    d = model_dims(cfg)
    out = {}
    for name, shape in shapes(d):
        t = draw(d, seed, name, shape, device)
        out[name] = t if is_norm(name) else t.to(dtype)
        del t
    return out


def layer_weights(d: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s tensors in f32, drawn alone."""
    return {n: draw(d, seed, n, s, device) for n, s in layer_shapes(d, layer)}


def outer_weights(d: dict, seed: int, device) -> dict:
    """The tensors outside the layers in f32, drawn alone."""
    return {n: draw(d, seed, n, s, device) for n, s in shapes(d)
            if not n.startswith("model.layers.")}
